"""A whole run but the look for a card, at tiny widths in bfloat16 (as the
cells compute) with each cell's own limits: the measured package comes out
correct; the control (the plain reference in its place, in float8) and
every planted fault come out not correct."""
from __future__ import annotations

import pytest
import torch

from tinycells import tiny_cell
from portbench import check, faults, sut
from portbench.reference import streammos as ref
from portbench.run import run_cell

CPU = torch.device("cpu")
LOOPS = ["stream", "batched"]


def _correct(loop, system, seed=5):
    cell = tiny_cell(loop)
    run, numbers, failed = run_cell(cell, seed, 0.3, False, CPU, system)
    assert run.rec.steps >= 1
    return check.verdict(numbers, cell.limits), numbers, failed


@pytest.mark.parametrize("loop", LOOPS)
def test_program_is_correct(loop):
    ok, numbers, failed = _correct(loop, sut.Port())
    assert ok, numbers
    assert failed == 0


@pytest.mark.parametrize("loop", LOOPS)
def test_control_in_float8_is_not_correct(loop):
    ok, numbers, failed = _correct(loop, sut.Reference(ref.FP8()))
    assert not ok, numbers
    assert failed > 0


@pytest.mark.parametrize("loop, fault", [
    (loop, fault) for loop in LOOPS for fault in sorted(faults.FAULTS)])
def test_planted_fault_is_not_correct(loop, fault):
    with faults.FAULTS[fault]():
        ok, numbers, failed = _correct(loop, sut.Port())
    assert not ok, numbers
