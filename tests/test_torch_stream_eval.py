"""The port's dataset-driven `stream_eval` (`train/evaluate.py`) against the
JAX package's, on the CPU, over a synthetic two-sequence SemanticKITTI tree
with the same weights in both (`weights.from_flax_variables`), with the
memory reset at the sequence boundary and carried across it.

Tolerances: the metric dict within 1e-3; the `.label` and bf-label files
equal except at points where JAX's top two TTA-mean scores are closer than
1e-4 (a near-tie that float32 noise may flip; the count of such points is
asserted, and is 0 on this tree); the `record_0.txt` line byte for byte.
"""
import dataclasses
import logging
import os

import numpy as np
import pytest

import streammos_tpu.train.trainer as jax_trainer
from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.data.dataset import EvalDataset as JaxEvalDataset
from streammos_tpu.train import evaluate as jax_evaluate

from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.data.dataset import EvalDataset
from streammos_tpu_torch.train import evaluate
from tests.synthetic_kitti import make_sequence
from tests.test_torch_common import jax_tiny_model, port_model, use_few_threads

POINTS = 4096
NEAR_TIE = 1e-4
LOGGER = logging.getLogger("test_torch_stream_eval")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream_eval") / "sequences"
    make_sequence(str(root), "00", n_frames=4, n_points=2600, seed=3)
    make_sequence(str(root), "08", n_frames=4, n_points=2600, seed=4)
    return str(root)


def _cfgs(seqs):
    return tuple(dataclasses.replace(
        c, val=dataclasses.replace(c.val, seq_dir=seqs,
                                   frame_point_num=POINTS))
        for c in (jax_get_config("StreamMOS_tiny"), get_config("StreamMOS_tiny")))


def _run_jax(cfg, model, variables, out, carry, monkeypatch):
    """JAX's stream_eval, with each frame's scores and bf scores kept."""
    seen = []
    make = jax_trainer.make_eval_step

    def capturing(model, cfg, with_refine=False):
        step = make(model, cfg, with_refine=with_refine)

        def wrapped(*args):
            scores, bf_scores, memory = step(*args)
            seen.append((np.asarray(scores[0]), np.asarray(bf_scores[0])))
            return scores, bf_scores, memory

        return wrapped

    monkeypatch.setattr(jax_trainer, "make_eval_step", capturing)
    ds = JaxEvalDataset(cfg.val, seq_ids=[0, 8])
    result = jax_evaluate.stream_eval(
        cfg, cfg.val, model, variables, with_refine=True, with_labels=True,
        logger=LOGGER, dataset=ds, save_root=os.path.join(out, "labels"),
        bf_root=os.path.join(out, "bf"), carry_across_sequences=carry)
    return result, ds, seen


def _near_ties(scores: np.ndarray) -> np.ndarray:
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] < NEAR_TIE


@pytest.mark.parametrize("carry", [False, True])
def test_stream_eval_matches_jax(seqs, tmp_path, monkeypatch, carry):
    use_few_threads()
    jcfg, tcfg = _cfgs(seqs)
    jmodel, variables = jax_tiny_model(POINTS, with_refine=True)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jres, jds, seen = _run_jax(jcfg, jmodel, variables, jout, carry,
                               monkeypatch)

    model = port_model(variables, with_refine=True)
    tds = EvalDataset(tcfg.val, seq_ids=[0, 8])
    tres = evaluate.stream_eval(
        tcfg, tcfg.val, model, with_refine=True, with_labels=True,
        logger=LOGGER, dataset=tds, save_root=os.path.join(tout, "labels"),
        bf_root=os.path.join(tout, "bf"), carry_across_sequences=carry)

    assert tres.keys() == jres.keys()
    for k in jres:
        assert abs(tres[k] - jres[k]) <= 1e-3, (k, tres[k], jres[k])
    assert len(seen) == len(tds) == 8

    near_ties = 0
    for i in range(len(tds)):
        sample = jds[i]
        mask, n_valid = sample["valid_mask"], POINTS - sample["pad_length"]
        for sub, scores, lut in (("labels", seen[i][0], {0: 0, 1: 9, 2: 251}),
                                 ("bf", seen[i][1], None)):
            rel = os.path.join(sub, sample["seq_id"], "predictions",
                               sample["file_id"] + ".label")
            a = np.fromfile(os.path.join(jout, rel), dtype=np.uint32)
            b = np.fromfile(os.path.join(tout, rel), dtype=np.uint32)
            assert a.shape == b.shape == mask.shape
            if lut is not None:
                assert set(np.unique(b)) <= set(lut.values())
            tie = np.zeros(mask.shape, bool)
            tie[mask] = _near_ties(scores[:n_valid])
            assert ((a != b) & ~tie).sum() == 0, (rel, int((a != b).sum()))
            near_ties += int(tie.sum())
    assert near_ties == 0

    # the record line, byte for byte, from the same result
    for mod, out in ((jax_evaluate, jout), (evaluate, tout)):
        line = mod.record_metrics(jres, 3, out, LOGGER)
        assert line.startswith("Epoch 3; static_iou: ")
    with open(os.path.join(jout, "record_0.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(tout, "record_0.txt"), "rb") as f:
        assert f.read() == want


def test_stream_eval_without_labels_writes_only_files(seqs, tmp_path):
    """The test split: no metric, the label files still written."""
    use_few_threads()
    _, tcfg = _cfgs(seqs)
    _, variables = jax_tiny_model(POINTS, with_refine=True)
    model = port_model(variables, with_refine=True)
    ds = EvalDataset(tcfg.val, seq_ids=[8], with_labels=False)
    out = tmp_path / "labels"
    assert evaluate.stream_eval(tcfg, tcfg.val, model, with_refine=True,
                                with_labels=False, logger=LOGGER, dataset=ds,
                                save_root=str(out)) is None
    assert sorted(os.listdir(out / "08" / "predictions")) == \
        [f"{i:06d}.label" for i in range(4)]
