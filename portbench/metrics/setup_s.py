"""Seconds from process start to the first timed step: imports, CUDA
start-up, weights, the traffic bank, kernel builds on a first run, the
warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
