"""Median ms of ``data_parallel.gradients`` (the backward) a step, CUDA events."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "train.backward")
