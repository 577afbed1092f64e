"""Median ms of ``data_parallel.forward_loss`` (build, forward, loss) a step, CUDA events."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "train.forward_loss")
