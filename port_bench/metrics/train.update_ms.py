"""Median ms of ``data_parallel.apply_update`` (AdamW-amsgrad) a step, CUDA events."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "train.update")
