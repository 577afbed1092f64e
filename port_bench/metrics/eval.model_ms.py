"""Median ms of the LNN forward a room at the 5M tables, CUDA events."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "eval.model")
