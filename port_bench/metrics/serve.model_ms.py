"""Median ms of the LNN forward a scan, CUDA events."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "serve.model")
