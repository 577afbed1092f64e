"""Median ms of ``Predictor._batch`` (pad, mask, copy) a scan, host clock to a synchronise."""

from port_bench.metrics import _read

UNIT = "ms"


def read(reading):
    return _read.stage_median(reading, "serve.batch")
