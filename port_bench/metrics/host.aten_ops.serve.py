"""Aten ops a served scan dispatches (one scan, after the window)."""

from port_bench.metrics import _read

UNIT = "ops"


def read(reading):
    return _read.aten_ops(reading)
