"""Aten ops a labelled room dispatches (one, after the window)."""

from port_bench.metrics import _read

UNIT = "ops"


def read(reading):
    return _read.aten_ops(reading)
