"""Model FLOPs (a step: 3x the forward) of the traced steps over their wall time at 989 TFLOP/s, percent."""

from port_bench.metrics import _read

UNIT = "%"


def read(reading):
    return _read.step_mfu_pct(reading)
