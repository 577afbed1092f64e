"""Model FLOPs of the traced rooms over their wall time at 989 TFLOP/s, percent."""

from port_bench.metrics import _read

UNIT = "%"


def read(reading):
    return _read.step_mfu_pct(reading)
