"""K1's share of its roofline over the traced steps, percent."""

from port_bench.metrics import _read

UNIT = "%"


def read(reading):
    return _read.k1_roofline_pct(reading)
