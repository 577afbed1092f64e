"""Share of the traced steps' wall time with no device operation, percent."""

from port_bench.metrics import _read

UNIT = "%"


def read(reading):
    return _read.idle_pct(reading)
