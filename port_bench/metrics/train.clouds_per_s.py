"""Train steps' clouds completed in the traced run's window over the time to
the last completed in it (the loop's rate, ``rate_metric`` of the mix), on
the host's clock."""

UNIT = "clouds/s"


def read(reading):
    return reading["e2e"].get("clouds_per_s")
