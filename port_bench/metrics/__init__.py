"""One reader a per-layer metric: ``metrics/<name>.py`` holds ``UNIT`` and
``read(reading) -> float | None`` (None where the run gave it nothing to
read: the harness then leaves the metric out)."""
