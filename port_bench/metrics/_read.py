"""What the per-layer readers share.  ``reading["e2e"]`` holds the run's
end-to-end numbers (the loop's rate among them); ``reading["layer"]`` is a
loop's traced record: ``stages`` ({stage: [ms a request or step]}), ``aten_ops``
(one request or step), ``trace`` (``trace.read``'s dict, None off the
card), ``k1_least_s``, ``k1_calls`` and ``flops`` of the traced segment."""

from __future__ import annotations

from port_bench import trace, yardstick


def stage_median(reading, stage):
    times = reading["layer"].get("stages", {}).get(stage)
    return yardstick.median(times) if times else None


def aten_ops(reading):
    return reading["layer"].get("aten_ops")


def k1_roofline_pct(reading):
    """Share of K1's least time (its bytes at the HBM peak) in its device
    time over the traced segment."""
    layer = reading["layer"]
    tr = layer.get("trace")
    if tr is None or not layer.get("k1_calls"):
        return None
    us = trace.k1_device_us(tr, yardstick.K1_KERNEL_NAMES)
    return 100.0 * layer["k1_least_s"] / (us / 1e6) if us > 0 else None


def step_mfu_pct(reading):
    """Model FLOPs of the traced requests or steps over their wall time at
    the bf16 dense peak."""
    layer = reading["layer"]
    tr = layer.get("trace")
    if tr is None or tr["items_us"] <= 0:
        return None
    return 100.0 * layer["flops"] / (tr["items_us"] / 1e6 * yardstick.PEAK_BF16_FLOPS)


def idle_pct(reading):
    """Share of the traced requests' or steps' wall time in which no device
    operation ran."""
    tr = reading["layer"].get("trace")
    if tr is None or tr["items_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_in_items_us"] / tr["items_us"])
