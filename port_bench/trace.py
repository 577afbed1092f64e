"""A ``torch.profiler`` capture of a few requests or steps, and its reading.

Each request or step of the capture runs inside ``record_function(ITEM)``.
The exported Chrome trace gives the device's operations (kernels, copies,
fills) on the same clock as those spans.  From it: the union of the
device's busy intervals, inside the spans and over the whole capture, the
device time of each kernel name and the host's op at the start of each
idle gap.  The arithmetic of ``misc/parse_trace.py`` in the port (events of
``ph == "X"`` in the device categories, ``dur`` in microseconds), with
overlapping streams counted once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

ITEM = "port_bench.item"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, spans) -> float:
    """Microseconds of ``merged`` (disjoint, sorted) inside ``spans``
    (disjoint, sorted)."""
    total, j = 0.0, 0
    for a, b in spans:
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        i = j
        while i < len(merged) and merged[i][0] < b:
            total += min(b, merged[i][1]) - max(a, merged[i][0])
            i += 1
    return total


def capture(run_items, device) -> dict:
    """Runs ``run_items(mark)``, which calls ``mark()`` as a context manager
    around each request or step, under the profiler; returns the read trace
    (:func:`read`)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize(device)
            run_items(lambda: torch.profiler.record_function(ITEM))
            torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return read(data)


def read(data) -> dict:
    """``{"items": [(start_us, end_us)], "busy_us", "busy_in_items_us",
    "window_us", "items_us", "kernel_us": {name: us}, "gaps": {host op:
    us}}`` of one exported trace."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    items, device, host_ops = [], [], []
    kernel_us = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat"), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and ev.get("name") == ITEM:
            items.append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            kernel_us[ev["name"]] += dur
        elif cat == "cpu_op":
            host_ops.append((ts, ts + dur, ev["name"]))
    items.sort()
    spans = _union(items)
    merged = _union(device)
    window = (spans[0][0], spans[-1][1]) if spans else (0.0, 0.0)
    in_window = [[max(a, window[0]), min(b, window[1])] for a, b in merged if b > window[0] and a < window[1]]
    host_ops.sort()
    starts = [h[0] for h in host_ops]
    gaps = collections.Counter()
    for a, b in spans:
        inside = [iv for iv in merged if iv[1] > a and iv[0] < b]
        edges = [a] + [x for iv in inside for x in iv] + [b]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps[_host_op_at(host_ops, starts, g0)] += g1 - g0
    return dict(
        items=items, busy_us=sum(b - a for a, b in in_window),
        busy_in_items_us=_overlap(merged, spans), window_us=window[1] - window[0],
        items_us=sum(b - a for a, b in spans), kernel_us=dict(kernel_us), gaps=dict(gaps),
    )  # fmt: skip


def _host_op_at(host_ops, starts, t: float, depth: int = 64) -> str:
    """The innermost host op running at ``t`` (the latest to start of those
    that cover it), else ``"(host idle or python)"``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - depth), -1):
        if host_ops[j][1] >= t:
            return host_ops[j][2]
    return "(host idle or python)"


def breakdown(tr: dict) -> dict:
    """The ledger's ``breakdown``: the device operations that took most
    time and the idle gaps' seconds by the host op at their start."""
    ops = sorted(tr["kernel_us"].items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(tr["gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        device_ops=[[name[:160], us / 1e6] for name, us in ops],
        idle_gaps=[[name[:160], us / 1e6] for name, us in gaps],
    )


def k1_device_us(tr: dict, names) -> float:
    return sum(us for name, us in tr["kernel_us"].items() if any(n in name for n in names))
