"""The port's own spans in an exported trace of the traced segment.

While a profiler records, the port names its layers with ``record_function``
spans (``lnt.*``, ``lattice_net_tpu_torch/tracing.py``): ``user_annotation``
events on the clock of the device's kernels, copies and fills.
:func:`span_items` gives, for each traced request or step (``trace.ITEM``),
each span's occurrences, wall time, the part of it in which the device ran
nothing, and the device time of the operations launched inside it.  The
arithmetic of ``trace.read``: events of ``ph == "X"``, ``dur`` in
microseconds, the device's busy time the union of its intervals.

A device operation is joined to its launch (a ``cuda_runtime`` or
``cuda_driver`` event) by ``args.correlation`` and belongs to the innermost
``lnt.*`` span open at the launch's host time on the launching thread, or,
where that thread has none open (autograd's backward thread), on the thread
that ran the items.  A program without these spans gives an empty dict an
item.
"""

from __future__ import annotations

import bisect
import statistics

from port_bench import trace

PREFIX = "lnt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Thread:
    """One host thread's spans, properly nested, sorted by start, each with
    the index of the span that encloses it (-1: none)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (a, _, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t):
        """The innermost span open at ``t`` (start <= t < end), or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.spans[j][1] <= t:
            j = self.parent[j]
        return self.spans[j] if j >= 0 else None


def span_items(data) -> list:
    """``[{span name: {"n", "us", "idle_us", "device_us"}}]``, one dict a
    traced item in start order, of one exported trace.  A span occurrence
    belongs to the item in which it starts; ``idle_us`` is the part of its
    interval in which no kernel, copy or fill ran."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    items, spans, device, launches, main = [], [], [], {}, None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name == trace.ITEM:
            items.append((ts, end))
            main = ev.get("tid") if main is None else main
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((ts, end, name, ev.get("tid")))
        elif cat in trace.DEVICE_CATS:
            device.append((ts, end, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, ev.get("tid"))
    items.sort()
    item_starts = [a for a, _ in items]
    out = [{} for _ in items]

    def item_of(span):
        i = bisect.bisect_right(item_starts, span[0]) - 1
        return i if i >= 0 and span[0] < items[i][1] else None

    def stats(span):
        return out[item_of(span)].setdefault(span[2], dict(n=0, us=0.0, idle_us=0.0, device_us=0.0))

    merged = trace._union([(a, b) for a, b, _ in device])
    merged_starts = [a for a, _ in merged]
    before = [0.0]  # device busy time before each merged interval
    for a, b in merged:
        before.append(before[-1] + b - a)

    def busy_until(t):
        i = bisect.bisect_right(merged_starts, t) - 1
        return before[i] + min(t, merged[i][1]) - merged[i][0] if i >= 0 else 0.0

    for span in spans:
        if item_of(span) is None:
            continue
        s = stats(span)
        a, b = span[0], span[1]
        s["n"] += 1
        s["us"] += b - a
        s["idle_us"] += (b - a) - (busy_until(b) - busy_until(a))

    threads = {}
    for span in spans:
        threads.setdefault(span[3], []).append(span)
    threads = {tid: _Thread(ss) for tid, ss in threads.items()}
    for a, b, corr in device:
        if corr not in launches:
            continue
        t, tid = launches[corr]
        owner = threads[tid].innermost(t) if tid in threads else None
        if owner is None and tid != main and main in threads:
            owner = threads[main].innermost(t)
        if owner is not None and item_of(owner) is not None:
            stats(owner)["device_us"] += b - a
    return out


def median(items, name, field):
    """The median over the items of ``field`` of the span ``name`` (0 in an
    item without it); None where no item holds any span (a program
    without them, or no trace)."""
    if not items or not any(items):
        return None
    return statistics.median(item.get(name, {}).get(field, 0.0) for item in items)
