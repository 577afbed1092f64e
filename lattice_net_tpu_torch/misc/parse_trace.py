"""Device time per kernel name in a ``torch.profiler`` Chrome trace (the JAX
package's ``misc/parse_xplane.py``, which sums an xplane trace per HLO op).

    python -m lattice_net_tpu_torch.misc.parse_trace TRACE [--top 60] [--line-filter S]

``TRACE`` is a trace file, or a directory whose newest ``*.json`` (searched
recursively) is read: the files that ``profile_forward --trace DIR`` and
``profile_train --trace DIR`` write.  The device events (``cat`` ``kernel``,
``gpu_memcpy`` and ``gpu_memset``) are summed per event name on each device
line, one line a ``pid``/``tid`` pair (a card's stream), named by the
trace's ``process_name`` and ``thread_name`` records.  ``--line-filter``
keeps the lines whose name contains the substring.

Prints JSON lines: the trace's path; per line its name, events and total
ms with the top ``--top`` names (calls, ms, share of the line); last the
device total over the kept lines.  A trace with no device events (a CPU
capture) gives a device total of 0.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(trace) -> Path:
    """``trace`` itself, or the newest ``*.json`` under the directory."""
    trace = Path(trace)
    if trace.is_file():
        return trace
    found = sorted(trace.rglob("*.json"), key=lambda p: (p.stat().st_mtime, str(p)))
    if not found:
        raise SystemExit(f"no *.json under {trace}")
    return found[-1]


def _line_names(events) -> tuple:
    """``({pid: process name}, {(pid, tid): thread name})`` from the
    metadata records."""
    procs, threads = {}, {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        name = (ev.get("args") or {}).get("name")
        if ev.get("name") == "process_name":
            procs[ev.get("pid")] = name
        elif ev.get("name") == "thread_name":
            threads[(ev.get("pid"), ev.get("tid"))] = name
    return procs, threads


def summarize(trace, top: int = 60, line_filter: str = "") -> dict:
    """``{"trace", "lines": [{"line", "events", "total_ms", "top": [...]}],
    "device_total_ms"}`` of one trace; ``dur`` is in microseconds."""
    path = trace_path(trace)
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    procs, threads = _line_names(events)
    total_us = collections.defaultdict(collections.Counter)
    calls = collections.defaultdict(collections.Counter)
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        key = (ev.get("pid"), ev.get("tid"))
        total_us[key][ev["name"]] += float(ev.get("dur", 0.0))
        calls[key][ev["name"]] += 1
    lines = []
    for (pid, tid), per_name in sorted(total_us.items(), key=lambda kv: str(kv[0])):
        name = f"{procs.get(pid) or f'pid {pid}'} / {threads.get((pid, tid)) or f'tid {tid}'}"
        if line_filter and line_filter not in name:
            continue
        line_us = sum(per_name.values())
        ranked = [
            dict(name=n, calls=calls[(pid, tid)][n], ms=us / 1e3, share=us / line_us if line_us else 0.0)
            for n, us in per_name.most_common(top)
        ]  # fmt: skip
        lines.append(dict(line=name, events=sum(calls[(pid, tid)].values()), total_ms=line_us / 1e3, top=ranked))
    return dict(trace=str(path), lines=lines, device_total_ms=sum(ln["total_ms"] for ln in lines))


def run(trace, top: int = 60, line_filter: str = "") -> dict:
    """Prints the JSON lines of the module docstring; returns the summary."""
    out = summarize(trace, top, line_filter)
    print(json.dumps(dict(trace=out["trace"])), flush=True)
    for line in out["lines"]:
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(device_total_ms=out["device_total_ms"], lines=len(out["lines"]))), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="a Chrome trace file, or a directory holding one")
    ap.add_argument("--top", type=int, default=60)
    ap.add_argument("--line-filter", default="", help="keep the lines whose name contains this substring")
    a = ap.parse_args()
    run(a.trace, a.top, a.line_filter)


if __name__ == "__main__":
    main()
