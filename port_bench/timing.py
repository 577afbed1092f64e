"""What the loops share to time and trace the port: the stage clock of a
traced run, the open loop's wait, the device's synchronise and free, and
the traced segment."""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from port_bench import inputs, trace, yardstick


class Clock:
    """Per-stage times of the traced run: ``clock(name)`` times its block by
    CUDA events (the host clock, then a synchronise, for ``host_stages`` and
    on the CPU), read at the end."""

    def __init__(self, device, host_stages=()):
        self.cuda = torch.device(device).type == "cuda"
        self.host = set(host_stages)
        self.marks = {}

    @contextlib.contextmanager
    def __call__(self, name):
        times = self.marks.setdefault(name, [])
        if self.cuda and name not in self.host:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            times.append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    def ms(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [t if isinstance(t, float) else t[0].elapsed_time(t[1]) for t in v] for k, v in self.marks.items()}


def wait_until(t):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 5e-4 if left > 1e-3 else 0)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def traced_segment(run_items, device, program, flops_of, one_item):
    """The traced segment after the window: a profile of ``run_items(mark)``
    with K1's calls recorded, then the aten ops of ``one_item()``; returns
    the trace reading with K1's least seconds, the segment's model FLOPs
    (``flops_of()``) and the op count."""
    with program.recording_k1() as calls:
        tr = trace.capture(run_items, device) if torch.device(device).type == "cuda" else None
        if tr is None:
            run_items(contextlib.nullcontext)
    least = sum(yardstick.k1_call_bytes(*c) for c in calls) / yardstick.HBM_BYTES_PER_S
    counter = yardstick.OpCounter()
    with counter:
        one_item()
        sync(device)
    return dict(trace=tr, k1_least_s=least, k1_calls=len(calls), flops=flops_of(), aten_ops=counter.count)


def forward_flops(cfg, occupied, n_points) -> int:
    """Model FLOPs of one forward of a cloud of ``n_points`` over levels of
    ``occupied`` vertices (``yardstick.lnn_forward_flops``)."""
    pos_dim, channels = inputs.dims(cfg)
    return yardstick.lnn_forward_flops(cfg["model"], cfg["nr_classes"], pos_dim, channels, occupied, n_points)
