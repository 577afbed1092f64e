"""Timing helpers the profilers share: stage marks that are CUDA events on
the card and host clocks on the CPU, a ``torch.profiler`` capture that
gives the card's idle share and the port's spans (``tracing.SPANS``), and a
synthetic cloud for a config's dataset.
"""

from __future__ import annotations

import time
import types
from pathlib import Path

import numpy as np
import torch

from lattice_net_tpu_torch.tracing import SPANS

# classes of each dataset's model (the configs' loaders give these)
NR_CLASSES = {"semantickitti": 20, "synthkitti": 20, "scannet": 21, "shapenet": 7, "toy": 6}
SPAN_NAMES = frozenset(name for name, _ in SPANS)


class Marks:
    """Time marks between stages: CUDA events on the card (the card's
    clock, host gaps included), ``time.perf_counter`` on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        """Milliseconds between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def mean_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` back-to-back calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    m = Marks(device)
    m.mark()
    for _ in range(iters):
        fn()
    m.mark()
    return m.ms()[0] / iters


def busy_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals:
    operations that overlap, on two streams, count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _on_device(evt) -> bool:
    """A kernel, copy or fill of the card (not a span's device-side range)."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA") and not getattr(evt, "is_user_annotation", False)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(fn, device, reps: int, top: int = 15, trace=None) -> dict:
    """A ``torch.profiler`` capture of ``reps`` calls of ``fn``: the wall
    time, the summed device time of the card's kernels, the card's idle
    share (1 - the union of its kernels', copies' and fills' intervals over
    the wall time), the kernels that take the most device time, and
    ``spans``: the calls and wall ms of each of the port's spans
    (``tracing.SPANS``) that ran.  On the CPU the device numbers are None
    (not measured).  With a ``trace`` path, the same capture is written
    there as a Chrome trace (``misc/parse_trace.py`` reads it)."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    spans = {
        e.key: dict(calls=e.count, wall_ms=e.cpu_time_total / 1e3)
        for e in averages if e.key in SPAN_NAMES and str(e.device_type).endswith("CPU")
    }  # fmt: skip
    out = dict(calls=reps, wall_ms=wall_us / 1e3, spans=spans)
    if trace is not None:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        out["trace"] = str(trace)
    if not cuda:
        return dict(out, device_ms=None, idle_share=None)
    # device-side events only: the aten ops that launched them carry the same
    # device time again
    kernels = [e for e in averages if _on_device(e) and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in prof.events() if _on_device(e))
    ranked = sorted(kernels, key=_device_us, reverse=True)[:top]
    return dict(
        out, device_ms=device_us / 1e3, idle_share=1.0 - busy / wall_us, kernels=len(kernels),
        top=[dict(name=e.key[:80], calls=e.count, device_ms=_device_us(e) / 1e3) for e in ranked],
    )  # fmt: skip


def stage_row(name, fn, device, iters: int, profiled: int = 3) -> dict:
    """``{stage, ms, device_ms, idle_share, spans}`` of one stage: ``ms`` by
    :func:`mean_ms` over ``iters`` calls, the device time a call and the
    idle share (None on the CPU) and the spans from a :func:`profile` of
    ``profiled`` more."""
    with torch.inference_mode():
        ms = mean_ms(fn, device, iters)
        prof = profile(fn, device, profiled)
    dev_ms = None if prof["device_ms"] is None else prof["device_ms"] / profiled
    return dict(stage=name, ms=ms, device_ms=dev_ms, idle_share=prof["idle_share"], spans=prof["spans"])


def synthetic_cloud(dataset_name: str, n_points: int, seed: int):
    """A synthetic cloud record (numpy V, C, I, L_gt) for a config's
    dataset: a ScanNet-like room (``data.synth_scannet.make_indoor_scene``)
    for "scannet", a SemanticKITTI-like scan (``make_scene``, with its
    intensity) otherwise."""
    if dataset_name == "scannet":
        from lattice_net_tpu_torch.data.synth_scannet import make_indoor_scene

        V, C, L = make_indoor_scene(n_points, seed=seed)
        return types.SimpleNamespace(V=V, C=C, I=np.zeros((len(V), 1), np.float32), L_gt=L)
    from lattice_net_tpu_torch.data.synth_kitti import make_scene

    return make_scene(n_points, seed=seed)
