"""Where one train step spends its time on the card.

    python -m lattice_net_tpu_torch.misc.profile_train

Trains on one synthetic 2^17-point scan (``make_scene`` seed 0 with its
labels) with the SemanticKITTI train config at full width (seeded random
weights, bf16 convs) and prints JSON lines:

* ``steps``: the CUDA-event time of each of 10 steps of ``make_train_step``
  after 3 warm-up steps, with their mean, median, spread and standard
  deviation;
* ``stages``: per step, CUDA-event times of the step's three stages (build,
  forward and loss; backward; optimizer update), over 3 more steps;
* ``profile``: a ``torch.profiler`` capture of 3 steps: the wall time, the
  summed device time of all kernels, the device's idle share (1 - device /
  wall) and the kernels that take the most device time.

Runs on a CUDA card only (the default device raises elsewhere).
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import torch

from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.models.lnn import prepare_cloud
from lattice_net_tpu_torch.parallel.data_parallel import (
    TrainState,
    apply_update,
    forward_loss,
    gradients,
    make_batch,
)
from lattice_net_tpu_torch.train.setup import TrainSetup

CONFIG = Path(__file__).resolve().parents[2] / "config" / "lnn_train_semantic_kitti.cfg"
NR_CLASSES = 20
KITTI_TRAIN_SCANS = 19130  # sequences 00-10 less 08: one epoch at batch size 1
WARMUP, STEPS, STAGED, PROFILED = 3, 10, 3, 3
TOP_KERNELS = 15


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _staged_step(run: TrainSetup, loss_fn, state: TrainState, batch):
    """One train step, as ``make_train_step`` composes it from its three
    stages, with CUDA events between the stages."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    leaves, loss, _ = forward_loss(loss_fn, state.params, batch)
    ev[1].record()
    grads = gradients(loss, leaves)
    ev[2].record()
    state = apply_update(run.tx, state, grads)
    ev[3].record()
    ev[3].synchronize()
    names = ("build_forward_loss_ms", "backward_ms", "update_ms")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["total_ms"] = ev[0].elapsed_time(ev[3])
    return state, out


def main():
    run = TrainSetup.from_config(CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, seed=0)
    cloud = prepare_cloud(make_scene(1 << 17, seed=0), run.model.params)
    batch = make_batch([cloud], 1 << 17)
    state = TrainState.create(run.model.state_dict(), run.tx)
    step = run.train_step()
    for _ in range(WARMUP):
        state, _ = step(state, batch)
    times = []
    for _ in range(STEPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    print(json.dumps(dict(
        steps=STEPS, step_ms=times, mean_ms=statistics.mean(times),
        median_ms=statistics.median(times), min_ms=min(times), max_ms=max(times),
        std_ms=statistics.stdev(times), loss=float(metrics["loss"]),
    )), flush=True)  # fmt: skip

    loss_fn = run.loss_fn()
    for i in range(STAGED):
        state, stages = _staged_step(run, loss_fn, state, batch)
        print(json.dumps(dict(stages=i, **stages)), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the aten ops that launched them carry the same
    # device time again
    kernels = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0
    ]  # fmt: skip
    device_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:TOP_KERNELS]
    print(json.dumps(dict(
        profile=f"{PROFILED} train steps", wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
        idle_share=1.0 - device_us / wall_us, kernels=len(kernels),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        top=[dict(name=e.key[:80], calls=e.count, device_ms=_device_us(e) / 1e3) for e in top],
    )), flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
