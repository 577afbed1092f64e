"""Where one train step spends its time.

    python -m lattice_net_tpu_torch.misc.profile_train [config] [--n-points N]
        [--budget B] [--cap C] [--sigma S] [--iters I] [--device cuda|cpu]
        [--trace DIR] [section.key=value ...]

Trains on one synthetic cloud of the config's dataset
(``misc/profiling.synthetic_cloud``: a ScanNet-like room for "scannet", a
``make_scene`` scan with its labels otherwise) with the config's model at
full width (seeded random weights; bf16 convs on the card, f32 on the CPU;
``LNT_CONV_DTYPE`` overrides) and prints JSON lines:

* ``setup``: the config, points, budget, sigma and capacities (``--cap``
  halves from C; without it the config's schedule, scouted on the cloud
  where ``capacity_mode`` is "auto") with the occupancy per level;
* ``steps``: the time of each of ``--iters`` steps of ``make_train_step``
  after 3 warm-up steps (CUDA events on the card), with their mean, median,
  spread and standard deviation, the head's switch (``LNT_HEAD_SEGVJP``)
  and the launches of each of the six kernels in the last step;
* ``stages``: per step, the times of the step's three stages (build,
  forward and loss; backward; optimizer update), over 3 more steps;
* ``profile``: a ``torch.profiler`` capture of 3 steps: the wall time, the
  summed device time of all kernels, the card's idle share (1 - the union
  of its operations' intervals / wall) and the kernels that take the most
  device time (not measured on the CPU), and the port's spans (calls and
  wall ms of each of ``tracing.SPANS``); with ``--trace DIR`` that capture is also written as a Chrome
  trace to ``DIR/train_step.pt.trace.json`` (``misc/parse_trace.py``).

The JAX tool's rows A-E (``--rows``) are not ported: ``stages`` splits
the step into what they attribute.  ``build_forward_loss_ms`` stands for
row A (the loss with the build inside, no gradient), ``backward_ms`` for
B - A (the backward), ``update_ms`` for row D (the optimizer alone) and
``steps`` for row E (the whole step).  Row C (the hierarchy built outside
the differentiated program) is the port's only formulation: an eager
build never enters autograd, so B - C is zero here.

The default config is ``config/lnn_train_semantic_kitti.cfg`` on one
2^17-point scan; ``config/lnn_train_scannet.cfg --n-points 400000 --budget
524288`` profiles the ScanNet step at auto capacities.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.config import (
    LatticeParams,
    TrainParams,
    apply_overrides,
    load_config,
    model_params_from_config,
)
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import default_conv_dtype
from lattice_net_tpu_torch.lattice.structure import build_hierarchy, default_capacity_schedule
from lattice_net_tpu_torch.misc.profiling import NR_CLASSES, Marks, profile, synthetic_cloud
from lattice_net_tpu_torch.models.lnn import prepare_cloud
from lattice_net_tpu_torch.ops_cuda.gather import take_rows
from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_scatter
from lattice_net_tpu_torch.ops_cuda.segment import (
    seg_max_carry,
    seg_max_carry_bwd,
    seg_sum_sorted_fast,
)
from lattice_net_tpu_torch.parallel.data_parallel import (
    TrainState,
    apply_update,
    forward_loss,
    gradients,
    make_batch,
)
from lattice_net_tpu_torch.train.setup import TrainSetup, capacities_from_config

CONFIG = Path(__file__).resolve().parents[2] / "config" / "lnn_train_semantic_kitti.cfg"
KITTI_TRAIN_SCANS = 19130  # sequences 00-10 less 08: one epoch at batch size 1
WARMUP, STAGED, PROFILED = 3, 3, 3
TRACE_NAME = "train_step.pt.trace.json"
# the launch counter of each kernel's wrapper
KERNELS = dict(
    k1=patch_gather, k1b=patch_scatter, k2=seg_max_carry, k2b=seg_max_carry_bwd,
    k3=seg_sum_sorted_fast, k4=take_rows,
)  # fmt: skip
HEAD_SWITCHES = {"LNT_HEAD_SEGVJP": "0"}  # with its default


def _staged_step(run: TrainSetup, loss_fn, state: TrainState, batch, device):
    """One train step, as ``make_train_step`` composes it from its three
    stages, with time marks between the stages."""
    m = Marks(device)
    m.mark()
    leaves, loss, _ = forward_loss(loss_fn, state.params, batch)
    m.mark()
    grads = gradients(loss, leaves)
    m.mark()
    state = apply_update(run.tx, state, grads, loss)
    m.mark()
    times = m.ms()
    names = ("build_forward_loss_ms", "backward_ms", "update_ms")
    return state, dict(zip(names, times), total_ms=sum(times))


def setup(config, n_points, budget, cap, sigma, overrides, device):
    """(TrainSetup, batch, setup record) for one synthetic cloud of the
    config's dataset."""
    cfg = apply_overrides(load_config(config), overrides)
    tp, lp = TrainParams.from_config(cfg), LatticeParams.from_config(cfg)
    nr_classes = NR_CLASSES.get(tp.dataset_name, 20)
    mp = model_params_from_config(cfg, nr_classes)
    cloud = prepare_cloud(synthetic_cloud(tp.dataset_name, n_points, seed=0), mp)
    if sigma:
        lp = dataclasses.replace(lp, sigmas=(sigma,))
    if cap:
        caps = default_capacity_schedule(cap, mp.nr_downsamples)
    else:
        caps = capacities_from_config(lp, mp, clouds=[cloud[0]], device=device)
    conv_dtype = default_conv_dtype(device)
    run = TrainSetup.from_config(cfg, nr_classes, KITTI_TRAIN_SCANS, device, conv_dtype, seed=0, capacities=caps)
    if sigma:
        run = dataclasses.replace(run, sigma=sigma)
    batch = make_batch([cloud], budget, rng=np.random.default_rng(0), device=device)
    h = build_hierarchy(batch["positions"][0], run.sigma, mp.nr_downsamples, caps,
                        point_mask=batch["point_mask"][0])  # fmt: skip
    record = dict(
        setup=str(config), dataset=tp.dataset_name, positions_mode=mp.positions_mode, points=len(cloud[0]),
        budget=budget, sigma=run.sigma if not isinstance(run.sigma, tuple) else list(run.sigma),
        capacities=list(caps), occupancy=[int(s.nr_verts) for s in h.structures],
        overflow=[int(s.nr_overflow) for s in h.structures], conv_dtype=str(conv_dtype),
        params=sum(p.numel() for p in run.model.parameters()), device=str(device),
    )  # fmt: skip
    return run, batch, record


def run(config=CONFIG, n_points=1 << 17, budget=0, cap=0, sigma=0.0, iters=10, overrides=(), device=None,
        trace=None):  # fmt: skip
    """Prints the JSON lines of the module docstring; returns them as dicts.
    ``trace``: a directory for the ``profile`` capture's Chrome trace."""
    device = resolve_device(device)
    budget = budget or 1 << int(np.ceil(np.log2(n_points)))
    run_, batch, record = setup(config, n_points, budget, cap, sigma, overrides, device)
    out = [record]
    print(json.dumps(record), flush=True)
    state = TrainState.create(run_.model.state_dict(), run_.tx)
    step = run_.train_step()
    for _ in range(WARMUP):
        state, _ = step(state, batch)
    times = []
    for _ in range(iters):
        for fn in KERNELS.values():
            fn.launches = 0
        m = Marks(device)
        m.mark()
        state, metrics = step(state, batch)
        m.mark()
        times.append(m.ms()[0])
    out.append(dict(
        steps=iters, step_ms=times, mean_ms=statistics.mean(times),
        median_ms=statistics.median(times), min_ms=min(times), max_ms=max(times),
        std_ms=statistics.stdev(times) if len(times) > 1 else 0.0, loss=float(metrics["loss"]),
        head={k: os.environ.get(k, v) for k, v in HEAD_SWITCHES.items()},
        launches_last_step={k: fn.launches for k, fn in KERNELS.items()},
    ))  # fmt: skip
    print(json.dumps(out[-1]), flush=True)

    loss_fn = run_.loss_fn()
    for i in range(STAGED):
        state, stages = _staged_step(run_, loss_fn, state, batch, device)
        out.append(dict(stages=i, **stages))
        print(json.dumps(out[-1]), flush=True)

    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    prof = profile(one_step, device, PROFILED, trace=None if trace is None else Path(trace) / TRACE_NAME)
    out.append(dict(profile=f"{PROFILED} train steps", **prof))
    print(json.dumps(out[-1]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", default=str(CONFIG))
    ap.add_argument("--n-points", type=int, default=1 << 17)
    ap.add_argument("--budget", type=int, default=0, help="padded points a step (default: the next power of 2)")
    ap.add_argument("--cap", type=int, default=0, help="level-0 capacity, halved a level (default: the config's)")
    ap.add_argument("--sigma", type=float, default=0.0, help="one sigma for every dimension (default: the config's)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, help=f"write the profiled steps' Chrome trace to DIR/{TRACE_NAME}")
    ap.add_argument("overrides", nargs="*", help="config overrides (section.key=value)")
    a = ap.parse_args()
    run(a.config, a.n_points, a.budget, a.cap, a.sigma, a.iters, a.overrides, a.device, a.trace)


if __name__ == "__main__":
    main()
