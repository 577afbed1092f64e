"""ScanNet-scale capacity probe on the card.

    python -m lattice_net_tpu_torch.misc.scannet_scale_probe [--iters 5] [--bucketed]
        [--small-model] [--table-only] [--train-step] [--n-points N] [--cap C] [--headroom H]

Counterpart of ``lattice_net_tpu/misc/scannet_scale_probe.py``.  The
reference's largest configuration is a 5,000,000-entry table fed clouds of
up to 400k indoor points at sigma 0.08 (``config/lnn_train_scannet.cfg``).
The probe builds a synthetic room of that size (:func:`make_indoor_scene`)
and runs, on the card:

* a table-only build at the literal 5,242,880 schedule (halving per level):
  per-level occupancy and overflow, the same-level neighbour rows, the
  build's time and peak memory; the overflow must be zero;
* the full ScanNet model's build and forward at 2^21 (a 400k-point cloud
  makes at most 400k * (d + 1) = 1.6M vertices): occupancy, overflow,
  parameter count, the milliseconds per build + forward over ``--iters``
  calls (CUDA events), the peak memory and the K1/K2 launches per forward.

``--train-step`` then takes full train steps of that model at those
capacities (build, forward, the Lovász + NLL loss on random labels with
label 0 ignored, the backward and an AdamW-amsgrad update), first with
``remat_blocks`` (every Resnet/Bottleneck block recomputed in the backward)
and then without, each from the same weights: the ms of each step after
the first (CUDA events), the loss and the peak memory; a step that runs
out of card memory is reported as not fitting.

``--bucketed`` sizes the model's capacities from the occupancy of a scout
build instead (``capacity_schedule_from_occupancy`` with ``--headroom``,
growing an overflowing scout with ``escalate_capacities``); ``--small-model``
runs the KITTI model instead of ScanNet's.  The last line is one JSON
object.  The weights are seeded random ones; the convs run in bf16.

Which 32-bit limits these sizes stay under: K1 indexes in 64 bits and runs
at every size here (one launch per row block where a conv's patch passes
``LNT_CONV_CHUNK_BYTES``); K1-bwd (``patch_scatter``) raises at a cotangent
of 2^31 elements, and K2/K2-bwd/K3 index edge rows in 32 bits.  A training
step at the 2^21 schedule puts the head gather's cotangent at
2^19 * 4 * 21 elements, far under 2^31; 5M-row training is not run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from lattice_net_tpu_torch.data.synth_scannet import make_indoor_scene
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import check_positions
from lattice_net_tpu_torch.lattice.structure import (
    build_hierarchy,
    capacity_schedule_from_occupancy,
    default_capacity_schedule,
    escalate_capacities,
)
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.parallel.data_parallel import TrainState, make_train_step
from lattice_net_tpu_torch.train.optim import make_optimizer
from lattice_net_tpu_torch.ops_cuda.patch import patch_gather
from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry

TABLE_CAP = 5 * (1 << 20)  # 5,242,880
MODEL_CAP = 1 << 21


def model_params(small: bool = False) -> ModelParams:
    """The ScanNet model of ``config/lnn_train_scannet.cfg`` (21 classes,
    ``rgb+height``), or with ``small`` the KITTI one at 21 classes on the
    same four value channels."""
    if small:
        return ModelParams(
            nr_classes=21, values_mode="rgb+height", pointnet_channels_per_layer=(16, 32),
            pointnet_start_nr_channels=32,
            nr_downsamples=2, nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1,
            nr_blocks_up_stage=(1, 1),
        )  # fmt: skip
    return ModelParams(
        nr_classes=21, positions_mode="xyz", values_mode="rgb+height",
        pointnet_channels_per_layer=(16, 32, 64), pointnet_start_nr_channels=32, nr_downsamples=3,
        nr_blocks_down_stage=(6, 6, 8), nr_blocks_bottleneck=8, nr_blocks_up_stage=(2, 2, 2),
        nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
    )  # fmt: skip


def _levels(h):
    return ([int(s.nr_verts) for s in h.structures], [int(s.nr_overflow) for s in h.structures])


def _elapsed_ms(fn, dev):
    """(result, ms) of ``fn()`` between two CUDA events on ``dev``; host
    seconds on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def table_build(positions, sigma, nr_levels, caps, dev) -> dict:
    """One build at ``caps`` (no point features): occupancy, overflow,
    same-level neighbour rows, ms and peak memory."""
    _reset_peak(dev)
    with torch.inference_mode():
        h, ms = _elapsed_ms(lambda: build_hierarchy(positions, sigma, nr_levels, caps), dev)
        occ, ovf = _levels(h)
        rows = sum(int(t.shape[0]) for t in h.neighbors_same)
    return dict(capacities=list(caps), occupancy=occ, overflow=ovf, same_level_nbr_rows=rows,
                build_ms=ms, peak_mem_gb=_peak_gb(dev))  # fmt: skip


def bucketed_capacities(positions, sigma, nr_levels, n: int, headroom: float):
    """The model capacities from a scout build's occupancy: the scout starts
    at n / 8 a level and grows with ``escalate_capacities`` until nothing
    overflows.  Returns ``(caps, occupancy, escalations)``."""
    scout = capacity_schedule_from_occupancy([n // 8] * (nr_levels + 1), headroom=1.0)
    escalations = []
    while True:
        with torch.inference_mode():
            occ, ovf = _levels(build_hierarchy(positions, sigma, nr_levels, scout))
        if sum(ovf) == 0:
            break
        escalations.append(dict(capacities=list(scout), overflow=ovf))
        scout = escalate_capacities(scout, ovf, occ, headroom)
    return capacity_schedule_from_occupancy(occ, headroom=headroom), occ, escalations


def train_steps(mp, weights, positions, values, sigma, caps, steps, remat, dev, seed=2) -> dict:
    """``steps`` train steps of the model ``mp`` (``remat_blocks`` =
    ``remat``) from ``weights`` on one full cloud with labels drawn in [1,
    classes) (0 ignored), at ``caps``; AdamW-amsgrad at lr 1e-3, weight
    decay 1e-4.  Returns the step ms after the first (CUDA events), the
    losses and the peak memory, or ``fits=False`` where the card runs out of
    memory."""
    n = positions.shape[0]
    model = LNN(dataclasses.replace(mp, remat_blocks=remat), torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(weights)
    tx = make_optimizer(1e-3, weight_decay=1e-4)
    step = make_train_step(model, tx, sigma, mp.nr_downsamples, caps, ignore_index=0, full_mask=True)
    target = np.random.default_rng(seed).integers(1, mp.nr_classes, n).astype(np.int32)
    batch = {"positions": positions[None], "values": values[None],
             "target": torch.from_numpy(target).to(dev)[None],
             "point_mask": torch.ones((1, n), dtype=torch.bool, device=dev)}  # fmt: skip
    state = TrainState.create(model.state_dict(), tx)
    _reset_peak(dev)
    times, losses = [], []
    try:
        for _ in range(steps):
            (state, metrics), ms = _elapsed_ms(lambda: step(state, batch), dev)
            times.append(ms)
            losses.append(float(metrics["loss"]))
    except torch.cuda.OutOfMemoryError as exc:
        return dict(remat=remat, fits=False, error=str(exc).splitlines()[0], peak_mem_gb=_peak_gb(dev))
    return dict(remat=remat, fits=True, first_ms=times[0], times_ms=times[1:],
                ms=float(np.median(times[1:] or times)), losses=losses, peak_mem_gb=_peak_gb(dev))  # fmt: skip


def run(
    n_points: int = 400000,
    cap: int = TABLE_CAP,
    sigma: float = 0.08,
    iters: int = 5,
    small_model: bool = False,
    bucketed: bool = False,
    headroom: float = 1.5,
    table_only: bool = False,
    seed: int = 0,
    device=None,
    train_step: bool = False,
) -> dict:
    """The probe's phases (module docstring); prints a line for each and
    returns the record of the last JSON line.  ``device`` is the card
    unless ``"cpu"`` (times are then host times, not the card's)."""
    dev = resolve_device(device)
    mp = model_params(small_model)
    nl = mp.nr_downsamples
    caps_table = default_capacity_schedule(cap, nl)
    caps = default_capacity_schedule(min(cap, MODEL_CAP), nl)
    print(f"n_points={n_points} sigma={sigma} table capacities={caps_table} model capacities={caps}")

    V, C, _ = make_indoor_scene(n_points, seed=seed)
    check_positions(V, sigma=sigma)
    positions = torch.from_numpy(V).to(dev)
    values = torch.from_numpy(np.concatenate([C, V[:, 2:3]], axis=1)).to(dev)  # rgb+height
    record = dict(metric="scannet_scale_build_forward_latency", n_points=n_points, device=str(dev))
    if dev.type == "cuda":
        record["card"] = torch.cuda.get_device_name(dev)

    if bucketed:
        caps, occ_s, escalations = bucketed_capacities(positions, sigma, nl, n_points, headroom)
        for e in escalations:
            print(f"  scout bucket {e['capacities']} overflowed {e['overflow']}; escalating")
        print(f"bucketed capacities from occupancy {occ_s}: {list(caps)} (headroom {headroom}, pow2 buckets)")
        record["metric"] += "_bucketed"

    if table_only or (caps_table != caps and not bucketed):
        t = table_build(positions, sigma, nl, caps_table, dev)
        print(f"table build at {t['capacities']}: {t['build_ms']:.1f} ms, peak {t['peak_mem_gb']} GB")
        print(f"  occupancy per level: {t['occupancy']} / {t['capacities']}")
        print(f"  overflow per level:  {t['overflow']}  same-level nbr rows: {t['same_level_nbr_rows']}")
        if sum(t["overflow"]):
            raise RuntimeError(f"the table build overflowed: {t['overflow']}")
        record["table"] = t
    if table_only:
        print("table-only probe done (model phase skipped)")
        print(json.dumps(record), flush=True)
        return record

    model = LNN(mp, torch.Generator().manual_seed(seed), device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model parameters: {n_params:,}")

    def forward():
        h = build_hierarchy(positions, sigma, nl, caps, point_feats=values)
        logp, _ = model(h, positions, values)
        return torch.argmax(logp, dim=-1), h

    _reset_peak(dev)
    with torch.inference_mode():
        (pred, h), first_ms = _elapsed_ms(forward, dev)
        occ, ovf = _levels(h)
        del h
        print(f"first build + forward: {first_ms:.1f} ms")
        print(f"occupancy per level: {occ} / {list(caps)}")
        print(f"overflow per level:  {ovf}")
        if sum(ovf):
            raise RuntimeError(f"capacities {list(caps)} overflowed at ScanNet scale: {ovf}")
        times = []
        k1, k2 = patch_gather.launches, seg_max_carry.launches
        for _ in range(iters):
            (pred, _), ms = _elapsed_ms(forward, dev)
            times.append(ms)
        k1 = (patch_gather.launches - k1) // max(iters, 1)
        k2 = (seg_max_carry.launches - k2) // max(iters, 1)
    peak = _peak_gb(dev)
    ms = float(np.median(times)) if times else first_ms
    print(f"build + forward: median {ms:.1f} ms over {iters} calls; peak {peak} GB; "
          f"launches per forward K1={k1} K2={k2}")  # fmt: skip
    labels = int(torch.unique(pred).numel())
    record.update(value=ms, unit="ms", capacities=list(caps), occupancy=occ, overflow=ovf,
                  model_params=n_params, first_ms=first_ms, times_ms=times, peak_mem_gb=peak,
                  k1_per_forward=k1, k2_per_forward=k2, distinct_labels=labels)  # fmt: skip
    if train_step:
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model, pred
        record["train_step"] = []
        for remat in (True, False):
            r = train_steps(mp, weights, positions, values, sigma, caps, max(2, iters // 2 + 1), remat, dev)
            record["train_step"].append(r)
            if r["fits"]:
                print(f"train step (remat_blocks={remat}) at caps {list(caps)}: median {r['ms']:.1f} ms "
                      f"(first {r['first_ms']:.1f}), loss {r['losses'][0]:.4f}, peak {r['peak_mem_gb']} GB")  # fmt: skip
            else:
                print(f"train step (remat_blocks={remat}) at caps {list(caps)}: does not fit "
                      f"({r['error']}; peak {r['peak_mem_gb']} GB)")  # fmt: skip
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps(record), flush=True)
    return record


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-points", type=int, default=400000)
    ap.add_argument("--cap", type=int, default=TABLE_CAP)
    ap.add_argument("--sigma", type=float, default=0.08)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--small-model", action="store_true", help="the KITTI model instead of ScanNet's")
    ap.add_argument("--bucketed", action="store_true",
                    help="size the model capacities from a scout build's occupancy (pow2 buckets)")
    ap.add_argument("--headroom", type=float, default=1.5)
    ap.add_argument("--table-only", action="store_true", help="only the table build at --cap")
    ap.add_argument("--train-step", action="store_true",
                    help="then train steps at the model capacities, with and without remat_blocks")
    args = ap.parse_args()
    run(args.n_points, args.cap, args.sigma, args.iters, args.small_model, args.bucketed,
        args.headroom, args.table_only, train_step=args.train_step)  # fmt: skip


if __name__ == "__main__":
    main()
