"""Train-step throughput against the batch size on ShapeNet-scale clouds.

    python -m lattice_net_tpu_torch.misc.batch_scaling_probe [--batches 1,8,16,32]
        [--n-points 2048] [--cap 8192] [--sigma 0.05] [--iters 20] [--device cuda|cpu]

Runs chained train steps (build, forward, Lovász + NLL, backward, AdamW) on
procedural part-segmented objects of about 2k points (the JAX package's
``make_shapenet_like_cloud``, the same draws) with the reference ShapeNet
example model (``ln_train_shapenet_example.cfg``'s widths, 5 classes), for
each batch size b, and prints one JSON line a batch (step ms by CUDA events
on the card, clouds/s) and a summary line.  b = 1 takes the build's fast
paths; b > 1 builds every cloud under ``static_general_branches()``, as
``make_loss_fn`` does for every batch of ``ln_train``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import default_conv_dtype
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.misc.profiling import Marks
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.parallel.data_parallel import TrainState, make_batch, make_train_step
from lattice_net_tpu_torch.train.optim import make_optimizer

# the reference ShapeNet example model (ln_train_shapenet_example.cfg)
MODEL = dict(
    nr_classes=5, pointnet_channels_per_layer=(16, 32, 64), pointnet_start_nr_channels=64, nr_downsamples=2,
    nr_blocks_down_stage=(2, 2), nr_blocks_bottleneck=3, nr_blocks_up_stage=(2, 2),
    nr_levels_down_with_normal_resnet=2, nr_levels_up_with_normal_resnet=2,
)  # fmt: skip


def make_shapenet_like_cloud(n_points: int, seed: int):
    """Procedural part-segmented object in the unit box (4 parts: a body,
    two wings, a fin), the JAX package's generator with the same draws."""
    rng = np.random.default_rng(seed)
    per = n_points // 4
    parts, labels = [], []
    u = rng.normal(size=(per, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
    parts.append(u * np.asarray([0.45, 0.18, 0.12]) + rng.normal(0, 0.01, (per, 3)))
    labels.append(np.full(per, 1))
    for sgn in (-1.0, 1.0):
        xy = rng.uniform([-0.25, 0.02], [0.25, 0.45], (per, 2))
        parts.append(np.stack([xy[:, 0], sgn * xy[:, 1], rng.normal(0, 0.01, per)], 1))
        labels.append(np.full(per, 2))
    m = n_points - 3 * per
    parts.append(np.stack([rng.uniform(0.35, 0.5, m), rng.normal(0, 0.01, m), rng.uniform(0, 0.2, m)], 1))
    labels.append(np.full(m, 3))
    V = np.concatenate(parts).astype(np.float32)
    L = np.concatenate(labels).astype(np.int32)
    sh = rng.permutation(n_points)
    return V[sh], L[sh]


def run(batches=(1, 8, 16, 32), n_points=2048, cap=8192, sigma=0.05, iters=20, device=None):
    """Prints the JSON lines of the module docstring; returns the summary."""
    device = resolve_device(device)
    mp = ModelParams(**MODEL)
    caps = (cap, cap // 2, cap // 4)
    pos0 = torch.from_numpy(make_shapenet_like_cloud(n_points, 0)[0]).to(device)
    with torch.inference_mode():
        h = build_hierarchy(pos0, sigma, mp.nr_downsamples, caps)
    occ = [int(s.nr_verts) for s in h.structures]
    overflow = [int(s.nr_overflow) for s in h.structures]
    print(json.dumps(dict(occupancy=occ, capacities=list(caps), overflow=overflow)), flush=True)
    if sum(overflow):
        raise ValueError(f"the probe's clouds overflow capacities {caps}: {overflow}")
    model = LNN(mp, torch.Generator().manual_seed(0), device=device, conv_dtype=default_conv_dtype(device))
    params = model.state_dict()
    results = {}
    for b in batches:
        clouds = [make_shapenet_like_cloud(n_points, s) for s in range(b)]
        batch = make_batch([(v, np.zeros((n_points, 1), np.float32), t) for v, t in clouds], n_points,
                           device=device)  # fmt: skip
        tx = make_optimizer(1e-3, weight_decay=1e-4)
        state = TrainState.create(params, tx)
        step = make_train_step(model, tx, sigma, mp.nr_downsamples, caps, ignore_index=-1, full_mask=True)
        m = Marks(device)
        m.mark()
        state, metrics = step(state, batch)
        m.mark()
        for _ in range(iters):
            state, metrics = step(state, batch)
        m.mark()
        first_ms, total_ms = m.ms()
        ms = total_ms / iters
        results[b] = dict(step_ms=ms, clouds_per_s=b / ms * 1000, first_step_ms=first_ms, loss=float(metrics["loss"]))
        print(json.dumps(dict(batch=b, **results[b])), flush=True)
    best = max(results, key=lambda b: results[b]["clouds_per_s"])
    summary = dict(
        metric="shapenet_scale_batch_scaling", unit="clouds_per_s", n_points=n_points, capacities=list(caps),
        occupancy=occ, results=results, best_batch=best, device=str(device),
        speedup_vs_b1=results[best]["clouds_per_s"] / results[1]["clouds_per_s"] if 1 in results else None,
    )  # fmt: skip
    print(json.dumps(summary), flush=True)
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--cap", type=int, default=8192)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--batches", default="1,8,16,32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    run(tuple(int(x) for x in a.batches.split(",")), a.n_points, a.cap, a.sigma, a.iters, a.device)


if __name__ == "__main__":
    main()
