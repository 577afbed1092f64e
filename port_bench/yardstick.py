"""The benchmark's arithmetic, frozen here so that later changes to the
program cannot move it: the table of peaks, the model's FLOPs, K1's bytes,
the aten-op counter and the comparison numbers that decide ``correct``.

Nothing here imports the program.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# K1, the patch gather, under its two layouts (csrc/patch_gather.cu)
K1_KERNEL_NAMES = ("gather_rows16", "gather_rows_staged")


def filter_extent(pos_dim: int) -> int:
    """2(d+1) one-hop neighbours plus the centre vertex."""
    return 2 * (pos_dim + 1) + 1


def lnn_forward_flops(model: dict, nr_classes: int, pos_dim: int, value_channels: int,
                      occupied, n_points: int) -> int:  # fmt: skip
    """FLOPs (2 a multiply-add) of one LNN forward over a hierarchy whose
    level ``l`` holds ``occupied[l]`` vertices, for ``n_points`` real
    points: each lattice conv 2·V·K·C_in·C_out over its output level's
    occupied vertices (K the filter extent), each 1x1 layer 2·V·C_in·C_out,
    PointNet's per-edge layers over the N·(d+1) edges, the head's 1x1
    layers and per-vertex classifier, its offsets and its slice.  Norms,
    activations and the build are not counted."""
    k = filter_extent(pos_dim)
    d1 = pos_dim + 1
    v = [int(x) for x in occupied]
    conv = lambda lvl, cin, cout: 2 * v[lvl] * k * cin * cout  # noqa: E731
    dense = lambda lvl, cin, cout: 2 * v[lvl] * cin * cout  # noqa: E731
    flops = 0
    edges = n_points * d1
    cur = pos_dim + value_channels
    for c in model["pointnet_channels_per_layer"]:
        flops += 2 * edges * cur * c
        cur = c
    start = model["pointnet_start_nr_channels"]
    flops += conv(0, 2 * cur, start)

    def block(resnet, lvl, ch):
        if resnet:
            return 2 * conv(lvl, ch, ch)
        mid = ch // 4
        return dense(lvl, ch, mid) + conv(lvl, mid, mid) + dense(lvl, mid, ch)

    nd = model["nr_downsamples"]
    cur, skips = start, []
    for i in range(nd):
        resnet = i < model["nr_levels_down_with_normal_resnet"]
        flops += model["nr_blocks_down_stage"][i] * block(resnet, i, cur)
        skips.append(cur)
        after = int(cur * 2 * model["compression_factor"])
        flops += conv(i + 1, cur, after)
        cur = after
    flops += model["nr_blocks_bottleneck"] * block(False, nd, cur)
    for i in range(nd):
        lvl = nd - 1 - i
        skip = skips.pop()
        fine = cur // 2
        flops += conv(lvl, cur, fine)
        cur = skip + fine
        resnet = i >= nd - model["nr_levels_up_with_normal_resnet"]
        flops += model["nr_blocks_up_stage"][i] * block(resnet, lvl, cur)
    bottleneck = 8
    flops += dense(0, cur, cur) + dense(0, cur, cur // 2) + dense(0, cur // 2, bottleneck)
    flops += dense(0, cur, nr_classes)
    flops += 2 * n_points * d1 * (bottleneck + 1)  # the offsets' 1-column layer
    flops += 2 * n_points * d1 * nr_classes  # the deformed slice
    return flops


def k1_call_bytes(values_rows: int, channels: int, itemsize: int, neighbors: torch.Tensor,
                  include_center: bool, row0: int) -> int:  # fmt: skip
    """Least bytes one K1 call moves: each table row that some id (or the
    centre column) references, read once; the (Q, K) int32 ids; the (Q,
    K(+1), C) patch written once."""
    q, k = neighbors.shape
    ids = neighbors.reshape(-1)
    ids = ids[(ids >= 0) & (ids < values_rows)].to(torch.int64)
    if include_center:
        ids = torch.cat([ids, torch.arange(row0, row0 + q, device=ids.device)])
    rows = int(torch.unique(ids).numel())
    row_bytes = channels * itemsize
    return rows * row_bytes + neighbors.numel() * neighbors.element_size() + q * (k + include_center) * row_bytes


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside the mode (the forward's on this
    thread, the backward's on autograd's), the counter of the port's
    ``misc/op_census.Census`` without its classes."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def median(values) -> float:
    return float(statistics.median(values))


# ---------------------------------------------------------------------------
# the numbers compared for ``correct``
# ---------------------------------------------------------------------------


def label_gap(ref_logp: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> float:
    """The widest gap by which the log-probability of a served label lies
    below the reference's best, over the valid points."""
    best = ref_logp.max(dim=-1).values
    got = ref_logp.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    gap = torch.where(valid, best - got, torch.zeros_like(best))
    return float(gap.max())


def logp_max_abs(logp: torch.Tensor, ref_logp: torch.Tensor, valid: torch.Tensor) -> float:
    """The largest |log-probability - the reference's| over the valid points."""
    diff = (logp.to(torch.float32) - ref_logp.to(torch.float32)).abs().amax(dim=-1)
    return float(torch.where(valid, diff, torch.zeros_like(diff)).max())


def logp_best_gap(logp: torch.Tensor, ref_logp: torch.Tensor, valid: torch.Tensor) -> float:
    """The largest |log-probability - the reference's| of the class the
    reference puts first, over the valid points."""
    best = ref_logp.argmax(dim=-1, keepdim=True)
    diff = (logp.to(torch.float32).gather(1, best) - ref_logp.to(torch.float32).gather(1, best)).abs()[:, 0]
    return float(torch.where(valid, diff, torch.zeros_like(diff)).max())


def leaf_norm_gaps(program: dict, reference: dict, keep=None) -> list:
    """Each leaf's | ||program leaf|| - ||reference leaf|| |, over the larger
    of the reference leaf's norm and the median leaf's; ``keep`` names the
    leaves counted (all by default)."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: float(torch.linalg.vector_norm(reference[k].to(torch.float64))) for k in names}
    med = statistics.median(ref.values())
    gaps = []
    for k in names:
        got = float(torch.linalg.vector_norm(program[k].to(torch.float64)))
        gaps.append(abs(got - ref[k]) / max(ref[k], med, 1e-30))
    return gaps


def moved_leaves(first_grads: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient is above ``share`` of the median
    leaf's norm: the others (a bias under a norm) move by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.to(torch.float64))) for k, g in first_grads.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n > share * med}


def loss_gaps(program_losses, reference_losses) -> list:
    """Each step's relative loss gap."""
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program_losses, reference_losses)]


def iou_counts_gap(program, reference) -> float:
    """How far two steps' (intersection, union) counts per class lie apart:
    the sum of the counts' absolute differences over twice the points
    counted (a point whose label moves between two classes moves two
    counts)."""
    (pi, pu), (ri, ru) = program, reference
    moved = (pi - ri).abs().sum() + (pu - ru).abs().sum()
    points = ru.sum() + ri.sum()  # twice the valid points: a right one counts in I and U, a wrong one in two U
    return float(moved) / max(float(points), 1.0)
