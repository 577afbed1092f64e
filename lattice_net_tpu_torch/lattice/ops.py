"""Lattice operators.

Counterpart of ``lattice_net_tpu/lattice/ops.py``: the sort-free segment
reductions over the level-0 edge sort, ``distribute_sorted``, the im2row
convolution with its flip-neighbours adjoint (in row blocks where its patch
would pass ``LNT_CONV_CHUNK_BYTES``), the head gathers, and the library off
the model's path (segment helpers, splat, distribute, slice, gather, blur,
depthwise conv, expand, the splatting mask).  Index conventions are the
reference's: invalid = capacity, every gather masks.

Four operators run hand-written kernels on the card: ``seg_max_sorted``
(K2 forward, K2-bwd backward, ``ops_cuda.segment``); the patch gathers of
``conv_im2row`` and ``gather_rows_clustered`` (K1 forward;
``gather_rows_clustered``'s backward is K1-bwd, ``ops_cuda.patch``, and the
conv's backward is two more K1 gathers); ``gather_rows`` (K4,
``ops_cuda.gather``: the head's edge-sort gather and the row gathers of
``distribute_sorted`` without carried rows and of ``distribute``); and
``seg_sum_sorted`` for C > 8 (K3, ``ops_cuda.segment``).  The library's
slice, gather, blur and depthwise conv gather through K1.
``gather_rows_clustered_segbwd``, the edge-sort head adjoint, runs K4
forward and K3 backward.  ``plain=True`` sends them
through the kernels' plain PyTorch versions on any device; it exists to
hold the kernels against those versions on the card.

``LNT_FAST_OPS=0`` (read at each call) sends ``gather_rows``,
``gather_neighbor_values`` and ``gather_rows_clustered`` (and so every conv
and head gather, K1, K1-bwd and K4), and the modules' fused GroupNorm
(``nn.modules.norm_act``), down their plain route on every device, an
explicit opt-out for A/B runs that says so once; unset or any other value,
the kernels run for CUDA tensors.  The segment reductions (K2, K2-bwd, K3)
keep their kernels, as JAX routes them by another switch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.lattice.structure import PACK_BOUND
from lattice_net_tpu_torch.ops_cuda.gather import take_rows
from lattice_net_tpu_torch.ops_cuda import patch as k1_patch
from lattice_net_tpu_torch.ops_cuda.patch import patch_gather
from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_sum_sorted_fast

__all__ = [
    "check_positions",
    "seg_sum_sorted",
    "seg_counts_sorted",
    "seg_mean_sorted",
    "take_sorted",
    "seg_max_sorted",
    "distribute_sorted",
    "segment_sum",
    "segment_mean",
    "segment_max_with_src",
    "splat",
    "distribute",
    "expand",
    "create_splatting_mask",
    "slice_lattice",
    "gather_lattice",
    "blur",
    "bilateral_blur",
    "depthwise_conv",
    "gather_neighbor_values",
    "gather_rows",
    "gather_rows_clustered",
    "gather_rows_clustered_segbwd",
    "conv_im2row",
    "default_conv_dtype",
]


def check_positions(positions, values=None, sigma=None) -> None:
    """Validation of one cloud's numpy arrays at the data boundary (the JAX
    package's ``ops.check_positions``): rank, emptiness, float dtype and
    finiteness of the positions, and the values' rows and finiteness.

    With ``sigma``, it also checks that the scene fits the packed lattice
    keys (|key| < ``structure.PACK_BOUND``): keys scale as about
    2.4 * |position| / sigma, so scenes up to ~6000 sigma across fit."""
    p = np.asarray(positions)
    if p.ndim != 2 or p.shape[1] not in (2, 3, 4, 5, 6):
        raise ValueError(f"positions must be (N, d) with d in 2..6, got {p.shape}")
    if p.shape[0] == 0:
        raise ValueError("empty point cloud")
    if not np.issubdtype(p.dtype, np.floating):
        raise TypeError(f"positions must be float, got {p.dtype}")
    if not np.all(np.isfinite(p)):
        raise ValueError("positions contain NaN/Inf")
    if sigma is not None:
        s = np.broadcast_to(np.asarray(sigma, np.float64), (p.shape[1],))
        # elevation stretches scaled coords by < (d+1)*sqrt(2/3)/sqrt(2) per
        # axis; 2.5 bounds it for d <= 6, plus margin for neighbour moves
        max_key = 2.5 * np.max(np.abs(p) / s) + 8
        if max_key >= PACK_BOUND:
            raise ValueError(
                f"scene too large for packed lattice keys: |key| ~ {max_key:.0f} "
                f">= {PACK_BOUND}; increase sigma or crop the cloud"
            )
    if values is not None:
        v = np.asarray(values)
        if v.ndim != 2 or v.shape[0] != p.shape[0]:
            raise ValueError(f"values must be (N, C) matching positions, got {v.shape}")
        if not np.all(np.isfinite(v)):
            raise ValueError("values contain NaN/Inf")


# ---------------------------------------------------------------------------
# sort-free segment reductions over pre-sorted edges (see structure.EdgeSort)
# ---------------------------------------------------------------------------


_SCAN_ROW = 16


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over dim 0, in the order XLA's CPU backend
    sums ``jnp.cumsum``: rows of 16 summed left to right, the row totals
    scanned the same way recursively, each row's exclusive carry added last.

    The order matters: the prefix sums of a scan's 5e5 edge positions reach
    magnitudes where f32 keeps ~1e-2, so another order (``torch.cumsum``
    accumulates in f64 on the CPU) moves the local means, and with them the
    model's outputs, by far more than the tests' 1e-4.  Fixing the order
    makes the port's local means bit-equal to the reference's on every
    device."""
    n = x.shape[0]
    if n <= _SCAN_ROW:
        cols = [x[0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[k])
        return torch.stack(cols)
    nb = -(-n // _SCAN_ROW)
    pad = x.new_zeros((nb * _SCAN_ROW - n,) + x.shape[1:])
    rows = torch.cat([x, pad]).reshape((nb, _SCAN_ROW) + x.shape[1:])
    cols = [rows[:, 0]]
    for k in range(1, _SCAN_ROW):
        cols.append(cols[-1] + rows[:, k])
    scanned = torch.stack(cols, dim=1)
    totals = _cumsum_f32(scanned[:, -1])
    carry = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (scanned + carry[:, None]).reshape((nb * _SCAN_ROW,) + x.shape[1:])[:n]


def seg_sum_sorted(vals_sorted: torch.Tensor, edges, capacity: int, plain=False) -> torch.Tensor:
    """Sum (M, C) rows over each vertex's contiguous run, in the input's
    dtype.  C > 8: kernel K3 (``plain`` forces its plain version).  C <= 8:
    an f32 prefix sum (:func:`_cumsum_f32`) and run-boundary differences,
    the JAX package's split, which keeps the narrow sums bit-equal to
    JAX's."""
    if vals_sorted.shape[1] > 8:
        out = seg_sum_sorted_fast(vals_sorted, edges.vertex, edges.run_end, capacity, plain)
        return out.to(vals_sorted.dtype)
    csum = _cumsum_f32(vals_sorted.to(torch.float32))
    run_end = edges.run_end
    tot = torch.where((run_end >= 0)[:, None], csum[run_end.clamp(min=0)], 0.0)
    out = tot - torch.cat([torch.zeros_like(tot[:1]), tot[:-1]], dim=0)
    return out.to(vals_sorted.dtype)


def seg_counts_sorted(edges, capacity: int) -> torch.Tensor:
    """(cap,) number of edges per vertex (0 for padding rows)."""
    run_end = edges.run_end
    prev = torch.cat([torch.full_like(run_end[:1], -1), run_end[:-1]])
    return (run_end - prev).to(torch.int32)


def seg_mean_sorted(vals_sorted: torch.Tensor, edges, capacity: int) -> torch.Tensor:
    total = seg_sum_sorted(vals_sorted, edges, capacity)
    counts = seg_counts_sorted(edges, capacity).to(total.dtype)
    return total / torch.clamp(counts, min=1.0)[:, None]


def take_sorted(table: torch.Tensor, ids_sorted: torch.Tensor) -> torch.Tensor:
    """(cap, C) x (M,) -> (M, C); ids >= cap read 0."""
    cap = table.shape[0]
    out = table[ids_sorted.clamp(max=cap - 1)]
    return torch.where((ids_sorted < cap)[:, None], out, 0.0)


def seg_max_sorted(
    vals_sorted: torch.Tensor, carry_sorted: torch.Tensor, edges, capacity: int, plain=False
):
    """Per-vertex, per-channel max of (M, C) values and the carry of the
    winner (ties: latest sorted edge); both (cap, C), 0 for empty rows.

    Kernel K2 on the card, K2-bwd in the backward (the cotangents go to the
    winners); ``plain`` forces their plain versions."""
    run_end = edges.run_end
    if run_end.shape[0] != capacity:
        raise ValueError(f"edge runs cover {run_end.shape[0]} vertices, capacity is {capacity}")
    return seg_max_carry(vals_sorted, carry_sorted, edges.vertex, run_end, plain=plain)


def distribute_sorted(
    positions: torch.Tensor,
    values: torch.Tensor,
    edges,
    capacity: int,
    subtract_local_mean: bool = True,
    splat_weights: torch.Tensor | None = None,
):
    """Per-edge rows [xyz - vertex-mean xyz, values, weight] in sorted edge order
    ([xyz, values, weight] without ``subtract_local_mean``, the ablation modes').

    Where the build carried the rows (``EdgeSort.rows``, built with
    ``point_feats`` = these ``values``), it reads them.  Otherwise (a build
    without ``point_feats``, the canonical fast build) one (M, d + C + d1)
    row gather (K4 on the card) takes each edge's point row, with the
    barycentric columns of ``splat_weights`` folded in, and each edge keeps
    its own corner's column (where ``EdgeSort.weights`` holds the weights,
    the gather takes [positions, values] only).  Invalid edges (padding, overflow) get vertex
    id ``capacity`` and zero rows.

    Returns ``(rows_sorted (M, d + C + 1), ids (M,))``.
    """
    n, d = positions.shape
    c = values.shape[1]
    ids = edges.vertex
    rows = edges.rows
    if rows is not None:
        if rows.shape[1] != d + c + 1:
            raise ValueError(
                f"carried rows have {rows.shape[1]} columns, expected d + C + 1 = {d + c + 1}: "
                "the hierarchy was built with other point_feats than these values"
            )
        pos_rows, val_rows, w_rows = rows[:, :d], rows[:, d : d + c], rows[:, d + c]
    else:
        perm = edges.perm
        d1 = perm.shape[0] // n
        point_of = torch.div(perm, d1, rounding_mode="floor")
        if edges.weights is not None:
            rows_f = gather_rows(torch.cat([positions, values], dim=-1).contiguous(), point_of)
            pos_rows, val_rows, w_rows = rows_f[:, :d], rows_f[:, d:], edges.weights
        else:
            if splat_weights is None:
                raise ValueError("the build carried no rows: distribute_sorted needs splat_weights")
            feats = torch.cat([positions, values, splat_weights], dim=-1)
            rows_f = gather_rows(feats.contiguous(), point_of)
            pos_rows, val_rows, wcols = rows_f[:, :d], rows_f[:, d : d + c], rows_f[:, d + c :]
            corner = (perm % d1)[:, None] == torch.arange(d1, dtype=perm.dtype, device=perm.device)
            w_rows = torch.where(corner, wcols, 0.0).sum(1)
    if subtract_local_mean:
        mean_pos = seg_mean_sorted(pos_rows, edges, capacity)
        pos_rows = pos_rows - take_sorted(mean_pos, ids)
    out = torch.cat([pos_rows, val_rows, w_rows[:, None]], dim=-1)
    # carried rows are f32 (as the JAX build carries them); an f64 model's
    # values promote them, as JAX's next product does
    out = out.to(torch.promote_types(out.dtype, values.dtype))
    return torch.where((ids < capacity)[:, None], out, 0.0), ids


# ---------------------------------------------------------------------------
# segment helpers (fixed-size outputs; the JAX package's XLA scatters)
# ---------------------------------------------------------------------------


def _segment_slots(idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 slots with every id outside [0, num_segments) on the dropped
    slot ``num_segments``."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < num_segments), idx, num_segments)


def segment_sum(values: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Scatter-add the rows of (M, C) ``values`` into (num_segments, C);
    ids >= num_segments drop.  Over presorted edges, :func:`seg_sum_sorted`."""
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    return out.index_add(0, _segment_slots(idx, num_segments), values)[:num_segments]


def segment_mean(values: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    total = segment_sum(values, idx, num_segments)
    ones = values.new_ones((values.shape[0], 1))
    return total / torch.clamp(segment_sum(ones, idx, num_segments), min=1.0)


def segment_max_with_src(values: torch.Tensor, idx: torch.Tensor, num_segments: int):
    """Per-segment max of (M, C) values and, per (segment, channel), the row
    of its winner: ties go to the largest source row, as in JAX.

    Returns ``maxed`` (num_segments, C), 0 for empty segments, and
    ``argsrc`` (num_segments, C) int32, M for empty segments."""
    m, c = values.shape
    slots = _segment_slots(idx, num_segments)[:, None].expand(m, c)
    neg = torch.finfo(values.dtype).min
    maxed = values.new_full((num_segments + 1, c), neg).scatter_reduce(0, slots, values, "amax")
    maxed = maxed[:num_segments]
    gathered = maxed[idx.to(torch.int64).clamp(0, num_segments - 1)]
    is_winner = (values == gathered) & (slots < num_segments)
    rows = torch.arange(m, dtype=torch.int64, device=values.device)[:, None].expand(m, c)
    argsrc = torch.full((num_segments + 1, c), -1, dtype=torch.int64, device=values.device)
    argsrc = argsrc.scatter_reduce(0, slots, torch.where(is_winner, rows, -1), "amax")
    argsrc = argsrc[:num_segments]
    argsrc = torch.where(argsrc >= 0, argsrc, m).to(torch.int32)
    return torch.where(maxed > neg, maxed, 0.0), argsrc


# ---------------------------------------------------------------------------
# gathers and the im2row convolution
# ---------------------------------------------------------------------------


_FAST_OPS_ROUTE_SAID = []


def _fast_ops() -> bool:
    """False under ``LNT_FAST_OPS=0`` (read at each call): the gathers and the
    fused GroupNorm then take their plain route on every device, and the
    first call says so."""
    if os.environ.get("LNT_FAST_OPS") != "0":
        return True
    if not _FAST_OPS_ROUTE_SAID:
        _FAST_OPS_ROUTE_SAID.append(True)
        print("LNT_FAST_OPS=0: gather_rows, gather_neighbor_values, gather_rows_clustered and the modules' "
              "group_norm_act take their plain route", file=sys.stderr, flush=True)  # fmt: skip
    return False


def default_conv_dtype(device) -> torch.dtype:
    """The CLIs' conv dtype, JAX's policy (``_maybe_bf16``): ``LNT_CONV_DTYPE``
    "bf16" or "f32" when set; else bf16 where the fast ops run (on the card,
    or anywhere ``LNT_FAST_OPS`` is set and not "0"), f32 on the CPU or
    under ``LNT_FAST_OPS=0``."""
    conv_dt = os.environ.get("LNT_CONV_DTYPE", "")
    env = os.environ.get("LNT_FAST_OPS")
    fast = torch.device(device).type == "cuda" if env is None else env != "0"
    if conv_dt == "bf16" or (conv_dt != "f32" and fast):
        return torch.bfloat16
    return torch.float32


def gather_neighbor_values(
    values: torch.Tensor, neighbors: torch.Tensor, include_center_self: bool, plain=False, row0: int = 0
) -> torch.Tensor:
    """(capacity_query, K(+1), C) patch tensor of a 1-hop convolution:
    missing neighbours (id == capacity) give zero rows; same-level convs
    append the query row itself (``row0`` is the table row of the first
    query, for a row block).  Kernel K1 on the card; differentiable, with
    K1-bwd as the adjoint."""
    plain = plain or not _fast_ops()
    return patch_gather(values, neighbors, include_center_self, plain=plain, row0=row0)


def gather_rows_clustered(values: torch.Tensor, idx2: torch.Tensor, plain=False) -> torch.Tensor:
    """(cap, C) x (N, K) -> (N, K, C) with zeros for idx >= cap (the head's
    per-point gather).  Kernel K1 with no centre column."""
    return gather_neighbor_values(values, idx2, False, plain=plain)


def gather_rows(values: torch.Tensor, idx: torch.Tensor, plain=False) -> torch.Tensor:
    """(cap, C) x (...,) int32 -> (..., C); ids clamped to the last row.
    Kernel K4 on the card; differentiable, with an f32 scatter-add at the
    clamped ids as the adjoint."""
    out = take_rows(values, idx.reshape(-1).contiguous(), plain=plain or not _fast_ops())
    return out.reshape(idx.shape + values.shape[1:])


class _GatherSegBwd(torch.autograd.Function):
    """The head gather with the edge-sort adjoint (the JAX
    ``_gather_segbwd``): the cotangent rows, taken in the edge sort's order,
    are summed over each vertex's run instead of scattered.  Rows of
    invalid vertices sort past every run and drop out of the sum."""

    @staticmethod
    def forward(ctx, values, idx2, edges, plain):
        ctx.save_for_backward(idx2)
        ctx.meta = (edges, values.shape[0], values.dtype, plain)
        out = gather_rows(values, idx2, plain=plain)
        return torch.where((idx2 < values.shape[0])[..., None], out, 0.0)

    @staticmethod
    def backward(ctx, g):
        (idx2,) = ctx.saved_tensors
        edges, cap, dtype, plain = ctx.meta
        m = idx2.numel()
        g_rows = g.reshape(m, g.shape[-1]).to(torch.float32)
        g_sorted = g_rows.index_select(0, edges.perm.to(torch.int64))
        return seg_sum_sorted(g_sorted, edges, cap, plain=plain).to(dtype), None, None, None


def gather_rows_clustered_segbwd(values: torch.Tensor, idx2: torch.Tensor, edges, plain=False):
    """:func:`gather_rows_clustered` with its adjoint computed through the
    build's edge sort (the JAX package's opt-in ``LNT_HEAD_SEGVJP=1``
    head).  Forward: K4, then zeros where ``idx2 >= cap``, the same values
    as :func:`gather_rows_clustered`.  Backward: the f32 cotangent rows in
    ``edges.perm`` order, summed over the runs of ``edges`` (K3 for C > 8)
    and cast to the values' dtype; deterministic, where K1-bwd's atomics
    are not."""
    return _GatherSegBwd.apply(values, idx2, edges, plain)


def _maybe_bf16(values: torch.Tensor, conv_dtype: torch.dtype) -> torch.Tensor:
    """bf16 where the convs run in bf16 (the JAX package's policy: bf16 on
    the accelerator unless LNT_CONV_DTYPE=f32); otherwise unchanged."""
    return values.to(torch.bfloat16) if conv_dtype == torch.bfloat16 else values


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 (or wider) result, like the JAX dot with
    ``preferred_element_type=result_type(dtype, f32)``.  f32 or f64 inputs:
    a plain product (PyTorch keeps TF32 off for matmuls unless asked).  bf16
    inputs on the card: ``torch.mm(..., out_dtype=torch.float32)``, bf16
    operands with f32 accumulation and output.  bf16 on the CPU, which has no
    such kernel: an f32 product of the bf16 values."""
    if a.dtype != torch.bfloat16:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _swap_pm_perm(k: int) -> list:
    """Slot permutation exchanging each +/- move pair; a trailing odd slot
    (the centre of cross-level tables, or the appended centre of same-level
    patches) stays in place."""
    sw = list(range(k))
    for a in range(0, k - k % 2, 2):
        sw[a], sw[a + 1] = a + 1, a
    return sw


def _flip_filter_bank(weight: torch.Tensor, extent: int, c_in: int, c_out: int) -> torch.Tensor:
    """(extent * C_in, C_out) filter bank -> the adjoint bank (extent * C_out,
    C_in): the per-slot blocks of the opposite-sign slot, each transposed
    (the reference's flip-neighbours trick); the centre block self-pairs."""
    w = weight.reshape(extent, c_in, c_out)[_swap_pm_perm(extent)]
    return w.transpose(1, 2).reshape(extent * c_out, c_in)


def _conv_patch_budget_bytes() -> int:
    """Bytes the (Cq, extent, C) patch of one conv may take before the conv
    runs in row blocks (``LNT_CONV_CHUNK_BYTES``, default 1 GiB, the JAX
    package's knob)."""
    return int(os.environ.get("LNT_CONV_CHUNK_BYTES", 1 << 30))


def _conv_row_blocks(cq: int, extent: int, c_in: int, itemsize: int) -> int:
    """Number of row blocks that keep each block's patch under the budget:
    1 for every KITTI capacity; ScanNet's 5M-row tables would otherwise
    gather patches of several GB (5M x 9 x 128 bf16 is 11.5 GB)."""
    rows_max = max(1, _conv_patch_budget_bytes() // (extent * c_in * itemsize))
    return 1 if cq <= rows_max else -(-cq // rows_max)


def _row_blocks(cq: int, nb: int):
    """(start, stop) of ``nb`` row blocks of ceil(cq / nb) rows, the last one
    shorter."""
    b = -(-cq // nb)
    return [(r0, min(r0 + b, cq)) for r0 in range(0, cq, b)]


def _conv_fwd(values, neighbors, weight, same_level, conv_dtype, plain):
    """Patch gather (K1) and one GEMM with an f32 result; values and weights
    cast to ``conv_dtype`` first.

    Where the patch would pass :func:`_conv_patch_budget_bytes` (the block
    count uses the conv dtype's item size, as JAX's does), the query rows
    run in blocks, each with its own K1 launch (its centre column the
    block's own rows) and its own GEMM; a block's GEMM gives the same rows
    as the whole one."""
    values = values.to(conv_dtype).contiguous()
    weight = weight.to(conv_dtype)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = values.shape[1]
    if weight.shape[0] != extent * c_in:
        raise ValueError(f"filter bank rows {weight.shape[0]} != extent*C_in {extent * c_in}")
    nb = _conv_row_blocks(cq, extent, c_in, values.element_size())
    if nb == 1:
        patch = gather_neighbor_values(values, neighbors, same_level, plain=plain)
        return _mm_f32(patch.reshape(cq, extent * c_in), weight)
    out = torch.empty((cq, weight.shape[1]), dtype=torch.promote_types(conv_dtype, torch.float32),
                      device=values.device)  # fmt: skip
    for r0, r1 in _row_blocks(cq, nb):
        patch = gather_neighbor_values(values, neighbors[r0:r1], same_level, plain=plain, row0=r0)
        out[r0:r1] = _mm_f32(patch.reshape(r1 - r0, extent * c_in), weight)
    return out


def _conv_weight_grad(values, neighbors, g, same_level, conv_dtype, plain):
    """d_w = patchᵀ @ g with the patch recomputed by K1, in row blocks by
    the forward's rule (the blocks' products summed in f32)."""
    v = values.to(conv_dtype).contiguous()
    gq = g.to(conv_dtype)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = v.shape[1]
    nb = _conv_row_blocks(cq, extent, c_in, v.element_size())
    d_w = 0
    for r0, r1 in _row_blocks(cq, nb):
        patch = gather_neighbor_values(v, neighbors[r0:r1], same_level, plain=plain, row0=r0)
        d_w = d_w + _mm_f32(patch.reshape(r1 - r0, extent * c_in).t(), gq[r0:r1])
    return d_w


class _ConvFlip(torch.autograd.Function):
    """The im2row conv with the flip-neighbours adjoint (the JAX
    ``_conv_flip``): the weight gradient recomputes the patch, and the value
    gradient is one more conv of the cotangent over the paired table with
    the flipped bank.  Both run the forward gather K1."""

    @staticmethod
    def forward(ctx, values, weight, neighbors, neighbors_t, same_level, conv_dtype, plain):
        ctx.save_for_backward(values, weight, neighbors, neighbors_t)
        ctx.opts = (same_level, conv_dtype, plain)
        return _conv_fwd(values, neighbors, weight, same_level, conv_dtype, plain)

    @staticmethod
    def backward(ctx, g):
        values, weight, neighbors, neighbors_t = ctx.saved_tensors
        same_level, conv_dtype, plain = ctx.opts
        k = neighbors.shape[1]
        extent = k + 1 if same_level else k
        c_in, c_out = values.shape[1], weight.shape[1]
        d_values = d_weight = None
        if ctx.needs_input_grad[1]:
            # d_w = patchᵀ @ g with the patch recomputed, g in the conv dtype
            d_weight = _conv_weight_grad(values, neighbors, g, same_level, conv_dtype, plain)
            d_weight = d_weight.to(weight.dtype)
        if ctx.needs_input_grad[0]:
            wf = _flip_filter_bank(weight, extent, c_in, c_out)
            g_v = g.to(values.dtype)
            d_values = _conv_fwd(g_v, neighbors_t, wf, same_level, conv_dtype, plain)
            d_values = d_values.to(values.dtype)
        return d_values, d_weight, None, None, None, None, None


class _ConvScatter(torch.autograd.Function):
    """The im2row conv of a cross-level table without its paired table, with
    the plain adjoint (the JAX package's AD of the gather and the GEMM): the
    weight gradient as in :class:`_ConvFlip`; the value gradient is the
    patch cotangent ``g @ wᵀ`` (f32, or f64 for f64 convs), scattered back
    by K1-bwd (``patch_scatter``), each row block's in turn."""

    @staticmethod
    def forward(ctx, values, weight, neighbors, conv_dtype, plain):
        ctx.save_for_backward(values, weight, neighbors)
        ctx.opts = (conv_dtype, plain)
        return _conv_fwd(values, neighbors, weight, False, conv_dtype, plain)

    @staticmethod
    def backward(ctx, g):
        values, weight, neighbors = ctx.saved_tensors
        conv_dtype, plain = ctx.opts
        d_values = d_weight = None
        if ctx.needs_input_grad[1]:
            d_weight = _conv_weight_grad(values, neighbors, g, False, conv_dtype, plain)
            d_weight = d_weight.to(weight.dtype)
        if ctx.needs_input_grad[0]:
            scatter = k1_patch.patch_scatter_plain if plain or not _fast_ops() else k1_patch.patch_scatter
            cq, k = neighbors.shape
            c_in, cap = values.shape[1], values.shape[0]
            gq, wt = g.to(conv_dtype), weight.to(conv_dtype).t()
            nb = _conv_row_blocks(cq, k, c_in, values.to(conv_dtype).element_size())
            d_values = None
            for r0, r1 in _row_blocks(cq, nb):
                g_patch = _mm_f32(gq[r0:r1], wt).reshape(r1 - r0, k, c_in)
                rows = neighbors if nb == 1 else neighbors[r0:r1].contiguous()
                part = scatter(g_patch.contiguous(), rows, cap, False)
                d_values = part if d_values is None else d_values + part
            d_values = d_values.to(values.dtype)
        return d_values, d_weight, None, None, None


def conv_im2row(
    values: torch.Tensor,
    neighbors: torch.Tensor,
    weight: torch.Tensor,
    same_level: bool,
    conv_dtype: torch.dtype = torch.float32,
    plain=False,
    neighbors_t: torch.Tensor | None = None,
) -> torch.Tensor:
    """1-hop lattice convolution: patch gather, then one GEMM.

    ``weight`` is the (extent * C_in, C_out) filter bank in the reference's
    row layout [axis0+, axis0-, ..., centre].  Values and weights are cast to
    ``conv_dtype`` (the JAX package uses bf16 off the CPU); the result is
    f32.

    Backward (the JAX ``_conv_flip``): the adjoint in ``values`` is another
    1-hop conv of the cotangent over ``neighbors_t``, the +/- swapped table,
    with the flipped filter bank.  A same-level table is its own pair.  A
    cross-level conv without its paired table (coarsen <-> finefy: a
    ``GnReluCoarsen`` given no ``finefy_table``) has no flip and takes the
    plain adjoint instead (:class:`_ConvScatter`: K1-bwd).  The value
    gradient is cast to ``values``' dtype, the weight gradient to
    ``weight``'s."""
    if same_level and neighbors_t is None:
        neighbors_t = neighbors
    if neighbors_t is None:
        return _ConvScatter.apply(values, weight, neighbors, conv_dtype, plain)
    return _ConvFlip.apply(values, weight, neighbors, neighbors_t, same_level, conv_dtype, plain)


# ---------------------------------------------------------------------------
# the lattice library off the model's path (splat, slice, blur, ...)
# ---------------------------------------------------------------------------


def splat(values: torch.Tensor, splat_idx: torch.Tensor, splat_weights: torch.Tensor, capacity: int):
    """(N, C) point values -> (capacity, C) vertex values: the barycentric
    scatter, one segment sum over the (point, vertex) edges."""
    n, d1 = splat_idx.shape
    weighted = values[:, None, :] * splat_weights[..., None]
    return segment_sum(weighted.reshape(n * d1, -1), splat_idx.reshape(n * d1), capacity)


def distribute(
    positions: torch.Tensor,
    values: torch.Tensor,
    splat_idx: torch.Tensor,
    splat_weights: torch.Tensor,
    capacity: int,
    point_mask: torch.Tensor | None = None,
    subtract_local_mean: bool = True,
):
    """Per-(point, vertex) rows [xyz - vertex-mean xyz, values, weight] in
    edge order (point-major), without the build's edge sort; the vertex
    means' row gather is K4 on the card.  Invalid edges get all-zero rows.

    Returns ``(rows (N*(d+1), d + C + 1), edge_idx (N*(d+1),))``."""
    n, d = positions.shape
    d1 = splat_idx.shape[1]
    edge_idx = splat_idx.reshape(n * d1)
    if point_mask is not None:
        edge_idx = torch.where(point_mask.repeat_interleave(d1), edge_idx, capacity)
    pos_rows = positions.repeat_interleave(d1, dim=0)
    if subtract_local_mean:
        mean_pos = segment_mean(pos_rows, edge_idx, capacity)
        pos_rows = pos_rows - gather_rows(mean_pos.contiguous(), edge_idx.to(torch.int32))
    val_rows = values.repeat_interleave(d1, dim=0)
    rows = torch.cat([pos_rows, val_rows, splat_weights.reshape(n * d1, 1)], dim=-1)
    return torch.where((edge_idx < capacity)[:, None], rows, 0.0), edge_idx


def expand(
    positions: torch.Tensor,
    sigma,
    capacity: int,
    point_multiplier: int,
    noise_stddev: float,
    generator: torch.Generator,
    values: torch.Tensor | None = None,
    point_mask: torch.Tensor | None = None,
):
    """A structure over the positions and ``point_multiplier`` noisy copies
    of them (gaussian noise of ``noise_stddev`` drawn from ``generator``),
    which creates vertices around the cloud.

    Returns ``(structure, splat_idx, splat_weights)`` over the expanded
    points, and with ``values`` their vertex values: the points' values
    splatted, the copies contributing zero."""
    n, d = positions.shape
    reps = positions.repeat(point_multiplier, 1)
    noise = torch.randn(reps.shape, generator=generator, dtype=reps.dtype, device=reps.device)
    expanded = torch.cat([positions, reps + noise_stddev * noise])
    mask = None if point_mask is None else torch.cat([point_mask, point_mask.repeat(point_multiplier)])
    s, vid, w, _ = st.build_structure(expanded, sigma, capacity, point_mask=mask, need_point_maps=True)
    if values is None:
        return s, vid, w
    pad = values.new_zeros((n * point_multiplier, values.shape[1]))
    return s, vid, w, splat(torch.cat([values, pad]), vid, w, capacity)


def create_splatting_mask(
    generator: torch.Generator,
    splat_idx: torch.Tensor,
    max_nr_points: int,
    capacity: int,
    counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, d+1) bool: each valid edge kept with probability ``min(1,
    max_nr_points / count)`` of its vertex's edge count (uniforms drawn from
    ``generator``), so each vertex keeps about ``max_nr_points``
    contributions in expectation; invalid edges are False.  ``counts``
    (capacity,) may give the counts."""
    n, d1 = splat_idx.shape
    flat = splat_idx.reshape(-1)
    if counts is None:
        ones = torch.ones((n * d1, 1), dtype=torch.float32, device=flat.device)
        counts = segment_sum(ones, flat, capacity)[:, 0]
    per_edge = counts[flat.to(torch.int64).clamp(0, capacity - 1)]
    keep_p = torch.clamp(max_nr_points / torch.clamp(per_edge, min=1.0), max=1.0)
    u = torch.rand((n * d1,), generator=generator, device=flat.device)
    return ((u < keep_p) & (flat < capacity)).reshape(n, d1)


def slice_lattice(
    values: torch.Tensor,
    splat_idx: torch.Tensor,
    splat_weights: torch.Tensor,
    conv_dtype: torch.dtype = torch.float32,
    plain=False,
) -> torch.Tensor:
    """Barycentric interpolation of (capacity, C) vertex values back to the
    points: ``out_p = sum_r w_pr * values[idx_pr]``, missing vertices
    contributing zero.  The gather is K1 with no centre column (bf16 where
    the convs run in bf16, as JAX's on the TPU)."""
    capacity = values.shape[0]
    v = gather_rows_clustered(_maybe_bf16(values, conv_dtype).contiguous(), splat_idx, plain=plain)
    w = torch.where(splat_idx < capacity, splat_weights, 0.0)
    return (v * w[..., None]).sum(1)


def gather_lattice(
    values: torch.Tensor,
    splat_idx: torch.Tensor,
    splat_weights: torch.Tensor,
    conv_dtype: torch.dtype = torch.float32,
    plain=False,
) -> torch.Tensor:
    """Per point, the (d+1) blocks [value * w, w] of its simplex vertices:
    (N, (d+1) * (C+1)).  The gather is K1 with no centre column."""
    capacity, c = values.shape
    n, d1 = splat_idx.shape
    v = gather_rows_clustered(_maybe_bf16(values, conv_dtype).contiguous(), splat_idx, plain=plain)
    w = torch.where(splat_idx < capacity, splat_weights, 0.0)
    return torch.cat([v * w[..., None], w[..., None]], dim=-1).reshape(n, d1 * (c + 1))


def blur(values: torch.Tensor, neighbors_same: torch.Tensor, axis: int, plain=False) -> torch.Tensor:
    """One permutohedral blur pass along lattice axis ``axis`` (0..d):
    ``0.25 * values[n+] + 0.5 * values[v] + 0.25 * values[n-]`` with the
    axis' '+' and '-' neighbours of the same-level table (slots 2a, 2a+1),
    missing neighbours contributing zero.  The gather is K1."""
    k = neighbors_same.shape[1]
    if not 0 <= 2 * axis < k:
        raise ValueError(f"axis {axis} out of range for extent {k}")
    cols = neighbors_same[:, 2 * axis : 2 * axis + 2].contiguous()
    patch = gather_neighbor_values(values.contiguous(), cols, False, plain=plain)
    return 0.25 * (patch[:, 0] + patch[:, 1]) + 0.5 * values[: cols.shape[0]]


def bilateral_blur(values: torch.Tensor, neighbors_same: torch.Tensor, plain=False) -> torch.Tensor:
    """The separable permutohedral blur of the bilateral filter: one
    :func:`blur` pass per lattice axis, in axis order."""
    for a in range(neighbors_same.shape[1] // 2):
        values = blur(values, neighbors_same, a, plain=plain)
    return values


def depthwise_conv(
    values: torch.Tensor, neighbors: torch.Tensor, weight: torch.Tensor, same_level: bool = True,
    plain=False,
) -> torch.Tensor:  # fmt: skip
    """Depthwise 1-hop lattice conv, ``out[v, c] = sum_k patch[v, k, c] *
    weight[k, c]``; the patch is K1 (the centre column appended for a
    same-level table)."""
    patch = gather_neighbor_values(values.contiguous(), neighbors, same_level, plain=plain)
    return torch.einsum("vkc,kc->vc", patch, weight)
