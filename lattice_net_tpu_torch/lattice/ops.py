"""Lattice operators of the serving and training paths.

Counterpart of ``lattice_net_tpu/lattice/ops.py``: the sort-free segment
reductions over the level-0 edge sort, ``distribute_sorted``, the im2row
convolution with its flip-neighbours adjoint, and the head gather.  Index
conventions are the reference's: invalid = capacity, every gather masks.

Two operators run hand-written kernels on the card: ``seg_max_sorted``
(K2 forward, K2-bwd backward, ``ops_cuda.segment``) and the patch gathers
of ``conv_im2row`` and ``gather_rows_clustered`` (K1 forward;
``gather_rows_clustered``'s backward is K1-bwd, ``ops_cuda.patch``, and the
conv's backward is two more K1 gathers).  ``plain=True`` sends them through
the kernels' plain PyTorch versions on any device; it exists to hold the
kernels against those versions on the card.
"""

from __future__ import annotations

import torch

from lattice_net_tpu_torch.ops_cuda.patch import patch_gather
from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry

__all__ = [
    "seg_sum_sorted",
    "seg_counts_sorted",
    "seg_mean_sorted",
    "take_sorted",
    "seg_max_sorted",
    "distribute_sorted",
    "gather_neighbor_values",
    "gather_rows_clustered",
    "conv_im2row",
]


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


def seg_sum_sorted(vals_sorted: torch.Tensor, edges, capacity: int) -> torch.Tensor:
    """Sum (M, C) rows over each vertex's contiguous run: f32 prefix sum
    (:func:`_cumsum_f32`) and run-boundary differences.  Only C <= 8 is
    served: wider sums are the reference's seg-sum kernel (K3), not yet
    ported."""
    if vals_sorted.shape[1] > 8:
        raise NotImplementedError("seg_sum_sorted with C > 8 needs kernel K3 (not yet ported)")
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


def distribute_sorted(positions: torch.Tensor, values: torch.Tensor, edges, capacity: int):
    """Per-edge rows [xyz - vertex-mean xyz, values, weight] in sorted edge order.

    Reads the rows the build carried (``EdgeSort.rows``, built with
    ``point_feats`` = these ``values``).  Invalid edges (padding, overflow)
    get vertex id ``capacity`` and zero rows.

    Returns ``(rows_sorted (M, d + C + 1), ids (M,))``.
    """
    n, d = positions.shape
    c = values.shape[1]
    ids = edges.vertex
    rows = edges.rows
    if rows is None or rows.shape[1] != d + c + 1:
        raise ValueError(
            "distribute_sorted needs the rows the build carries: build the hierarchy "
            f"with point_feats = these (N, {c}) values"
        )
    pos_rows, val_rows, w_rows = rows[:, :d], rows[:, d : d + c], rows[:, d + c]
    mean_pos = seg_mean_sorted(pos_rows, edges, capacity)
    pos_rows = pos_rows - take_sorted(mean_pos, ids)
    out = torch.cat([pos_rows, val_rows, w_rows[:, None]], dim=-1)
    return torch.where((ids < capacity)[:, None], out, 0.0), ids


# ---------------------------------------------------------------------------
# gathers and the im2row convolution
# ---------------------------------------------------------------------------


def gather_neighbor_values(
    values: torch.Tensor, neighbors: torch.Tensor, include_center_self: bool, plain=False
) -> torch.Tensor:
    """(capacity_query, K(+1), C) patch tensor of a 1-hop convolution:
    missing neighbours (id == capacity) give zero rows; same-level convs
    append the query row itself.  Kernel K1 on the card; differentiable,
    with K1-bwd as the adjoint."""
    return patch_gather(values, neighbors, include_center_self, plain=plain)


def gather_rows_clustered(values: torch.Tensor, idx2: torch.Tensor, plain=False) -> torch.Tensor:
    """(cap, C) x (N, K) -> (N, K, C) with zeros for idx >= cap (the head's
    per-point gather).  Kernel K1 with no centre column."""
    return gather_neighbor_values(values, idx2, False, plain=plain)


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


def _conv_fwd(values, neighbors, weight, same_level, conv_dtype, plain):
    """Patch gather (K1) and one GEMM with an f32 result; values and weights
    cast to ``conv_dtype`` first."""
    values = values.to(conv_dtype).contiguous()
    weight = weight.to(conv_dtype)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = values.shape[1]
    if weight.shape[0] != extent * c_in:
        raise ValueError(f"filter bank rows {weight.shape[0]} != extent*C_in {extent * c_in}")
    patch = gather_neighbor_values(values, neighbors, same_level, plain=plain)
    return _mm_f32(patch.reshape(cq, extent * c_in), weight)


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
            v = values.to(conv_dtype).contiguous()
            patch = gather_neighbor_values(v, neighbors, same_level, plain=plain)
            patch = patch.reshape(neighbors.shape[0], extent * c_in)
            d_weight = _mm_f32(patch.t(), g.to(conv_dtype)).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            wf = _flip_filter_bank(weight, extent, c_in, c_out)
            g_v = g.to(values.dtype)
            d_values = _conv_fwd(g_v, neighbors_t, wf, same_level, conv_dtype, plain)
            d_values = d_values.to(values.dtype)
        return d_values, d_weight, None, None, None, None, None


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
    with the flipped filter bank.  A same-level table is its own pair; a
    cross-level conv needs the paired table (coarsen <-> finefy) for its
    value gradient.  The value gradient is cast to ``values``' dtype, the
    weight gradient to ``weight``'s."""
    if same_level and neighbors_t is None:
        neighbors_t = neighbors
    if neighbors_t is None and values.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the value gradient of a cross-level conv needs its paired table "
            "(neighbors_t): coarsen <-> finefy"
        )
    return _ConvFlip.apply(values, weight, neighbors, neighbors_t, same_level, conv_dtype, plain)
