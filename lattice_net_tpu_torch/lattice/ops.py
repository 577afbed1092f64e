"""Lattice operators of the serving path (forward only).

Counterpart of ``lattice_net_tpu/lattice/ops.py``: the sort-free segment
reductions over the level-0 edge sort, ``distribute_sorted``, the im2row
convolution and the head gather.  Index conventions are the reference's:
invalid = capacity, every gather masks.

Two operators run hand-written kernels on the card: ``seg_max_sorted``
(K2, ``ops_cuda.segment``) and the patch gathers of ``conv_im2row`` and
``gather_rows_clustered`` (K1, ``ops_cuda.patch``).  ``plain=True`` sends
them through the kernels' plain PyTorch versions on any device; it exists
to hold the kernels against those versions on the card.
"""

from __future__ import annotations

import torch

from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_gather_plain
from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

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

    Kernel K2 on the card; ``plain`` forces its plain version."""
    run_end = edges.run_end
    if run_end.shape[0] != capacity:
        raise ValueError(f"edge runs cover {run_end.shape[0]} vertices, capacity is {capacity}")
    fn = seg_max_carry_plain if plain else seg_max_carry
    return fn(vals_sorted, carry_sorted, edges.vertex, run_end)


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
    append the query row itself.  Kernel K1 on the card."""
    fn = patch_gather_plain if plain else patch_gather
    return fn(values, neighbors, include_center_self)


def gather_rows_clustered(values: torch.Tensor, idx2: torch.Tensor, plain=False) -> torch.Tensor:
    """(cap, C) x (N, K) -> (N, K, C) with zeros for idx >= cap (the head's
    per-point gather).  Kernel K1 with no centre column."""
    return gather_neighbor_values(values, idx2, False, plain=plain)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, like the JAX dot with
    ``preferred_element_type=f32``.  f32 inputs: a plain f32 product (PyTorch
    keeps TF32 off for matmuls unless asked).  bf16 inputs on the card:
    ``torch.mm(..., out_dtype=torch.float32)``, bf16 operands with f32
    accumulation and output.  bf16 on the CPU, which has no such kernel: an
    f32 product of the bf16 values."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def conv_im2row(
    values: torch.Tensor,
    neighbors: torch.Tensor,
    weight: torch.Tensor,
    same_level: bool,
    conv_dtype: torch.dtype = torch.float32,
    plain=False,
) -> torch.Tensor:
    """1-hop lattice convolution, forward: patch gather, then one GEMM.

    ``weight`` is the (extent * C_in, C_out) filter bank in the reference's
    row layout [axis0+, axis0-, ..., centre].  Values and weights are cast to
    ``conv_dtype`` (the JAX package uses bf16 off the CPU); the result is
    f32."""
    values = values.to(conv_dtype)
    weight = weight.to(conv_dtype)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = values.shape[1]
    if weight.shape[0] != extent * c_in:
        raise ValueError(f"filter bank rows {weight.shape[0]} != extent*C_in {extent * c_in}")
    patch = gather_neighbor_values(values, neighbors, same_level, plain=plain)
    return _mm_f32(patch.reshape(cq, extent * c_in), weight)
