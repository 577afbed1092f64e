"""Lattice operators of the reference's forward and backward: the f32
prefix-sum segment reductions over the level-0 edge sort, the distribute
of the build's carried rows, the head's gather and the im2row convolution
with its flip-neighbours adjoint, in row blocks where its patch would pass
1 GiB.  A frozen copy of the port's ``lattice/ops.py`` on its default path
(the path no environment switch changes), with every kernel replaced by
its plain version (``plain_kernels.py``) and every product in f32.  Index
conventions are the port's: invalid = capacity, every gather masks.
"""

from __future__ import annotations

import torch

from . import plain_kernels


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
    """Sum (M, C) rows, C <= 8 (positions), over each vertex's contiguous
    run, in the input's dtype: an f32 prefix sum (:func:`_cumsum_f32`) and
    run-boundary differences, the port's formulation for narrow rows."""
    if vals_sorted.shape[1] > 8:
        raise ValueError(f"seg_sum_sorted sums at most 8 channels here, got {vals_sorted.shape[1]}")
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


def seg_max_sorted(vals_sorted: torch.Tensor, carry_sorted: torch.Tensor, edges, capacity: int):
    """Per-vertex, per-channel max of (M, C) values and the carry of the
    winner (ties: latest sorted edge); both (cap, C), 0 for empty rows.
    Differentiable: the cotangents go to the winners."""
    run_end = edges.run_end
    if run_end.shape[0] != capacity:
        raise ValueError(f"edge runs cover {run_end.shape[0]} vertices, capacity is {capacity}")
    return plain_kernels.seg_max_carry(vals_sorted, carry_sorted, edges.vertex, run_end)


def distribute_sorted(positions: torch.Tensor, values: torch.Tensor, edges, capacity: int,
                      subtract_local_mean: bool = True):  # fmt: skip
    """Per-edge rows [xyz - vertex-mean xyz, values, weight] in sorted edge
    order ([xyz, values, weight] without ``subtract_local_mean``, the
    ablation modes'), from the rows the build carried (``EdgeSort.rows``,
    built with ``point_feats`` = these ``values``).  Invalid edges (padding,
    overflow) get vertex id ``capacity`` and zero rows.

    Returns ``(rows_sorted (M, d + C + 1), ids (M,))``.
    """
    d, c = positions.shape[1], values.shape[1]
    ids = edges.vertex
    rows = edges.rows
    if rows is None or rows.shape[1] != d + c + 1:
        raise ValueError("the hierarchy was built without these values as point_feats")
    pos_rows, val_rows, w_rows = rows[:, :d], rows[:, d : d + c], rows[:, d + c]
    if subtract_local_mean:
        mean_pos = seg_mean_sorted(pos_rows, edges, capacity)
        pos_rows = pos_rows - take_sorted(mean_pos, ids)
    out = torch.cat([pos_rows, val_rows, w_rows[:, None]], dim=-1)
    return torch.where((ids < capacity)[:, None], out, 0.0), ids


# ---------------------------------------------------------------------------
# gathers and the im2row convolution
# ---------------------------------------------------------------------------


def gather_neighbor_values(values: torch.Tensor, neighbors: torch.Tensor, include_center_self: bool,
                           row0: int = 0) -> torch.Tensor:  # fmt: skip
    """(capacity_query, K(+1), C) patch tensor of a 1-hop convolution:
    missing neighbours (id == capacity) give zero rows; same-level convs
    append the query row itself (``row0`` is the table row of the first
    query, for a row block).  Not differentiable: the conv has its own
    adjoint."""
    return plain_kernels.patch_gather_plain(values, neighbors, include_center_self, row0)


def gather_rows_clustered(values: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """(cap, C) x (N, K) -> (N, K, C) with zeros for idx >= cap (the head's
    per-point gather), differentiable."""
    return plain_kernels.gather_rows_clustered(values, idx2)


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


# bytes the (Cq, extent, C) patch of one conv may take before the conv runs
# in row blocks (the port's default budget)
CONV_PATCH_BYTES = 1 << 30


def _conv_row_blocks(cq: int, extent: int, c_in: int, itemsize: int) -> int:
    """Number of row blocks that keep each block's patch under the budget:
    1 for every KITTI capacity; ScanNet's 5M-row tables would otherwise
    gather patches of several GB (5M x 9 x 128 bf16 is 11.5 GB)."""
    rows_max = max(1, CONV_PATCH_BYTES // (extent * c_in * itemsize))
    return 1 if cq <= rows_max else -(-cq // rows_max)


def _row_blocks(cq: int, nb: int):
    """(start, stop) of ``nb`` row blocks of ceil(cq / nb) rows, the last one
    shorter."""
    b = -(-cq // nb)
    return [(r0, min(r0 + b, cq)) for r0 in range(0, cq, b)]


# The one departure from the port's code: ``operand`` rounds every conv
# operand (values, filter banks, cotangents) before its product; the
# identity for the reference, a per-tensor scaled float8 (e4m3) rounding for
# the control (``api.precision``).
OPERAND_ROUNDING: list = []


def operand(t: torch.Tensor) -> torch.Tensor:
    return OPERAND_ROUNDING[-1](t) if OPERAND_ROUNDING else t


def _conv_fwd(values, neighbors, weight, same_level):
    """Patch gather and one f32 GEMM.  Where the patch would pass
    ``CONV_PATCH_BYTES`` the query rows run in blocks, each with its own
    gather (its centre column the block's own rows) and its own GEMM; a
    block's GEMM gives the same rows as the whole one."""
    values = operand(values).contiguous()
    weight = operand(weight)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = values.shape[1]
    if weight.shape[0] != extent * c_in:
        raise ValueError(f"filter bank rows {weight.shape[0]} != extent*C_in {extent * c_in}")
    nb = _conv_row_blocks(cq, extent, c_in, values.element_size())
    if nb == 1:
        patch = gather_neighbor_values(values, neighbors, same_level)
        return torch.mm(patch.reshape(cq, extent * c_in), weight)
    out = torch.empty((cq, weight.shape[1]), dtype=values.dtype, device=values.device)
    for r0, r1 in _row_blocks(cq, nb):
        patch = gather_neighbor_values(values, neighbors[r0:r1], same_level, row0=r0)
        out[r0:r1] = torch.mm(patch.reshape(r1 - r0, extent * c_in), weight)
    return out


def _conv_weight_grad(values, neighbors, g, same_level):
    """d_w = patchᵀ @ g with the patch gathered again, in row blocks by the
    forward's rule (the blocks' products summed)."""
    v = operand(values).contiguous()
    gq = operand(g)
    cq, k = neighbors.shape
    extent = k + 1 if same_level else k
    c_in = v.shape[1]
    nb = _conv_row_blocks(cq, extent, c_in, v.element_size())
    d_w = 0
    for r0, r1 in _row_blocks(cq, nb):
        patch = gather_neighbor_values(v, neighbors[r0:r1], same_level, row0=r0)
        d_w = d_w + torch.mm(patch.reshape(r1 - r0, extent * c_in).t(), gq[r0:r1])
    return d_w


class _ConvFlip(torch.autograd.Function):
    """The im2row conv with the flip-neighbours adjoint: the weight gradient
    gathers the patch again, and the value gradient is one more conv of the
    cotangent over the paired table with the flipped bank."""

    @staticmethod
    def forward(ctx, values, weight, neighbors, neighbors_t, same_level):
        ctx.save_for_backward(values, weight, neighbors, neighbors_t)
        ctx.same_level = same_level
        return _conv_fwd(values, neighbors, weight, same_level)

    @staticmethod
    def backward(ctx, g):
        values, weight, neighbors, neighbors_t = ctx.saved_tensors
        same_level = ctx.same_level
        k = neighbors.shape[1]
        extent = k + 1 if same_level else k
        c_in, c_out = values.shape[1], weight.shape[1]
        d_values = d_weight = None
        if ctx.needs_input_grad[1]:
            d_weight = _conv_weight_grad(values, neighbors, g, same_level).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            wf = _flip_filter_bank(weight, extent, c_in, c_out)
            d_values = _conv_fwd(g.to(values.dtype), neighbors_t, wf, same_level).to(values.dtype)
        return d_values, d_weight, None, None, None


def conv_im2row(values: torch.Tensor, neighbors: torch.Tensor, weight: torch.Tensor, same_level: bool,
                neighbors_t: torch.Tensor | None = None) -> torch.Tensor:  # fmt: skip
    """1-hop lattice convolution in f32: patch gather, then one GEMM.

    ``weight`` is the (extent * C_in, C_out) filter bank in the row layout
    [axis0+, axis0-, ..., centre].  The adjoint in ``values`` is another
    1-hop conv of the cotangent over ``neighbors_t``, the +/- swapped table
    (a same-level table is its own pair; a cross-level conv needs its
    paired table), with the flipped filter bank."""
    if same_level and neighbors_t is None:
        neighbors_t = neighbors
    if neighbors_t is None:
        raise ValueError("a cross-level conv needs its paired table")
    return _ConvFlip.apply(values, weight, neighbors, neighbors_t, same_level)
