"""The plain versions of the two kernels the reference's path reaches,
copied from the port's ``ops_cuda/`` wrappers with the adjoints it takes:
the patch gather (K1; the head's gather differentiates through K1-bwd, a
conv's through its own flip-neighbours adjoint) and the segmented max with
its carry (K2, its adjoint K2-bwd).  Every call here is plain PyTorch on
any device.
"""

from __future__ import annotations

import torch


def patch_gather_plain(
    values: torch.Tensor, neighbors: torch.Tensor, include_center: bool, row0: int = 0
) -> torch.Tensor:
    """(cap_src, C) x (Q, K) -> (Q, K(+1), C): a masked ``index_select``.

    Ids outside [0, cap_src) read zero rows; with ``include_center`` the
    query's own row ``values[row0 + q]`` is appended as the last column
    (``row0`` > 0 for a row block of a larger query table)."""
    cap = values.shape[0]
    q, k = neighbors.shape
    valid = (neighbors >= 0) & (neighbors < cap)
    idx = torch.where(valid, neighbors, 0).to(torch.int64).reshape(-1)
    patch = values.index_select(0, idx).reshape(q, k, values.shape[1])
    patch = patch.masked_fill(~valid[..., None], 0)
    if include_center:
        patch = torch.cat([patch, values[row0 : row0 + q, None, :]], dim=1)
    return patch


def patch_scatter_plain(g: torch.Tensor, neighbors: torch.Tensor, cap: int) -> torch.Tensor:
    """Adjoint of :func:`patch_gather_plain` without the centre column: (Q,
    K, C) cotangents -> (cap, C) f32, one ``index_add_`` into a (cap + 1, C)
    table whose last row takes every id outside [0, cap) and is dropped."""
    q, k = neighbors.shape
    c = g.shape[-1]
    g = g.to(torch.float32)
    valid = (neighbors >= 0) & (neighbors < cap)
    idx = torch.where(valid, neighbors, cap).to(torch.int64).reshape(-1)
    out = torch.zeros((cap + 1, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, idx, g.reshape(q * k, c))
    return out[:cap]


def seg_max_carry_plain(
    vals: torch.Tensor, carry: torch.Tensor, ids: torch.Tensor, run_end: torch.Tensor
):
    """Per-vertex, per-channel max of (M, C) sorted values and the carry of
    the latest winning edge; empty rows give 0.

    The XLA formulation of the JAX ``seg_max_sorted``: scatter-max, winner
    match, scatter-max of winner positions, carry gather.  Reads the vertex
    ids (invalid = cap); ``run_end`` only gives the capacity."""
    cap = run_end.shape[0]
    m, c = vals.shape
    idx = ids.to(torch.int64).clamp(max=cap)[:, None].expand(m, c)
    maxed = torch.zeros((cap + 1, c), dtype=vals.dtype, device=vals.device)
    maxed = maxed.scatter_reduce(0, idx, vals, "amax", include_self=False)
    is_win = (vals == maxed.gather(0, idx)) & (ids < cap)[:, None]
    row_pos = torch.arange(m, device=vals.device)[:, None].expand(m, c)
    argpos = torch.full((cap + 1, c), -1, dtype=torch.int64, device=vals.device)
    argpos = argpos.scatter_reduce(0, idx, torch.where(is_win, row_pos, -1), "amax")[:cap]
    carry_out = torch.where(argpos >= 0, carry[argpos.clamp(min=0)], 0.0).to(vals.dtype)
    return maxed[:cap], carry_out


def seg_max_carry_bwd_plain(
    vals: torch.Tensor,
    ids: torch.Tensor,
    run_end: torch.Tensor,
    maxed: torch.Tensor,
    g_max: torch.Tensor,
    g_carry: torch.Tensor,
):
    """Adjoint of :func:`seg_max_carry_plain`: -> (d_vals (M, C), d_carry
    (M,)), f32.

    The XLA formulation of the JAX ``_seg_max_fast_bwd``: gather maxed,
    g_max and g_carry by vertex id, match winners, keep the latest winner of
    each (vertex, channel) by a scatter-max of winner positions.  d_vals is
    a selection of g_max; d_carry sums g_carry over the channels an edge
    wins.  Reads the vertex ids; ``run_end`` only gives the capacity."""
    cap = run_end.shape[0]
    m, c = vals.shape
    valid = (ids < cap)[:, None]
    idc = ids.to(torch.int64).clamp(max=cap - 1)
    rows = torch.cat([maxed, g_max, g_carry], dim=1).index_select(0, idc)
    gathered, gm, gc = rows.split(c, dim=1)
    is_win = (vals == gathered) & valid
    row_pos = torch.arange(m, device=vals.device)[:, None].expand(m, c)
    idx = ids.to(torch.int64).clamp(max=cap)[:, None].expand(m, c)
    argpos = torch.full((cap + 1, c), -1, dtype=torch.int64, device=vals.device)
    argpos = argpos.scatter_reduce(0, idx, torch.where(is_win, row_pos, -1), "amax")[:cap]
    winner = (argpos.index_select(0, idc) == row_pos) & is_win
    d_vals = torch.where(winner, gm, 0.0)
    d_carry = torch.where(winner, gc, 0.0).sum(dim=1)
    return d_vals, d_carry


class _RowsGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (values.shape[0], values.dtype)
        return patch_gather_plain(values, idx, False)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        cap, dtype = ctx.meta
        return patch_scatter_plain(g.contiguous(), idx, cap).to(dtype), None


def gather_rows_clustered(values, idx):
    """K1's plain version without the centre column, differentiable in
    ``values`` (its adjoint K1-bwd's): (cap, C) x (N, K) -> (N, K, C), zero
    rows for ids outside the table."""
    return _RowsGather.apply(values, idx)


class _SegMaxCarry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, carry, ids, run_end):
        maxed, carry_out = seg_max_carry_plain(vals, carry, ids, run_end)
        ctx.save_for_backward(vals, ids, run_end, maxed)
        return maxed, carry_out

    @staticmethod
    def backward(ctx, g_max, g_carry):
        vals, ids, run_end, maxed = ctx.saved_tensors
        d_vals, d_carry = seg_max_carry_bwd_plain(vals, ids, run_end, maxed, g_max.contiguous(), g_carry.contiguous())
        return d_vals, d_carry, None, None


def seg_max_carry(vals, carry, ids, run_end):
    """K2's plain version, differentiable in ``vals`` and ``carry`` (K2-bwd's)."""
    return _SegMaxCarry.apply(vals, carry, ids, run_end)
