"""Kernel K2, the segmented max with the carry of the winner (PointNet
max-pool), and its adjoint K2-bwd; kernel K3, the segmented sum, and its
adjoint, the masked broadcast.

:func:`seg_max_carry` is differentiable.  Its forward launches
``csrc/seg_max.cu`` for CUDA tensors and runs :func:`seg_max_carry_plain`
for CPU tensors; its backward is :func:`seg_max_carry_bwd`, which launches
``csrc/seg_max_bwd.cu`` for CUDA tensors and runs
:func:`seg_max_carry_bwd_plain` for CPU tensors.

:func:`seg_sum_sorted_fast` and :func:`seg_broadcast_sorted` are each
other's adjoints, as the JAX ``custom_vjp`` pair is.  The sum launches
``csrc/seg_sum.cu`` for CUDA tensors and runs :func:`seg_sum_sorted_plain`
for CPU tensors; the broadcast is a masked take on every device (JAX has no
kernel for it either).

No wrapper falls back from a kernel to its plain version.  ``plain=True``
takes the plain versions on any device.  ``seg_max_carry.launches``,
``seg_max_carry_bwd.launches`` and ``seg_sum_sorted_fast.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lattice_net_tpu_torch.ops_cuda import _build


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


def _fwd_lib():
    lib = _build.load("seg_max")
    fn = lib.lnt_seg_max_carry
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("seg_max_bwd")
    fn = lib.lnt_seg_max_bwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check(vals, carry, ids, run_end) -> None:
    devs = {t.device for t in (vals, carry, ids, run_end)}
    if len(devs) != 1:
        raise ValueError(f"seg_max_carry inputs on several devices: {devs}")
    if vals.dim() != 2 or carry.shape != vals.shape[:1] or ids.shape != vals.shape[:1]:
        raise ValueError(
            f"need vals (M, C), carry (M,), ids (M,); got {vals.shape}, {carry.shape}, {ids.shape}"
        )
    if run_end.dim() != 1:
        raise ValueError(f"run_end must be 1-D, got {run_end.shape}")
    if vals.dtype != torch.float32 or carry.dtype != torch.float32:
        raise TypeError(f"seg_max_carry takes f32 vals and carry, got {vals.dtype}, {carry.dtype}")
    if run_end.dtype != torch.int32:
        raise TypeError(f"run_end must be int32, got {run_end.dtype}")
    if not all(t.is_contiguous() for t in (vals, carry, run_end)):
        raise ValueError("seg_max_carry needs contiguous vals, carry and run_end")


def _check_bwd(vals, run_end, maxed, g_max, g_carry) -> None:
    tables = (maxed, g_max, g_carry)
    devs = {t.device for t in (vals, run_end, *tables)}
    if len(devs) != 1:
        raise ValueError(f"seg_max_carry_bwd inputs on several devices: {devs}")
    want = (run_end.shape[0], vals.shape[1])
    if vals.dim() != 2 or run_end.dim() != 1 or any(t.shape != want for t in tables):
        raise ValueError(
            f"need vals (M, C), run_end (cap,) and three (cap, C) tables; got {vals.shape}, "
            f"{run_end.shape}, {[tuple(t.shape) for t in tables]}"
        )
    if any(t.dtype != torch.float32 for t in (vals, *tables)):
        raise TypeError("seg_max_carry_bwd takes f32 values, maxima and cotangents")
    if run_end.dtype != torch.int32:
        raise TypeError(f"run_end must be int32, got {run_end.dtype}")
    if not all(t.is_contiguous() for t in (vals, run_end, *tables)):
        raise ValueError("seg_max_carry_bwd needs contiguous inputs")


def _seg_max(vals, carry, ids, run_end):
    """The K2 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if _build.device_type(vals, "seg_max_carry") == "cpu":
        return seg_max_carry_plain(vals, carry, ids, run_end)
    _check(vals, carry, ids, run_end)
    cap, c = run_end.shape[0], vals.shape[1]
    out_max = torch.empty((cap, c), dtype=torch.float32, device=vals.device)
    out_carry = torch.empty_like(out_max)
    fn = _fwd_lib()
    with torch.cuda.device(vals.device):
        err = fn(
            vals.data_ptr(),
            carry.data_ptr(),
            run_end.data_ptr(),
            out_max.data_ptr(),
            out_carry.data_ptr(),
            cap,
            c,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "seg_max_carry")
    seg_max_carry.launches += 1
    return out_max, out_carry


def seg_max_carry_bwd(vals, ids, run_end, maxed, g_max, g_carry):
    """The K2-bwd wrapper: -> (d_vals (M, C), d_carry (M,)), f32.

    Plain version for CPU tensors, the kernel for CUDA tensors.  The kernel
    reads the run bounds from ``run_end`` (the plain version reads ``ids``);
    its d_vals equals the plain version's bit for bit, its d_carry up to
    the order of the sum over channels."""
    if _build.device_type(vals, "seg_max_carry_bwd") == "cpu":
        return seg_max_carry_bwd_plain(vals, ids, run_end, maxed, g_max, g_carry)
    _check_bwd(vals, run_end, maxed, g_max, g_carry)
    cap, c = maxed.shape
    d_vals = torch.zeros_like(vals)
    d_carry = torch.zeros(vals.shape[0], dtype=torch.float32, device=vals.device)
    fn = _bwd_lib()
    with torch.cuda.device(vals.device):
        err = fn(
            vals.data_ptr(),
            run_end.data_ptr(),
            maxed.data_ptr(),
            g_max.data_ptr(),
            g_carry.data_ptr(),
            d_vals.data_ptr(),
            d_carry.data_ptr(),
            cap,
            c,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "seg_max_carry_bwd")
    seg_max_carry_bwd.launches += 1
    return d_vals, d_carry


seg_max_carry_bwd.launches = 0


class _SegMaxCarry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, carry, ids, run_end, plain):
        fn = seg_max_carry_plain if plain else _seg_max
        maxed, carry_out = fn(vals, carry, ids, run_end)
        ctx.save_for_backward(vals, ids, run_end, maxed)
        ctx.plain = plain
        return maxed, carry_out

    @staticmethod
    def backward(ctx, g_max, g_carry):
        vals, ids, run_end, maxed = ctx.saved_tensors
        fn = seg_max_carry_bwd_plain if ctx.plain else seg_max_carry_bwd
        d_vals, d_carry = fn(
            vals, ids, run_end, maxed, g_max.contiguous(), g_carry.contiguous()
        )
        return d_vals, d_carry, None, None, None


def seg_max_carry(
    vals: torch.Tensor,
    carry: torch.Tensor,
    ids: torch.Tensor,
    run_end: torch.Tensor,
    plain: bool = False,
):
    """(M, C) f32 values and (M,) f32 carry over sorted edges -> (maxed,
    carry_of_winner), each (cap, C) f32, cap = ``run_end.shape[0]``.

    ``run_end`` is the nondecreasing last position of each vertex's run
    (``EdgeSort.run_end``); the kernels read the run bounds from it, the
    plain versions read ``ids``.  Differentiable in ``vals`` and ``carry``:
    the cotangents go to each (vertex, channel)'s latest winning edge
    (:func:`seg_max_carry_bwd`)."""
    return _SegMaxCarry.apply(vals, carry, ids, run_end, plain)


seg_max_carry.launches = 0


# ---------------------------------------------------------------------------
# K3: segmented sum over sorted dense runs, and its adjoint
# ---------------------------------------------------------------------------


def seg_sum_sorted_plain(vals: torch.Tensor, ids: torch.Tensor, cap: int) -> torch.Tensor:
    """(M, C) values over sorted vertex ids -> (cap, C) f32 run sums; ids >=
    cap drop and empty rows give 0.  One f32 ``index_add_`` into a (cap + 1,
    C) table whose last row takes the dropped ids.  Reads the vertex ids."""
    out = torch.zeros((cap + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    out.index_add_(0, ids.to(torch.int64).clamp(max=cap), vals.to(torch.float32))
    return out[:cap]


def seg_broadcast_sorted_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(cap, C) x (M,) -> (M, C) f32: ``table[ids]``, 0 where id >= cap (the
    JAX ``seg_broadcast_sorted_ref``)."""
    cap = table.shape[0]
    out = table.index_select(0, ids.to(torch.int64).clamp(max=cap - 1)).to(torch.float32)
    return torch.where((ids < cap)[:, None], out, 0.0)


def _seg_sum_lib():
    lib = _build.load("seg_sum")
    fn = lib.lnt_seg_sum
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check_sum(vals, run_end, cap) -> None:
    if vals.device != run_end.device:
        raise ValueError(f"vals on {vals.device}, run_end on {run_end.device}")
    if vals.dim() != 2 or run_end.shape != (cap,):
        raise ValueError(f"need vals (M, C) and run_end ({cap},); got {vals.shape}, {run_end.shape}")
    if vals.dtype != torch.float32:
        raise TypeError(f"seg_sum takes f32 values, got {vals.dtype}")
    if run_end.dtype != torch.int32:
        raise TypeError(f"run_end must be int32, got {run_end.dtype}")
    if not (vals.is_contiguous() and run_end.is_contiguous()):
        raise ValueError("seg_sum needs contiguous vals and run_end")


def _seg_sum(vals, ids, run_end, cap):
    """The K3 wrapper: plain version for CPU tensors, the kernel for CUDA.
    The kernel reads the run bounds from ``run_end``, the plain version the
    ids; the kernel sums each run in edge order without atomics."""
    if _build.device_type(vals, "seg_sum_sorted_fast") == "cpu":
        return seg_sum_sorted_plain(vals, ids, cap)
    vals = vals.to(torch.float32).contiguous()
    _check_sum(vals, run_end, cap)
    out = torch.empty((cap, vals.shape[1]), dtype=torch.float32, device=vals.device)
    fn = _seg_sum_lib()
    with torch.cuda.device(vals.device):
        err = fn(
            vals.data_ptr(),
            run_end.data_ptr(),
            out.data_ptr(),
            cap,
            vals.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "seg_sum_sorted_fast")
    seg_sum_sorted_fast.launches += 1
    return out


def _sum(vals, ids, run_end, cap, plain):
    return seg_sum_sorted_plain(vals, ids, cap) if plain else _seg_sum(vals, ids, run_end, cap)


class _SegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, ids, run_end, cap, plain):
        ctx.save_for_backward(ids)
        ctx.meta = (vals.dtype,)
        return _sum(vals, ids, run_end, cap, plain)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        (dtype,) = ctx.meta
        return seg_broadcast_sorted_plain(g, ids).to(dtype), None, None, None, None


class _SegBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, run_end, plain):
        ctx.save_for_backward(ids, run_end)
        ctx.meta = (table.shape[0], table.dtype, plain)
        return seg_broadcast_sorted_plain(table, ids)

    @staticmethod
    def backward(ctx, g):
        ids, run_end = ctx.saved_tensors
        cap, dtype, plain = ctx.meta
        return _sum(g.contiguous(), ids, run_end, cap, plain).to(dtype), None, None, None


def seg_sum_sorted_fast(
    vals: torch.Tensor, ids: torch.Tensor, run_end: torch.Tensor, cap: int, plain: bool = False
) -> torch.Tensor:
    """(M, C) values over sorted, dense vertex ids -> (cap, C) f32: out[v] =
    the sum of v's run; ids >= cap drop, empty rows give 0.

    ``run_end`` is ``EdgeSort.run_end`` (the kernel reads the run bounds
    from it, the plain version reads ``ids``).  Differentiable in ``vals``:
    the adjoint is :func:`seg_broadcast_sorted`'s forward, cast to the
    values' dtype."""
    return _SegSum.apply(vals, ids, run_end, cap, plain)


seg_sum_sorted_fast.launches = 0


def seg_broadcast_sorted(
    table: torch.Tensor, ids: torch.Tensor, run_end: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """(cap, C) x (M,) sorted ids -> (M, C) f32: ``table[ids]``, 0 where id
    >= cap.  Differentiable in ``table``: the adjoint is the segmented sum
    (K3 on the card, over the runs of ``run_end``), cast to the table's
    dtype."""
    return _SegBroadcast.apply(table, ids, run_end, plain)
