"""Kernel K2: segmented max with the carry of the winner (PointNet max-pool).

:func:`seg_max_carry` launches ``csrc/seg_max.cu`` for CUDA tensors and runs
:func:`seg_max_carry_plain` for CPU tensors; it never falls back from one to
the other.  ``seg_max_carry.launches`` counts kernel launches.
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


def _lib():
    lib = _build.load("seg_max")
    fn = lib.lnt_seg_max_carry
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, p]
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


def seg_max_carry(
    vals: torch.Tensor, carry: torch.Tensor, ids: torch.Tensor, run_end: torch.Tensor
):
    """(M, C) f32 values and (M,) f32 carry over sorted edges -> (maxed,
    carry_of_winner), each (cap, C) f32, cap = ``run_end.shape[0]``.

    ``run_end`` is the nondecreasing last position of each vertex's run (the
    cummax of ``EdgeSort.ends``); the kernel reads the run bounds from it,
    the plain version reads ``ids``."""
    if vals.device.type == "cpu":
        return seg_max_carry_plain(vals, carry, ids, run_end)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_max_carry runs on CUDA or CPU tensors, got {vals.device}")
    _check(vals, carry, ids, run_end)
    cap, c = run_end.shape[0], vals.shape[1]
    out_max = torch.empty((cap, c), dtype=torch.float32, device=vals.device)
    out_carry = torch.empty_like(out_max)
    fn = _lib()
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


seg_max_carry.launches = 0
