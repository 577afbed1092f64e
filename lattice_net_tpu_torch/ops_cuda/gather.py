"""Kernel K4, the clamped row gather.

:func:`take_rows` is differentiable.  Its forward launches
``csrc/take_rows.cu`` for CUDA tensors and runs :func:`take_rows_plain` for
CPU tensors; neither falls back from the kernel to the plain version.
``plain=True`` takes the plain version on any device (to hold the kernel
against it on the card).  ``take_rows.launches`` counts kernel launches.

The adjoint is the JAX ``_take_rows_bwd``: an f32 ``index_add_`` at the
clamped ids, cast to the values' dtype.  JAX computes it in XLA, outside
any Pallas kernel, and it is off the train step's path (the edge-sort head
adjoint sums its cotangents with K3), so it stays a library call on every
device and keeps K1-bwd's launch count to the head scatter it stands for.
"""

from __future__ import annotations

import ctypes

import torch

from lattice_net_tpu_torch.ops_cuda import _build


def take_rows_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(cap, C) x (m,) -> (m, C): ``values[min(idx, cap - 1)]``, an
    ``index_select`` (ids below 0 read row 0, as the kernel's)."""
    cap = values.shape[0]
    return values.index_select(0, idx.to(torch.int64).clamp(0, cap - 1))


def take_rows_bwd(g: torch.Tensor, idx: torch.Tensor, cap: int, dtype) -> torch.Tensor:
    """Adjoint of :func:`take_rows_plain`: (m, C) cotangents -> (cap, C),
    summed in f32 at the clamped ids (ids >= cap land on row cap - 1), cast
    to ``dtype``."""
    out = torch.zeros((cap, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx.to(torch.int64).clamp(0, cap - 1), g.to(torch.float32))
    return out.to(dtype)


def _lib():
    lib = _build.load("take_rows")
    fn = lib.lnt_take_rows
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _check(values: torch.Tensor, idx: torch.Tensor) -> None:
    if values.device != idx.device:
        raise ValueError(f"values on {values.device}, idx on {idx.device}")
    if values.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need (cap, C) values and (m,) ids, got {values.shape}, {idx.shape}")
    if values.shape[0] == 0:
        raise ValueError("take_rows needs a table with at least one row")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_rows needs contiguous values and idx")


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The K4 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if _build.device_type(values, "take_rows") == "cpu":
        return take_rows_plain(values, idx)
    _check(values, idx)
    out = torch.empty((idx.shape[0], values.shape[1]), dtype=values.dtype, device=values.device)
    fn = _lib()
    with torch.cuda.device(values.device):
        err = fn(
            values.data_ptr(),
            idx.data_ptr(),
            out.data_ptr(),
            idx.shape[0],
            values.shape[0],
            values.shape[1] * values.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "take_rows")
    take_rows.launches += 1
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, plain):
        ctx.save_for_backward(idx)
        ctx.meta = (values.shape[0], values.dtype)
        return take_rows_plain(values, idx) if plain else _take_rows(values, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        cap, dtype = ctx.meta
        return take_rows_bwd(g, idx, cap, dtype), None, None


def take_rows(values: torch.Tensor, idx: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """(cap, C) values of any dtype x (m,) int32 ids -> (m, C): the clamped
    row gather ``values[min(idx, cap - 1)]`` (callers mask by validity).

    Differentiable in ``values``: the adjoint is :func:`take_rows_bwd`."""
    return _TakeRows.apply(values, idx, plain)


take_rows.launches = 0
