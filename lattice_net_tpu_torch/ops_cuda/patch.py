"""Kernel K1, the im2row patch gather, and its adjoint K1-bwd.

:func:`patch_gather` is differentiable.  Its forward launches
``csrc/patch_gather.cu`` for CUDA tensors and runs
:func:`patch_gather_plain` for CPU tensors; its backward is
:func:`patch_scatter`, which launches ``csrc/patch_scatter.cu`` for CUDA
tensors and runs :func:`patch_scatter_plain` for CPU tensors.  Neither falls
back from the kernel to the plain version.  ``plain=True`` takes the plain
versions on any device (to hold the kernels against them on the card).
``patch_gather.launches`` and ``patch_scatter.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from lattice_net_tpu_torch.ops_cuda import _build

_DTYPES = (torch.bfloat16, torch.float32)


def patch_gather_plain(
    values: torch.Tensor, neighbors: torch.Tensor, include_center: bool
) -> torch.Tensor:
    """(cap_src, C) x (Q, K) -> (Q, K(+1), C): a masked ``index_select``.

    Ids outside [0, cap_src) read zero rows; with ``include_center`` the
    query row ``values[q]`` is appended as the last column."""
    cap = values.shape[0]
    q, k = neighbors.shape
    valid = (neighbors >= 0) & (neighbors < cap)
    idx = torch.where(valid, neighbors, 0).to(torch.int64).reshape(-1)
    patch = values.index_select(0, idx).reshape(q, k, values.shape[1])
    patch = patch.masked_fill(~valid[..., None], 0)
    if include_center:
        patch = torch.cat([patch, values[:q, None, :]], dim=1)
    return patch


def patch_scatter_plain(
    g: torch.Tensor, neighbors: torch.Tensor, cap: int, include_center: bool
) -> torch.Tensor:
    """Adjoint of :func:`patch_gather_plain`: (Q, K(+1), C) cotangents ->
    (cap, C) f32, the JAX ``_patch_gather_bwd``.

    One ``index_add_`` into a (cap + 1, C) f32 table whose last row takes
    every id outside [0, cap) and is dropped; the centre column adds to the
    query's own row."""
    q, k = neighbors.shape
    c = g.shape[-1]
    g = g.to(torch.float32)
    valid = (neighbors >= 0) & (neighbors < cap)
    idx = torch.where(valid, neighbors, cap).to(torch.int64).reshape(-1)
    out = torch.zeros((cap + 1, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, g[:, :k, :].reshape(q * k, c))
    out = out[:cap]
    if include_center:
        out[:q] += g[:, k, :]
    return out


def _gather_lib():
    lib = _build.load("patch_gather")
    fn = lib.lnt_patch_gather
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ctypes.c_int, ctypes.c_int, ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _scatter_lib():
    lib = _build.load("patch_scatter")
    fn = lib.lnt_patch_scatter
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, ll, i, i, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(values: torch.Tensor, neighbors: torch.Tensor, include_center: bool) -> None:
    if values.device != neighbors.device:
        raise ValueError(f"values on {values.device}, neighbors on {neighbors.device}")
    if values.dim() != 2 or neighbors.dim() != 2:
        raise ValueError(f"need 2-D values and neighbors, got {values.shape}, {neighbors.shape}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"patch_gather takes bf16 or f32 values, got {values.dtype}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be int32, got {neighbors.dtype}")
    if not (values.is_contiguous() and neighbors.is_contiguous()):
        raise ValueError("patch_gather needs contiguous values and neighbors")
    if include_center and neighbors.shape[0] > values.shape[0]:
        raise ValueError("the centre column needs a query table no longer than the value table")


def _check_scatter(g: torch.Tensor, neighbors: torch.Tensor, cap: int, include_center: bool):
    if g.device != neighbors.device:
        raise ValueError(f"g on {g.device}, neighbors on {neighbors.device}")
    q, k = neighbors.shape
    if g.dim() != 3 or g.shape[:2] != (q, k + int(include_center)):
        raise ValueError(f"need g (Q, K(+1), C) for neighbors {tuple(neighbors.shape)}, got {g.shape}")
    if g.dtype != torch.float32:
        raise TypeError(f"patch_scatter takes f32 cotangents, got {g.dtype}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be int32, got {neighbors.dtype}")
    if not (g.is_contiguous() and neighbors.is_contiguous()):
        raise ValueError("patch_scatter needs contiguous g and neighbors")
    if include_center and q > cap:
        raise ValueError("the centre column needs a query table no longer than the value table")
    if g.numel() >= 2**31 or cap >= 2**31:
        raise ValueError(f"patch_scatter indexes g and its output in 32 bits, got {g.shape}, {cap}")
    if g.shape[2] % 4 == 0 and g.data_ptr() % 16:
        raise ValueError("patch_scatter: rows of C % 4 == 0 channels need a 16-byte-aligned g")


def _gather(values: torch.Tensor, neighbors: torch.Tensor, include_center: bool) -> torch.Tensor:
    """The K1 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if _build.device_type(values, "patch_gather") == "cpu":
        return patch_gather_plain(values, neighbors, include_center)
    _check(values, neighbors, include_center)
    q, k = neighbors.shape
    out = torch.empty(
        (q, k + int(include_center), values.shape[1]), dtype=values.dtype, device=values.device
    )
    fn = _gather_lib()
    with torch.cuda.device(values.device):
        err = fn(
            values.data_ptr(),
            neighbors.data_ptr(),
            out.data_ptr(),
            q,
            k,
            int(include_center),
            values.shape[0],
            values.shape[1] * values.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "patch_gather")
    patch_gather.launches += 1
    return out


def patch_scatter(
    g: torch.Tensor, neighbors: torch.Tensor, cap: int, include_center: bool
) -> torch.Tensor:
    """The K1-bwd wrapper: (Q, K(+1), C) f32 cotangents -> (cap, C) f32.

    Plain version for CPU tensors, the kernel for CUDA tensors.  The kernel
    zeroes its output itself (allocated uninitialised) and, for C % 4 == 0,
    adds each float4 of a cotangent row with one vector atomic (scalar f32
    atomics at other widths), so it equals the plain version up to the order
    of those sums, which changes from run to run."""
    if _build.device_type(g, "patch_scatter") == "cpu":
        return patch_scatter_plain(g, neighbors, cap, include_center)
    _check_scatter(g, neighbors, cap, include_center)
    q, k = neighbors.shape
    c = g.shape[2]
    out = torch.empty((cap, c), dtype=torch.float32, device=g.device)
    fn = _scatter_lib()
    with torch.cuda.device(g.device):
        err = fn(
            g.data_ptr(),
            neighbors.data_ptr(),
            out.data_ptr(),
            q,
            k,
            int(include_center),
            cap,
            c,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "patch_scatter")
    patch_scatter.launches += 1
    return out


patch_scatter.launches = 0


class _PatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, neighbors, include_center, plain):
        ctx.save_for_backward(neighbors)
        ctx.meta = (values.shape[0], values.dtype, include_center, plain)
        if plain:
            return patch_gather_plain(values, neighbors, include_center)
        return _gather(values, neighbors, include_center)

    @staticmethod
    def backward(ctx, g):
        (neighbors,) = ctx.saved_tensors
        cap, dtype, include_center, plain = ctx.meta
        fn = patch_scatter_plain if plain else patch_scatter
        d_values = fn(g.to(torch.float32).contiguous(), neighbors, cap, include_center)
        return d_values.to(dtype), None, None, None


def patch_gather(
    values: torch.Tensor, neighbors: torch.Tensor, include_center: bool, plain: bool = False
) -> torch.Tensor:
    """(cap_src, C) x (Q, K) int32 -> (Q, K(+1), C), the values' dtype.

    Differentiable in ``values``: the adjoint is :func:`patch_scatter`
    (K1-bwd on the card), cast back to the values' dtype."""
    return _PatchGather.apply(values, neighbors, include_center, plain)


patch_gather.launches = 0
