"""Kernel K1: the im2row patch gather of every lattice conv and of the head.

:func:`patch_gather` launches ``csrc/patch_gather.cu`` for CUDA tensors and
runs :func:`patch_gather_plain` for CPU tensors; it never falls back from
one to the other.  ``patch_gather.launches`` counts kernel launches.
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


def _lib():
    lib = _build.load("patch_gather")
    fn = lib.lnt_patch_gather
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ctypes.c_int, ctypes.c_int, ll, ll, p]
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


def patch_gather(
    values: torch.Tensor, neighbors: torch.Tensor, include_center: bool
) -> torch.Tensor:
    """(cap_src, C) x (Q, K) int32 -> (Q, K(+1), C), the values' dtype."""
    if values.device.type == "cpu":
        return patch_gather_plain(values, neighbors, include_center)
    if values.device.type != "cuda":
        raise ValueError(f"patch_gather runs on CUDA or CPU tensors, got {values.device}")
    _check(values, neighbors, include_center)
    q, k = neighbors.shape
    out = torch.empty(
        (q, k + int(include_center), values.shape[1]), dtype=values.dtype, device=values.device
    )
    fn = _lib()
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


patch_gather.launches = 0
