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
from typing import NamedTuple

import torch

from lattice_net_tpu_torch.ops_cuda import _build

_DTYPES = (torch.bfloat16, torch.float32)

# K1's launch plan (csrc/patch_gather.cu): 256-thread blocks; 16-byte rows
# in tiles of whole queries, two 16-byte chunks a thread a pass, other rows
# in staged tiles of about 30 KB of shared memory, within the H100's 227 KB
K1_BLOCK = 256
K1_TILE_CHUNKS = 2 * K1_BLOCK
K1_STAGE_BYTES = 30 * 1024
K1_SMEM_LIMIT = 232_448


class K1Plan(NamedTuple):
    """How K1 copies rows: ``word`` 16 takes 16-byte chunks, a block a tile
    of ``tile`` whole queries; 8, 4 or 2 stages a tile of ``tile`` patch
    rows in shared memory, read in words of that many bytes.  The block's
    dynamic shared memory is ``smem_bytes``: the tile's rows, then from
    byte ``ids_off`` the ids of the queries the tile touches."""

    word: int
    tile: int
    ids_off: int
    smem_bytes: int


def _queries_a_tile(chunks: int) -> int:
    """Queries a 16-byte tile takes, for ``chunks`` 16-byte chunks a query:
    for the fewest passes of the block over ``K1_TILE_CHUNKS`` chunks (up to
    four), the most queries that fit them, once they fill at least 80% of
    them; else the best fill (one query where a query needs more passes)."""
    best = (0.0, 1)
    for passes in range(1, 5):
        tq = passes * K1_TILE_CHUNKS // chunks
        if tq:
            fill = tq * chunks / (passes * K1_TILE_CHUNKS)
            if fill >= 0.8:
                return tq
            best = max(best, (fill, tq))
    return best[1]


def _plan(row_bytes: int, k: int, include_center: bool, align: int) -> K1Plan:
    """K1's layout for rows of ``row_bytes`` on a table whose address is a
    multiple of ``align`` (the output is always 16-byte aligned); raises
    ValueError for rows too wide for the block's shared memory."""
    kk = max(k + int(include_center), 1)
    if row_bytes % 16 == 0 and align % 16 == 0:
        return K1Plan(16, _queries_a_tile(kk * max(row_bytes // 16, 1)), 0, 0)
    word = next((w for w in (8, 4, 2) if row_bytes % w == 0 and align % w == 0), 0)
    if word == 0:
        raise ValueError(f"patch_gather: rows of {row_bytes} bytes at alignment {align}")
    tile = max(16, K1_STAGE_BYTES // row_bytes // 16 * 16)
    ids_off = -(-tile * row_bytes // 16) * 16
    smem = ids_off + (tile // kk + 2) * k * 4  # a tile's rows touch at most tile // kk + 2 queries
    if smem > K1_SMEM_LIMIT:
        raise ValueError(
            f"patch_gather: {smem} bytes of shared memory for rows of {row_bytes} bytes, K={k}"
        )
    return K1Plan(word, tile, ids_off, smem)


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


def patch_scatter_plain(
    g: torch.Tensor, neighbors: torch.Tensor, cap: int, include_center: bool
) -> torch.Tensor:
    """Adjoint of :func:`patch_gather_plain`: (Q, K(+1), C) cotangents ->
    (cap, C) f32 (f64 for f64 cotangents), the JAX ``_patch_gather_bwd``.

    One ``index_add_`` into a (cap + 1, C) table whose last row takes every
    id outside [0, cap) and is dropped; the centre column adds to the
    query's own row."""
    q, k = neighbors.shape
    c = g.shape[-1]
    g = g.to(torch.promote_types(g.dtype, torch.float32))
    valid = (neighbors >= 0) & (neighbors < cap)
    idx = torch.where(valid, neighbors, cap).to(torch.int64).reshape(-1)
    out = torch.zeros((cap + 1, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, idx, g[:, :k, :].reshape(q * k, c))
    out = out[:cap]
    if include_center:
        out[:q] += g[:, k, :]
    return out


def _gather_lib():
    lib = _build.load("patch_gather")
    fn = lib.lnt_patch_gather
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, ll, i, i, ll, ll, ll, i, i, i, i, p]
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


def _check(values: torch.Tensor, neighbors: torch.Tensor, include_center: bool, row0: int = 0) -> K1Plan:
    """Raises for inputs the kernel does not take; returns its launch plan."""
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
    if include_center and (row0 < 0 or row0 + neighbors.shape[0] > values.shape[0]):
        raise ValueError("the centre column needs a query table no longer than the value table")
    align = values.data_ptr() & -values.data_ptr() if values.data_ptr() else 16
    return _plan(values.shape[1] * values.element_size(), neighbors.shape[1], include_center, align)


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


def _gather(values: torch.Tensor, neighbors: torch.Tensor, include_center: bool, row0: int = 0) -> torch.Tensor:
    """The K1 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if _build.device_type(values, "patch_gather") == "cpu":
        return patch_gather_plain(values, neighbors, include_center, row0)
    plan = _check(values, neighbors, include_center, row0)
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
            row0,
            *plan,
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
    def forward(ctx, values, neighbors, include_center, plain, row0):
        ctx.save_for_backward(neighbors)
        ctx.meta = (values.shape[0], values.dtype, include_center, plain, row0)
        if plain:
            return patch_gather_plain(values, neighbors, include_center, row0)
        return _gather(values, neighbors, include_center, row0)

    @staticmethod
    def backward(ctx, g):
        (neighbors,) = ctx.saved_tensors
        cap, dtype, include_center, plain, row0 = ctx.meta
        fn = patch_scatter_plain if plain else patch_scatter
        g = g.to(torch.float32)
        if include_center and row0:
            # the centre column of a row block adds to the block's own rows
            k = neighbors.shape[1]
            d_values = fn(g[:, :k].contiguous(), neighbors, cap, False)
            d_values[row0 : row0 + neighbors.shape[0]] += g[:, k]
        else:
            d_values = fn(g.contiguous(), neighbors, cap, include_center)
        return d_values.to(dtype), None, None, None, None


def patch_gather(
    values: torch.Tensor, neighbors: torch.Tensor, include_center: bool, plain: bool = False,
    row0: int = 0,
) -> torch.Tensor:  # fmt: skip
    """(cap_src, C) x (Q, K) int32 -> (Q, K(+1), C), the values' dtype; with
    ``include_center`` the centre column is ``values[row0 : row0 + Q]``.

    Differentiable in ``values``: the adjoint is :func:`patch_scatter`
    (K1-bwd on the card), cast back to the values' dtype."""
    return _PatchGather.apply(values, neighbors, include_center, plain, int(row0))


patch_gather.launches = 0
