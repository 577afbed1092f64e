"""The lookup of two-column packed lattice keys (``csrc/lookup2.cu``).

:func:`lookup2` resolves (nq, 2) int64 packed keys (d = 4..6) to row ids of
a sorted packed key table: a lower-bound search per query over the table's
occupied rows, the JAX package's direct lookup (``LatticeStructure.lookup``).
It launches the kernel for CUDA tensors and runs :func:`lookup2_plain` for
CPU tensors; neither falls back from the kernel to the plain version.
``lookup2.launches`` counts the kernel's launches.

The kernel replaces no TPU kernel: the JAX lookup is XLA code.  It takes the
place of the port's merged lookup of two-column keys (a sort of [table;
queries] and two ``cummax`` scans), which gave the same ids.
"""

from __future__ import annotations

import ctypes

import torch

from lattice_net_tpu_torch.ops_cuda import _build


def _lex_less(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return (rows[:, 0] < q[:, 0]) | ((rows[:, 0] == q[:, 0]) & (rows[:, 1] < q[:, 1]))


def lookup2_plain(table: torch.Tensor, nr_verts: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(cap, 2) sorted int64 table x () int32 occupied rows x (nq, 2) int64
    queries -> (nq,) int32: the row of each query's key among the first
    ``nr_verts`` rows, else ``cap``.

    JAX's lookup: a power-of-two lower bound in log2(cap) gather rounds,
    each advancing where the probed row is below the query, with
    ``nr_verts`` (a device tensor, never read to the host) in place of the
    capacity.  The kernel takes log2(nr_verts) rounds; both end on the same
    row wherever the key is present."""
    cap = table.shape[0]
    n = nr_verts.to(torch.int64).clamp(0, cap)
    nsteps = (cap - 1).bit_length() if cap > 1 else 0
    pos = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)
    for i in range(nsteps):
        cand = pos + (1 << (nsteps - 1 - i))
        rows = table[(cand - 1).clamp(max=cap - 1)]
        pos = torch.where((cand <= n) & _lex_less(rows, queries), cand, pos)
    found = (pos < n) & (table[pos.clamp(max=cap - 1)] == queries).all(-1)
    return torch.where(found, pos, cap).to(torch.int32)


def _lib():
    lib = _build.load("lookup2")
    fn = lib.lnt_lookup2
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _check(table: torch.Tensor, nr_verts: torch.Tensor, queries: torch.Tensor) -> None:
    if table.dim() != 2 or table.shape[1] != 2 or queries.dim() != 2 or queries.shape[1] != 2:
        raise ValueError(f"need a (cap, 2) table and (nq, 2) queries, got {tuple(table.shape)}, {tuple(queries.shape)}")
    if not 0 < table.shape[0] < 2**31:
        raise ValueError(f"lookup2 takes a table of 1 to 2^31 - 1 rows, got {table.shape[0]}")
    if table.dtype != torch.int64 or queries.dtype != torch.int64:
        raise TypeError(f"table and queries must be int64, got {table.dtype}, {queries.dtype}")
    if nr_verts.dtype != torch.int32 or nr_verts.numel() != 1:
        raise TypeError(f"nr_verts must be one int32, got {nr_verts.dtype} of shape {tuple(nr_verts.shape)}")
    if nr_verts.device != table.device or queries.device != table.device:
        raise ValueError(f"table on {table.device}, nr_verts on {nr_verts.device}, queries on {queries.device}")
    if not (table.is_contiguous() and queries.is_contiguous()):
        raise ValueError("lookup2 needs a contiguous table and queries")
    if (table.data_ptr() | queries.data_ptr()) % 16:
        raise ValueError("lookup2 reads rows as 16-byte vectors: the table and queries must be 16-byte aligned")


def lookup2(table: torch.Tensor, nr_verts: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """:func:`lookup2_plain`'s ids: the plain version for CPU tensors, the
    kernel for CUDA."""
    if _build.device_type(table, "lookup2") == "cpu":
        return lookup2_plain(table, nr_verts, queries)
    _check(table, nr_verts, queries)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    fn = _lib()
    with torch.cuda.device(table.device):
        err = fn(
            table.data_ptr(), nr_verts.data_ptr(), queries.data_ptr(), out.data_ptr(), queries.shape[0],
            table.shape[0], torch.cuda.current_stream().cuda_stream,
        )  # fmt: skip
    _build.check(err, "lookup2")
    lookup2.launches += 1
    return out


lookup2.launches = 0
