"""Named meshes over torch.distributed ranks, their collectives, and the
launcher that starts the ranks.

The port's counterpart of ``jax.sharding.Mesh`` and of the three ``lax``
collectives the JAX package's parallel code calls:

* :meth:`Mesh.psum` / :meth:`Mesh.pmean` over one axis or several
  (``lax.psum``/``lax.pmean``);
* :meth:`Mesh.shift`, a shift by one position along an axis
  (``lax.ppermute`` with the perm ``[(j, j + 1)]`` or ``[(j, j - 1)]``):
  the edge position that no one sends to receives zeros, as a partial
  ``ppermute`` gives it.

Each collective is differentiable with JAX's transpose as its backward: a
psum's cotangent is psum'd, a shift up's is shifted down.  Every one is
built on ``dist.all_reduce`` alone, the one collective that NCCL, gloo on
the CPU and gloo on CUDA tensors all have (gloo on CUDA has no
``send``/``recv`` and no ``all_gather``).  A shift is then an all-reduce of
an ``(n, *x.shape)`` slot buffer in which each rank fills its target's
slot: exact (x + 0 = x), at n times the bytes of a ``ppermute``.

PyTorch has no virtual devices, so :func:`launch` spawns the ranks
(``torch.multiprocessing``, the ``spawn`` start method: CUDA cannot fork):
one a card over NCCL by default; a rank count and a backend may be given,
gloo on the CPU (the tests) or gloo on CUDA tensors where several ranks
share a card (NCCL refuses two ranks on one GPU).  The backend is chosen
explicitly and printed; a failure raises and never falls back to another.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import shutil
import tempfile
import traceback
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from lattice_net_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")


class Mesh:
    """Named axes laid over the ranks of the default process group, rank
    ``r`` at the coordinates of ``r`` in ``np.arange(world).reshape(shape)``
    (the row-major layout of ``Mesh(devices.reshape(shape), names)``).

    Every rank constructs the mesh, in the same order as every other: each
    subset of axes that a collective may name gets one process group per
    row of the other axes' coordinates (``dist.new_group``, which all ranks
    must call)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} and shape {sizes} differ in length")
        self.shape = dict(zip(self.axis_names, sizes))
        self.world = dist.get_world_size()
        if int(np.prod(sizes)) != self.world:
            raise ValueError(f"mesh {self.shape} needs {int(np.prod(sizes))} ranks, the group has {self.world}")
        self.rank = dist.get_rank()
        ids = np.arange(self.world).reshape(sizes)
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(self.rank, sizes))))
        self._groups = {}
        for k in range(1, len(sizes) + 1):
            for axes in itertools.combinations(range(len(sizes)), k):
                names = tuple(self.axis_names[a] for a in axes)
                if k == len(sizes):
                    self._groups[names] = (None, ids.reshape(-1).tolist())
                    continue
                rows = np.moveaxis(ids, axes, tuple(range(-k, 0))).reshape(-1, int(np.prod([sizes[a] for a in axes])))
                for row in rows.tolist():
                    group = dist.new_group(row)
                    if self.rank in row:
                        self._groups[names] = (group, row)

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; the mesh has {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank's row along ``axes`` (None: the
        default group)."""
        return self._groups[self._axes(axes)][0]

    def axis_index(self, axis: str) -> int:
        return self.coords[self._axes(axis)[0]]

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over ``axes``, added in rank order (n times the bytes
        of an all-reduce: meant for moments and losses, not gradients); the
        backward psums the cotangent."""
        group, row = self._groups[self._axes(axes)]
        return _PSum.apply(x, group, row, self.rank)

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes) / self.size(axes)

    def shift(self, x: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
        """``x`` of the rank ``offset`` positions before this one along
        ``axis`` (+1: from the left neighbour, ``ppermute`` with ``(j, j +
        1)``); zeros where there is none.  The backward shifts the cotangent
        by ``-offset``."""
        return _Shift.apply(x, self, self._axes(axis)[0], int(offset))

    def psum_tree(self, tree: dict, axes) -> dict:
        """The sum over ``axes`` of every tensor of a ``{name: tensor}`` dict,
        by one all-reduce a dtype (in the backend's order of addition),
        outside autograd."""
        return _flat_all_reduce(tree, self.group(axes))

    def pmean_tree(self, tree: dict, axes) -> dict:
        n = self.size(axes)
        return {k: v / n for k, v in self.psum_tree(tree, axes).items()}

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``(n, *x.shape)``: every rank's ``x`` along ``axes`` in the order
        of their coordinates, by an all-reduce of a zero-filled slot buffer
        (outside autograd; every rank's ``x`` must have the same shape)."""
        group, row = self._groups[self._axes(axes)]
        return _gather(x, group, row, self.rank)


def _all_reduce(t: torch.Tensor, group) -> None:
    """In-place sum over ``group``: the one collective every backend has."""
    if t.dtype == torch.bool:
        raise TypeError("all_reduce of a bool tensor: cast it first")
    dist.all_reduce(t, group=group)


def _gather(x: torch.Tensor, group, row: list, rank: int) -> torch.Tensor:
    """(len(row), *x.shape): each rank's ``x`` in its slot of a zero-filled
    buffer, all-reduced (exact: x + 0 = x)."""
    buf = x.new_zeros((len(row),) + tuple(x.shape))
    buf[row.index(rank)] = x
    _all_reduce(buf, group)
    return buf


def _ordered_sum(x: torch.Tensor, group, row: list, rank: int) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``group``, added in the order of
    ``row`` (XLA's order for a psum on the CPU): the same bits on every rank
    and run, and JAX's bits."""
    buf = _gather(x, group, row, rank)
    y = buf[0]
    for j in range(1, len(row)):
        y = y + buf[j]
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, row, rank):
        ctx.args = (group, row, rank)
        return _ordered_sum(x, group, row, rank)

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(g, *ctx.args), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return _shift(x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.offset), None, None, None


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, offset: int) -> torch.Tensor:
    group, row = mesh._groups[(axis,)]
    i = mesh.coords[axis]
    buf = x.new_zeros((len(row),) + tuple(x.shape))
    if 0 <= i + offset < len(row):
        buf[i + offset] = x
    _all_reduce(buf, group)
    return buf[i]


def _flat_all_reduce(tree: dict, group) -> dict:
    out = {}
    by_dtype: dict = {}
    for k, v in tree.items():
        by_dtype.setdefault((v.dtype, v.device), []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tree[k].detach().reshape(-1) for k in keys])
        _all_reduce(flat, group)
        for k, piece in zip(keys, torch.split(flat, [tree[k].numel() for k in keys])):
            out[k] = piece.view(tree[k].shape)
    return {k: out[k] for k in tree}


def broadcast_tree(tree):
    """A nest of dicts as rank ``0`` holds it, on every rank: each tensor
    broadcast into a new one, other leaves (Python numbers) kept."""
    if isinstance(tree, dict):
        return {k: broadcast_tree(v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach().contiguous().clone()
    dist.broadcast(t, 0)
    return t


def _tensor_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensor_leaves(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def check_replicated(tree: dict, what: str = "state") -> None:
    """Raise, on every rank, unless every rank holds the same bits in every
    tensor of ``tree`` (a nest of dicts): each tensor's bytes as int64
    words, two checksums a tensor, gathered from all ranks by one
    all-reduce."""
    leaves = dict(_tensor_leaves(tree))
    keys = sorted(leaves)
    if not keys:
        return
    sums = []
    for k in keys:
        b = leaves[k].detach().contiguous().reshape(-1).view(torch.uint8)
        b = torch.cat([b, b.new_zeros((-b.numel()) % 8)])
        w = b.view(torch.int64)
        sums.append(torch.stack([w.sum(), (w * 0x9E3779B1).sum()]))
    world = dist.get_world_size()
    every = _gather(torch.stack(sums), None, list(range(world)), dist.get_rank())
    differ = [keys[i] for i in torch.nonzero((every != every[0]).any(dim=2).any(dim=0)).reshape(-1).tolist()]
    if differ:
        raise RuntimeError(f"{what} differs across ranks in {len(differ)} tensors, e.g. {differ[:3]}")


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ranks:
    """How :func:`launch` runs: ``count`` processes on ``device`` ("cuda" or
    "cpu") over ``backend``."""

    count: int
    device: str
    backend: str


def plan_ranks(ranks: int | None = None, device=None, backend: str | None = None) -> Ranks:
    """The ranks of a run: on the card one a visible card over NCCL unless
    ``ranks``/``backend`` say otherwise (gloo lets ranks share a card); on
    the CPU gloo, with ``ranks`` given.  Raises for a combination that
    cannot run."""
    dev = resolve_device(device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        count = cards if ranks is None else int(ranks)
        backend = backend or "nccl"
        if backend == "nccl" and count > cards:
            raise ValueError(
                f"NCCL needs a card a rank: {count} ranks on {cards} cards; pass backend='gloo' "
                "to let ranks share a card"
            )
    else:
        if ranks is None:
            raise ValueError("on the CPU the rank count must be given")
        count = int(ranks)
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    if count < 1:
        raise ValueError(f"{count} ranks")
    return Ranks(count, dev.type, backend)


def launch(fn, *args, ranks: Ranks, timeout_s: float = 1800.0) -> list:
    """``[fn(device, *args) of rank r for r in range(ranks.count)]``, each
    rank a spawned process in a process group of ``ranks.backend``, its
    tensors' results returned as numpy arrays.

    ``fn`` and ``args`` are pickled (``fn`` by its import path), and each
    rank imports the caller's main module again, so that module must guard
    its entry point (``if __name__ == "__main__":``).  On the card the
    kernels are built here first, so that no rank runs nvcc; rank ``r``
    runs on card ``r % device_count``, a CPU rank on one thread.  The
    failing ranks' tracebacks are raised here, after every rank has been
    stopped."""
    import torch.multiprocessing as mp

    if ranks.device == "cuda":
        from lattice_net_tpu_torch.ops_cuda import _build

        _build.build_all(_build.SOURCES)
    print(f"launch: {ranks.count} ranks on {ranks.device} over {ranks.backend}", flush=True)
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="lnt_ranks_")
    init = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, args, r, ranks, init, timeout_s, results))
        for r in range(ranks.count)
    ]
    out, errors = {}, []
    try:
        for p in procs:
            p.start()
        while len(out) < ranks.count and not errors:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"rank {dead[0][0]} exited with code {dead[0][1]}")
                continue
            if ok:
                out[r] = payload
            else:
                errors.append(payload)
        if errors:  # the other ranks' reports (a rank's failure breaks the rest's collectives)
            while True:
                try:
                    r, ok, payload = results.get(timeout=3.0)
                except queue.Empty:
                    break
                if not ok:
                    errors.append(payload)
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if errors and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [out[r] for r in range(ranks.count)]


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, args, rank: int, ranks: Ranks, init: str, timeout_s: float, results) -> None:
    try:
        if ranks.device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            ranks.backend, init_method=init, world_size=ranks.count, rank=rank,
            timeout=timedelta(seconds=timeout_s), device_id=dev if ranks.backend == "nccl" else None,
        )  # fmt: skip
        try:
            out = _to_host(fn(dev, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, f"rank {rank}:\n{traceback.format_exc()}"))
        raise
