"""The port's mesh collectives against JAX's ``shard_map`` of ``lax.psum``,
``lax.pmean`` and ``lax.ppermute`` under ``jax.grad``, on the same numpy
inputs.

The port's side runs in gloo ranks on the CPU (``mesh.launch``, a
``file://`` store): 2 ranks on a 1-D mesh, and 4 ranks on a 1-D mesh and
on a 2x2 mesh over each axis.  Each rank holds its block of ``X``, applies
the collective, and backpropagates its block of ``CT``; JAX's side is the
same on 2 or 4 of conftest's virtual CPU devices, ``check_vma=False`` as the
JAX package's parallel code uses it.  Values must be equal, gradients
within 1e-6.

The spawned ranks import this module, so JAX is imported inside the
reference fixture only (a rank never loads it).
"""

import functools

import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

GRAD_ATOL = 1e-6
SHAPE = (5, 3)  # one rank's block
# (mesh axes, mesh shape, collective, axes it runs over, shift offset)
CASES = {
    2: [
        (("sp",), (2,), op, ("sp",), off)
        for op, off in (("psum", 0), ("pmean", 0), ("shift", 1), ("shift", -1))
    ],
    4: [
        (("sp",), (4,), op, ("sp",), off)
        for op, off in (("psum", 0), ("pmean", 0), ("shift", 1), ("shift", -1))
    ]
    + [
        (("dp", "sp"), (2, 2), op, axes, off)
        for axes in (("dp",), ("sp",))
        for op, off in (("psum", 0), ("pmean", 0), ("shift", 1), ("shift", -1))
    ]
    + [(("dp", "sp"), (2, 2), op, ("dp", "sp"), 0) for op in ("psum", "pmean")],
}


def _inputs(world):
    rng = np.random.default_rng(world)
    x = rng.normal(size=(world,) + SHAPE).astype(np.float32)
    ct = rng.normal(size=(world,) + SHAPE).astype(np.float32)
    return x, ct


def _rank_collectives(device, world):
    """Every case of ``CASES[world]`` in this rank: (value, grad) of its
    block; on 2 ranks also :func:`_replication`'s results."""
    x_all, ct_all = _inputs(world)
    meshes = {}
    out = []
    for names, shape, op, axes, off in CASES[world]:
        if names not in meshes:
            meshes[names] = tmesh.Mesh(names, shape)
        m = meshes[names]
        x = torch.from_numpy(x_all[m.rank]).requires_grad_()
        if op == "shift":
            y = m.shift(x, axes[0], off)
        else:
            y = getattr(m, op)(x, axes)
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(ct_all[m.rank]))
        out.append((y.detach(), g))
    return out, (_replication(meshes[("sp",)]) if world == 2 else None)


@functools.lru_cache(maxsize=None)
def _port(world):
    return tmesh.launch(_rank_collectives, world, ranks=tmesh.plan_ranks(world, "cpu"))


def _jax_case(world, names, shape, op, axes, off):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    x, ct = _inputs(world)
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(shape), names)
    spec = P(names if len(names) > 1 else names[0])

    def body(xs):
        if op == "psum":
            return jax.lax.psum(xs, axes)
        if op == "pmean":
            return jax.lax.pmean(xs, axes)
        n = mesh.shape[axes[0]]
        perm = [(j, j + off) for j in range(n) if 0 <= j + off < n]
        return jax.lax.ppermute(xs, axes[0], perm)

    f = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    flat = jnp.asarray(x.reshape((world * SHAPE[0],) + SHAPE[1:]))
    y = np.asarray(f(flat)).reshape(x.shape)
    g = jax.grad(lambda v: jnp.sum(f(v) * ct.reshape(flat.shape)))(flat)
    return y, np.asarray(g).reshape(x.shape)


@pytest.mark.parametrize(
    "world,case", [(w, i) for w in CASES for i in range(len(CASES[w]))],
    ids=[f"{w}ranks-{'x'.join(map(str, c[1]))}-{c[2]}{c[4] or ''}-{'+'.join(c[3])}"
         for w in CASES for c in CASES[w]],
)  # fmt: skip
def test_collective_matches_jax(world, case):
    got = _port(world)
    names, shape, op, axes, off = CASES[world][case]
    want_y, want_g = _jax_case(world, names, shape, op, axes, off)
    for r in range(world):
        y, g = got[r][0][case]
        np.testing.assert_array_equal(y, want_y[r], err_msg=f"rank {r} value")
        np.testing.assert_allclose(g, want_g[r], rtol=0, atol=GRAD_ATOL, err_msg=f"rank {r} gradient")


def _replication(m):
    mine = {"w": torch.full((3,), float(m.rank)), "b": torch.arange(4.0)}
    same = tmesh.broadcast_tree(mine)
    tmesh.check_replicated(same)
    gathered = m.all_gather(torch.tensor([float(m.rank), 7.0]), "sp")
    try:
        tmesh.check_replicated(mine)
    except RuntimeError as exc:
        return same, gathered, str(exc)
    return same, gathered, ""


def test_broadcast_gather_and_the_replication_check():
    for _, (same, gathered, err) in _port(2):
        np.testing.assert_array_equal(same["w"], np.zeros(3))
        np.testing.assert_array_equal(gathered, [[0.0, 7.0], [1.0, 7.0]])
        assert "differs across ranks in 1 tensors" in err


def _rank_fails(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("planted failure")
    torch.distributed.barrier()  # rank 0 would wait here forever alone


def test_a_failing_rank_raises_its_traceback_and_stops_the_others():
    with pytest.raises(RuntimeError, match="planted failure"):
        tmesh.launch(_rank_fails, ranks=tmesh.plan_ranks(2, "cpu"), timeout_s=600)


def test_plan_ranks():
    assert tmesh.plan_ranks(3, "cpu") == tmesh.Ranks(3, "cpu", "gloo")
    with pytest.raises(ValueError, match="rank count"):
        tmesh.plan_ranks(None, "cpu")
    with pytest.raises(ValueError, match="only gloo"):
        tmesh.plan_ranks(2, "cpu", "nccl")
    with pytest.raises(ValueError, match="backend"):
        tmesh.plan_ranks(2, "cpu", "mpi")
