"""The lookup of two-column packed keys (``ops_cuda/lookup.py``, d = 4..6).

* On the CPU, for d = 4, 5, 6: :func:`lookup2_plain`, and the port's
  ``LatticeStructure.merge_lookup`` (which reaches it through the wrapper),
  against the JAX package's ``LatticeStructure.lookup`` and ``merge_lookup``
  on sorted key tables: hits, misses, queries before the first row and past
  the last occupied row, sentinel rows past ``nr_verts``, ``nr_verts`` 0 and
  equal to the capacity, coordinates at +-(``PACK_BOUND`` - 1).
* On a card (marker ``card``, skipped elsewhere): the kernel bit-equal to
  :func:`lookup2_plain` at the level-0 same-level call of a 6-D room, a
  5M-row table with about 195k occupied rows and 35M queries.

JAX is imported only inside the CPU cases, so the card case runs where JAX is
not installed: ``python -m pytest --noconftest -m card tests/test_torch_lookup2.py``.
"""

import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.ops_cuda import lookup as k_lookup

B = ts.PACK_BOUND - 1
# (capacity, occupied rows, extreme rows in the table) of each table a case builds
TABLES = ((64, 0, False), (64, 64, True), (300, 1, False), (300, 2, True), (1000, 617, True), (5000, 4097, False))


def _table(d, cap, n, extremes, rng):
    """(cap, d) int32 sorted unique keys: four corner rows at +-``B`` with
    ``extremes``, the rest drawn from a small box around 0 (wide enough for
    ``n`` rows); ``SENTINEL`` rows from ``n`` on."""
    corners = np.array([[B] * d, [-B] * d, [B, -B] * (d // 2) + [B] * (d % 2), [-B] + [B] * (d - 1)])
    r = 3
    while (2 * r + 1) ** d < 4 * n:
        r += 1
    box = np.unique(rng.integers(-r, r + 1, (4 * n + 8, d)), axis=0)
    rows = np.concatenate([corners[: n if extremes else 0], rng.permutation(box)])[:n]
    keys = np.full((cap, d), ts.SENTINEL, np.int32)
    keys[:n] = np.unique(rows, axis=0)
    return keys


def _queries(keys, n, rng):
    """Every occupied row, each moved along every axis both ways, random
    keys of the box, the corners, keys before the first row and past the
    last occupied one, and the masked rows' zero keys plus the moves."""
    d = keys.shape[1]
    moves = ts._axis_moves(d, "cpu").numpy()
    occ = keys[:n]
    parts = [occ, (occ[:, None] + moves[None]).reshape(-1, d), (occ[:, None] - moves[None]).reshape(-1, d),
             rng.integers(-4, 5, (200, d)), np.full((1, d), B), np.full((1, d), -B), moves, -moves]  # fmt: skip
    if n:
        first, last = occ[0].copy(), occ[-1].copy()
        first[-1] -= 1
        last[-1] += 1
        parts += [first[None], last[None]]
    return np.concatenate(parts).astype(np.int32)


def _port_structure(keys, n):
    cap, d = keys.shape
    keys = torch.from_numpy(keys)
    return ts.LatticeStructure(keys=keys, packed=ts.pack_key_table(keys), nr_verts=torch.tensor(n, dtype=torch.int32),
                               nr_overflow=torch.tensor(0, dtype=torch.int32), sigma=torch.ones(d), capacity=cap,
                               pos_dim=d, lvl=0)  # fmt: skip


def _jax_ids(keys, n, queries):
    """The JAX package's direct and merged lookups of ``queries`` (jitted:
    one compile each, many times faster than eager dispatch)."""
    import jax
    import jax.numpy as jnp

    from lattice_net_tpu.lattice import structure as js

    cap, d = keys.shape

    @jax.jit
    def ids(keys, q):
        s = js.LatticeStructure(keys=keys, nr_verts=jnp.int32(n), nr_overflow=jnp.int32(0), sigma=jnp.ones(d),
                                capacity=cap, pos_dim=d, lvl=0)  # fmt: skip
        return s.lookup(q), s.merge_lookup(q)

    return tuple(np.asarray(x) for x in ids(jnp.asarray(keys), jnp.asarray(queries)))


def _card_room_call():
    """The level-0 same-level lookup of a 6-D room at the 5M tables: its
    table and queries on the card."""
    from lattice_net_tpu_torch.data.synth_scannet import make_indoor_scene

    v, c, _ = make_indoor_scene(400000, seed=0)
    pos = torch.from_numpy(np.concatenate([v, c], axis=1).astype(np.float32)).cuda()
    s = ts.build_structure(pos, 0.08, 5_000_000)[0]
    occ = s.occupancy_mask()
    base = torch.where(occ[:, None], s.keys, 0)
    q = ts.pack_keys(base[:, None, :] + ts._axis_moves(6, pos.device)[None]).reshape(-1, 2)
    return s, q


@pytest.mark.parametrize(
    "case", [4, 5, 6, pytest.param("card-d6-5m", marks=pytest.mark.card)], ids=["d4", "d5", "d6", "card-d6-5m"]
)
def test_lookup2_matches_the_jax_lookups(case):
    if case == "card-d6-5m":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernel runs only there")
        s, q = _card_room_call()
        assert 150_000 < int(s.nr_verts) < 250_000 and q.shape[0] == 35_000_000
        before = k_lookup.lookup2.launches
        got = k_lookup.lookup2(s.packed, s.nr_verts, q)
        assert k_lookup.lookup2.launches == before + 1
        want = k_lookup.lookup2_plain(s.packed, s.nr_verts, q)
        assert torch.equal(got, want)
        assert 0 < int((got < s.capacity).sum()) < q.shape[0]
        return
    d, rng = case, np.random.default_rng(case)
    for cap, n, extremes in TABLES:
        keys = _table(d, cap, n, extremes, rng)
        queries = _queries(keys, n, rng)
        s = _port_structure(keys, n)
        q = ts.pack_keys(torch.from_numpy(queries))
        plain = k_lookup.lookup2_plain(s.packed, s.nr_verts, q).numpy()
        direct, merged = _jax_ids(keys, n, queries)
        where = f"d={d} cap={cap} n={n}"
        np.testing.assert_array_equal(plain, direct, err_msg=where)
        np.testing.assert_array_equal(plain, merged, err_msg=where)
        np.testing.assert_array_equal(s.merge_lookup(torch.from_numpy(queries)).numpy(), plain, err_msg=where)
        hits = plain < cap
        assert (hits.any() or n == 0) and not hits.all(), where
        assert (plain[hits] < n).all(), where


def _sound_args():
    table = ts.pack_key_table(torch.tensor(_table(6, 16, 9, True, np.random.default_rng(0))))
    return table, torch.tensor(9, dtype=torch.int32), table[:5].clone()


@pytest.mark.parametrize(
    "fault, error",
    [("three columns", ValueError), ("int32 queries", TypeError), ("int64 nr_verts", TypeError),
     ("nr_verts elsewhere", ValueError), ("strided queries", ValueError), ("unaligned table", ValueError)],
)  # fmt: skip
def test_lookup2_check_refuses_what_the_kernel_cannot_take(fault, error):
    table, nv, q = _sound_args()
    k_lookup._check(table, nv, q)  # the sound call passes
    if fault == "three columns":
        table = torch.zeros((16, 3), dtype=torch.int64)
    elif fault == "int32 queries":
        q = q.to(torch.int32)
    elif fault == "int64 nr_verts":
        nv = nv.to(torch.int64)
    elif fault == "nr_verts elsewhere":
        nv = torch.empty((), dtype=torch.int32, device="meta")
    elif fault == "strided queries":
        q = torch.zeros((2, 5), dtype=torch.int64).t()
    else:
        shifted = torch.empty(table.numel() + 1, dtype=torch.int64)[1:].view(-1, 2)
        table = shifted.copy_(table)
    with pytest.raises(error):
        k_lookup._check(table, nv, q)
