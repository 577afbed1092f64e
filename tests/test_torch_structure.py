"""Port hierarchy build vs the JAX package: every table and counter equal.

Clouds cover a toy scene, a small LiDAR-like scan, a padded cloud with a
point mask, an overflowing capacity, and the simplex-rep fallback to the
full re-splat.  Integer tables compare exactly; floats (sigma, splat
weights, carried rows) are produced by the same f32 arithmetic and compare
exactly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.data.toy import make_toy_cloud
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu_torch.lattice import structure as ts

torch.set_num_threads(2)


def _build_both(pos, sigma, caps, mask=None, feats=None):
    nl = len(caps) - 1
    hj = js.build_hierarchy(
        jnp.asarray(pos),
        sigma,
        nl,
        caps,
        point_mask=None if mask is None else jnp.asarray(mask),
        point_feats=None if feats is None else jnp.asarray(feats),
    )
    ht = ts.build_hierarchy(
        torch.from_numpy(pos),
        sigma,
        nl,
        caps,
        point_mask=None if mask is None else torch.from_numpy(mask),
        point_feats=None if feats is None else torch.from_numpy(feats),
    )
    return hj, ht


def _assert_same(hj, ht, n_valid_points):
    assert len(hj.structures) == len(ht.structures)
    for a, b in zip(hj.structures, ht.structures):
        np.testing.assert_array_equal(np.asarray(a.keys), b.keys.numpy())
        assert int(a.nr_verts) == int(b.nr_verts)
        assert int(a.nr_overflow) == int(b.nr_overflow)
        np.testing.assert_array_equal(np.asarray(a.sigma), b.sigma.numpy())
        assert (a.capacity, a.pos_dim, a.lvl) == (b.capacity, b.pos_dim, b.lvl)
        # the port's packed table is its form of the JAX pair-packed keys2
        np.testing.assert_array_equal(
            np.asarray(js.unpack_key_pairs(a.keys2, a.pos_dim)),
            ts.unpack_keys(b.packed, b.pos_dim)
            .where(b.occupancy_mask()[:, None], js.SENTINEL)
            .numpy(),
        )
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, b in zip(getattr(hj, name), getattr(ht, name), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(hj.splat_idx), ht.splat_idx.numpy())
    np.testing.assert_array_equal(np.asarray(hj.splat_weights), ht.splat_weights.numpy())
    np.testing.assert_array_equal(np.asarray(hj.point_mask), ht.point_mask.numpy())
    ej, et = hj.edges, ht.edges
    np.testing.assert_array_equal(np.asarray(ej.perm), et.perm.numpy())
    np.testing.assert_array_equal(np.asarray(ej.vertex), et.vertex.numpy())
    np.testing.assert_array_equal(np.asarray(ej.ends), et.ends.numpy())
    # the run ends every reduction reads: the reference's cummax of ends
    np.testing.assert_array_equal(np.asarray(jops._run_ends(ej)), et.run_end.numpy())
    assert (ej.rows is None) == (et.rows is None)
    if ej.rows is not None:
        # masked edges sort last, in an order the JAX sort leaves open
        m = n_valid_points * (hj.splat_idx.shape[1])
        np.testing.assert_array_equal(np.asarray(ej.rows)[:m], et.rows.numpy()[:m])


def test_toy_cloud():
    # the scans' point count and capacities, so the JAX build reuses its
    # compiled ops
    c = make_toy_cloud(8192, seed=1)
    hj, ht = _build_both(c.V, 0.1, (16384, 8192, 4096), feats=c.I)
    assert int(ht.structures[0].nr_overflow) == 0
    _assert_same(hj, ht, 8192)


def _scene(n=8192, seed=3):
    c = make_scene(n, seed=seed)
    return c.V, c.I


def test_small_scene_no_feats():
    pos, _ = _scene()
    hj, ht = _build_both(pos, 0.6, (16384, 8192, 4096))
    assert [int(s.nr_overflow) for s in ht.structures] == [0, 0, 0]
    _assert_same(hj, ht, len(pos))


def test_padded_cloud_with_point_mask():
    pos, vals = _scene()
    n_real = 6000
    pos[n_real:] = 0.0  # padding rows, as the batcher makes them
    vals[n_real:] = 0.0
    mask = np.arange(len(pos)) < n_real
    hj, ht = _build_both(pos, 0.6, (16384, 8192, 4096), mask=mask, feats=vals)
    assert int(ht.structures[0].nr_verts) > 0
    _assert_same(hj, ht, n_real)


def test_overflowing_capacity():
    # level 0 overflows, so the simplex reps are undecodable and every coarse
    # level comes from the full re-splat
    pos, vals = _scene()
    hj, ht = _build_both(pos, 0.6, (1024, 512, 256), feats=vals)
    assert all(int(s.nr_overflow) > 0 for s in ht.structures)
    _assert_same(hj, ht, len(pos))


def test_simplex_rep_slot_fallback():
    # level 0 fits, but its occupied simplices outnumber the rep slots
    # (capacity // 2), so the coarse levels fall back to the re-splat
    pos, vals = _scene()
    caps = (10240, 8192, 4096)
    pt = torch.from_numpy(pos)
    sigma = torch.full((3,), 0.6)
    s0, idx, _, _ = ts.build_structure(pt, sigma, caps[0], with_edges=True)
    assert int(s0.nr_overflow) == 0
    mask = torch.ones(len(pos), dtype=torch.bool)
    _, _, overflow = ts._simplex_reps(pt, sigma, idx, mask, s0, caps[0] // 2)
    assert int(overflow) > 0
    hj, ht = _build_both(pos, 0.6, caps, feats=vals)
    _assert_same(hj, ht, len(pos))


@pytest.mark.parametrize("d", [2, 3])
def test_pack_keys_roundtrip_and_order(d):
    rng = np.random.default_rng(d)
    k = rng.integers(-ts.PACK_BOUND + 1, ts.PACK_BOUND, size=(5000, d)).astype(np.int32)
    packed = ts.pack_keys(torch.from_numpy(k))
    np.testing.assert_array_equal(ts.unpack_keys(packed, d).numpy(), k)
    lex = np.lexsort(k.T[::-1])
    np.testing.assert_array_equal(np.argsort(packed.numpy(), kind="stable"), lex)


def test_default_capacity_schedule_matches():
    for cap, nl in [(100000, 2), (65536, 3), (1000, 4)]:
        assert ts.default_capacity_schedule(cap, nl) == js.default_capacity_schedule(cap, nl)
