"""The port's canonical point order, its fast build and the build options
vs the JAX package, on the CPU.

* ``distribute_sorted`` without carried rows, both of JAX's branches
  (per-edge weights in the edge sort; ``splat_weights`` folded into the row
  gather), and JAX's ``LNT_CARRY_FEATS=0`` against the port's build
  without ``point_feats``: rows at 1e-6.
* ``canonical_point_order`` and the host twin ``canonical_point_order_np``:
  permutations exactly.
* ``build_hierarchy(canonical_points=True)``: every table, the edge sort's
  ``perm``, ``vertex``, ``ends`` and run ends exactly, on a canonical cloud,
  a masked one, one whose runs are split (a host order that rounds some
  points differently) and one whose runs overflow the rep slots.
* ``coarse_mode`` "resplat", "simplex", "vertices" (and the
  ``coarse_from_vertices`` alias) with JAX's errors; JAX's
  ``LNT_MERGED_LOOKUP=0``;
  ``LatticeStructure.lookup`` and ``build_neighbors_fine_from_coarse``.

The model on the canonical order (serving labels, the train step, the
trainer's switch) is in ``test_torch_canonical_model.py``.

The JAX builds are jitted (10x faster than eager on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import host_order as jho
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu_torch.interop import hierarchy_from_numpy
from lattice_net_tpu_torch.lattice import host_order as tho
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.models import lnn as tlnn

torch.set_num_threads(2)

SIGMA, CAPS = 0.6, (8192, 4096, 2048)
N = 1 << 12


@functools.lru_cache(maxsize=None)
def _jbuild(nl, caps, **kw):
    return jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=nl, capacities=caps, **kw))


@functools.lru_cache(maxsize=None)
def _scan(n=N, seed=3):
    return np.asarray(make_scene(n, seed=seed).V, np.float32)


def _assert_tables(hj, ht, edges=True):
    for a, b in zip(hj.structures, ht.structures, strict=True):
        np.testing.assert_array_equal(np.asarray(a.keys), b.keys.numpy())
        assert (int(a.nr_verts), int(a.nr_overflow)) == (int(b.nr_verts), int(b.nr_overflow))
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, b in zip(getattr(hj, name), getattr(ht, name), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(hj.splat_idx), ht.splat_idx.numpy())
    # splat weights: XLA's jitted build rounds them up to 2.3e-5 away from
    # the eager build, which the port equals (ROADMAP section 3); the tests
    # below hold them against the port's default build instead
    if edges:
        ej, et = hj.edges, ht.edges
        for f in ("perm", "vertex", "ends"):
            np.testing.assert_array_equal(np.asarray(getattr(ej, f)), getattr(et, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(jops._run_ends(ej)), et.run_end.numpy())
        assert et.rows is None and ej.rows is None


# ---------------------------------------------------------------------------
# module 3: the distribute without carried rows; module 4: JAX's LNT_CARRY_FEATS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch", ["splat_weights", "edge_weights"])
def test_distribute_sorted_without_carried_rows(branch, rng):
    pts = _scan()
    vals = rng.normal(size=(N, 2)).astype(np.float32)
    hj = _jbuild(2, CAPS)(jnp.asarray(pts))
    ej = hj.edges
    if branch == "edge_weights":
        w = np.asarray(hj.splat_weights).reshape(-1)[np.asarray(ej.perm)]
        ej = ej.replace(weights=jnp.asarray(w))
    ht = hierarchy_from_numpy(hj.replace(edges=ej), device="cpu")
    assert (ht.edges.weights is None) == (branch == "splat_weights")
    for mean in (True, False):
        rj, ij = jops.distribute_sorted(jnp.asarray(pts), jnp.asarray(vals), ej, CAPS[0], mean,
                                        splat_weights=hj.splat_weights)  # fmt: skip
        rt, it = tops.distribute_sorted(torch.from_numpy(pts), torch.from_numpy(vals), ht.edges,
                                        CAPS[0], mean, splat_weights=ht.splat_weights)  # fmt: skip
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)


def test_distribute_sorted_needs_weights_or_rows_of_the_right_width(rng):
    pts = torch.from_numpy(_scan(512))
    vals = torch.zeros((512, 1))
    h = ts.build_hierarchy(pts, SIGMA, 1, (2048, 1024))
    with pytest.raises(ValueError, match="splat_weights"):
        tops.distribute_sorted(pts, vals, h.edges, 2048)
    h = ts.build_hierarchy(pts, SIGMA, 1, (2048, 1024), point_feats=torch.zeros((512, 2)))
    with pytest.raises(ValueError, match="d \\+ C \\+ 1"):
        tops.distribute_sorted(pts, vals, h.edges, 2048)


def test_carry_feats_off_builds_no_rows_and_the_model_reads_splat_weights(monkeypatch, rng):
    pts = _scan()
    vals = rng.normal(size=(N, 1)).astype(np.float32)
    monkeypatch.setattr(js, "_CARRY_FEATS", False)
    hj = _jbuild(2, CAPS)(jnp.asarray(pts), point_feats=jnp.asarray(vals))
    ht = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS)
    assert hj.edges.rows is None and ht.edges.rows is None
    # the default build's perm, vertex and ends; the model reads splat_weights
    carried = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS, point_feats=torch.from_numpy(vals))
    assert carried.edges.rows is not None
    torch.testing.assert_close(ht.edges.perm, carried.edges.perm, rtol=0, atol=0)
    mp = tlnn.ModelParams(
        nr_classes=4, values_mode="intensity", pointnet_channels_per_layer=(8,),
        pointnet_start_nr_channels=8, nr_downsamples=2, nr_blocks_down_stage=(1, 1),
        nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    )  # fmt: skip
    model = tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    p, v = torch.from_numpy(pts), torch.from_numpy(vals)
    with torch.no_grad():
        a, _ = model(ht, p, v)
        b, _ = model(carried, p, v)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# modules 5-6: the canonical order and its fast build
# ---------------------------------------------------------------------------


def test_canonical_point_order_and_host_twin(rng):
    pts = _scan()
    mask = np.arange(N) < N - 300
    perm_j = np.asarray(jax.jit(js.canonical_point_order, static_argnums=1)(jnp.asarray(pts), SIGMA))
    perm_t = ts.canonical_point_order(torch.from_numpy(pts), SIGMA).numpy()
    np.testing.assert_array_equal(perm_t, perm_j)
    perm_jm = np.asarray(js.canonical_point_order(jnp.asarray(pts), SIGMA, jnp.asarray(mask)))
    perm_tm = ts.canonical_point_order(torch.from_numpy(pts), SIGMA, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(perm_tm, perm_jm)
    assert mask[perm_tm][: mask.sum()].all() and not mask[perm_tm][mask.sum() :].any()
    host_t, host_j = tho.canonical_point_order_np(pts, SIGMA), jho.canonical_point_order_np(pts, SIGMA)
    np.testing.assert_array_equal(host_t, host_j)
    assert host_t.dtype == np.int32 and sorted(host_t.tolist()) == list(range(N))


def _split_runs(perm, every=97):
    """A canonical permutation with some points moved to the end of their
    neighbour's slot: the simplex runs they sat in split in two."""
    p = perm.copy()
    for i in range(5, len(p) - 1, every):
        p[i], p[i + 1] = p[i + 1], p[i]
    return p


@pytest.mark.parametrize("case", ["canonical", "masked", "split_runs", "rep_overflow"])
def test_canonical_fast_build_matches_jax(case):
    pts = _scan()
    mask = None
    caps = CAPS
    perm = ts.canonical_point_order(torch.from_numpy(pts), SIGMA).numpy()
    if case == "masked":
        mask = np.arange(N) < N - 500
        perm = ts.canonical_point_order(torch.from_numpy(pts), SIGMA, torch.from_numpy(mask)).numpy()
        mask = mask[perm]
    elif case == "split_runs":
        perm = _split_runs(perm)
    elif case == "rep_overflow":
        caps = (512, 256, 256)  # 256 rep slots for ~1k runs: the generic build runs
    pc = pts[perm]
    kw = {} if mask is None else dict(point_mask=jnp.asarray(mask))
    hj = _jbuild(2, caps, canonical_points=True)(jnp.asarray(pc), **kw)
    ht = ts.build_hierarchy(
        torch.from_numpy(pc), SIGMA, 2, caps, canonical_points=True,
        point_mask=None if mask is None else torch.from_numpy(mask),
    )  # fmt: skip
    _assert_tables(hj, ht)
    # and the default build of the same points: the same tables
    hd = ts.build_hierarchy(torch.from_numpy(pc), SIGMA, 2, caps,
                            point_mask=None if mask is None else torch.from_numpy(mask))  # fmt: skip
    for a, b in zip(ht.structures, hd.structures):
        torch.testing.assert_close(a.keys, b.keys, rtol=0, atol=0)
    torch.testing.assert_close(ht.splat_idx, hd.splat_idx, rtol=0, atol=0)
    torch.testing.assert_close(ht.splat_weights, hd.splat_weights, rtol=0, atol=0)
    # the same edge sort as the default build's: the runs are contiguous
    # point ranges, so each vertex's edges come in point order either way
    for f in ("perm", "vertex", "ends"):
        torch.testing.assert_close(getattr(ht.edges, f), getattr(hd.edges, f), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# modules 8-9: coarse modes and the direct lookups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["resplat", "simplex", "vertices", "alias"])
def test_coarse_modes_match_jax(mode):
    pts = _scan()
    kw = dict(coarse_from_vertices=True) if mode == "alias" else dict(coarse_mode=mode)
    hj = _jbuild(2, CAPS, **kw)(jnp.asarray(pts))
    ht = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS, **kw)
    _assert_tables(hj, ht, edges=False)
    if mode == "resplat":  # the key sets of the default (simplex) build
        hd = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS)
        for lvl in range(3):
            torch.testing.assert_close(ht.neighbors_same[lvl], hd.neighbors_same[lvl], rtol=0, atol=0)


def test_coarse_mode_errors_match_jax():
    pts = np.zeros((8, 3), np.float32)
    for caps, mode in (((1 << 22, 1024), "simplex"), ((1024, 512), "octree")):
        with pytest.raises(ValueError) as ej:
            js.build_hierarchy(jnp.asarray(pts), SIGMA, 1, caps, coarse_mode=mode)
        with pytest.raises(ValueError) as et:
            ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 1, caps, coarse_mode=mode)
        assert str(et.value) == str(ej.value)


def test_unmerged_lookups_give_the_merged_tables(monkeypatch):
    pts = _scan()
    merged = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS)
    monkeypatch.setenv("LNT_MERGED_LOOKUP", "0")
    # a new trace reads JAX's switch
    hj = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=2, capacities=CAPS))(
        jnp.asarray(pts)
    )
    ht = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 2, CAPS)
    _assert_tables(hj, ht, edges=False)
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, b in zip(getattr(merged, name), getattr(ht, name)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lookup_and_fine_from_coarse_match_jax(rng):
    pts = _scan()
    hj = _jbuild(2, CAPS)(jnp.asarray(pts))
    ht = hierarchy_from_numpy(hj, device="cpu")
    s_j, s_t = hj.structures[0], ht.structures[0]
    nv = int(s_t.nr_verts)
    hits = s_t.keys[:nv][rng.integers(0, nv, 3000)]
    queries = torch.cat([hits, hits + torch.from_numpy(rng.integers(-2, 3, hits.shape).astype(np.int32))])
    got = s_t.lookup(queries)
    np.testing.assert_array_equal(got.numpy(), np.asarray(s_j.lookup(jnp.asarray(queries.numpy()))))
    torch.testing.assert_close(got, s_t.merge_lookup(queries), rtol=0, atol=0)
    assert (got[:3000] < CAPS[0]).all() and (got == CAPS[0]).any()
    for i in range(2):
        fine_j, coarse_j = hj.structures[i], hj.structures[i + 1]
        want = np.asarray(jax.jit(js.build_neighbors_fine_from_coarse)(fine_j, coarse_j))
        got = ts.build_neighbors_fine_from_coarse(ht.structures[i], ht.structures[i + 1])
        np.testing.assert_array_equal(got.numpy(), want)
        # the direct lookups give the transpose the build uses
        np.testing.assert_array_equal(got.numpy(), ht.neighbors_finefy[i].numpy())
