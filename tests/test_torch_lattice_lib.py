"""The port's lattice library off the model's path vs the JAX package's
``lattice/ops.py``, on the CPU, on one small scan's hierarchy (the JAX
build, jitted, fed to both sides).

* ``segment_sum``, ``segment_mean``, ``segment_max_with_src`` (ties to the
  largest source row, planted), ``splat``, ``distribute`` and
  ``distribute_module``, ``slice_lattice``, ``gather_lattice``, ``blur``,
  ``bilateral_blur`` and ``depthwise_conv``: ids exactly, f32 values at
  1e-5, gradients (``jax.grad`` against autograd) at 1e-4 relative L2.
* ``expand``: exactly at ``noise_stddev=0``; with noise, against JAX's
  ``build_structure`` of the same noisy points (the port's draws,
  recomputed from its generator's seed).
* ``create_splatting_mask``: exactly where every vertex holds at most
  ``max_nr_points`` edges; otherwise the edges whose keep probability is 1
  always survive, and the mean survivor count over ``DRAWS`` masks lies
  within ``SURVIVOR_SIGMAS`` standard errors of JAX's expectation
  ``sum(min(1, max_nr_points / count))``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.nn import modules as jnm
from lattice_net_tpu_torch.interop import hierarchy_from_numpy
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.nn import modules as tnm

torch.set_num_threads(2)

SIGMA, CAPS, N, C = 0.6, (8192, 4096), 1 << 12, 5
ATOL, GRAD_REL = 1e-5, 1e-4
DRAWS, SURVIVOR_SIGMAS = 16, 5.0


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(7)
    pts = np.asarray(make_scene(N, seed=5).V, np.float32)
    mask = np.arange(N) < N - 200
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=1, capacities=CAPS))
    hj = build(jnp.asarray(pts), point_mask=jnp.asarray(mask))
    ht = hierarchy_from_numpy(hj, device="cpu")
    vals = rng.normal(size=(N, C)).astype(np.float32)
    lv = rng.normal(size=(CAPS[0], C)).astype(np.float32)
    return pts, mask, vals, lv, hj, ht


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(got.detach().numpy() - want) / max(np.linalg.norm(want), 1e-12))


def _grads(fn_j, fn_t, *args):
    """Gradients of sum(out * probe) in every argument, JAX and the port."""
    out = fn_j(*[jnp.asarray(a) for a in args])
    probe = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    gj = jax.grad(lambda *a: jnp.sum(fn_j(*a) * probe), argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args]
    )
    leaves = [_t(a).requires_grad_() for a in args]
    (fn_t(*leaves) * _t(probe)).sum().backward()
    for g_j, leaf in zip(gj, leaves):
        assert _rel(leaf.grad, g_j) <= GRAD_REL


# ---------------------------------------------------------------------------
# module 10: segment helpers
# ---------------------------------------------------------------------------


def test_segment_sum_and_mean():
    pts, mask, vals, _, hj, ht = _data()
    idx = np.asarray(hj.splat_idx).reshape(-1)
    rows = np.repeat(vals, 4, axis=0)
    for fj, ft in ((jops.segment_sum, tops.segment_sum), (jops.segment_mean, tops.segment_mean)):
        _close(ft(_t(rows), _t(idx), CAPS[0]), fj(jnp.asarray(rows), jnp.asarray(idx), CAPS[0]))
        _grads(lambda v, fj=fj: fj(v, jnp.asarray(idx), CAPS[0]), lambda v, ft=ft: ft(v, _t(idx), CAPS[0]), rows)


def test_segment_max_with_src_ties_to_the_largest_row():
    _, _, vals, _, hj, _ = _data()
    idx = np.asarray(hj.splat_idx).reshape(-1)
    rows = np.round(np.repeat(vals, 4, axis=0), 1)  # one decimal: many ties in a segment
    mj, aj = jops.segment_max_with_src(jnp.asarray(rows), jnp.asarray(idx), CAPS[0])
    mt, at = tops.segment_max_with_src(_t(rows), _t(idx), CAPS[0])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.dtype == torch.int32 and (at == rows.shape[0]).any()  # empty segments -> M
    # a tie exists and goes to the larger row
    hit = at.numpy() < rows.shape[0]
    seg, ch = np.nonzero(hit)
    win = at.numpy()[seg, ch]
    ties = [(s, c, w) for s, c, w in zip(seg, ch, win) if ((idx == s) & (rows[:, c] == rows[w, c])).sum() > 1]
    assert ties
    for s, c, w in ties[:50]:
        assert w == np.nonzero((idx == s) & (rows[:, c] == rows[w, c]))[0].max()


# ---------------------------------------------------------------------------
# module 11: splat, distribute, distribute_module
# ---------------------------------------------------------------------------


def test_splat_and_its_gradient():
    _, _, vals, _, hj, ht = _data()
    _close(tops.splat(_t(vals), ht.splat_idx, ht.splat_weights, CAPS[0]),
           jops.splat(jnp.asarray(vals), hj.splat_idx, hj.splat_weights, CAPS[0]))  # fmt: skip
    _close(tnm.SplatModule()(_t(vals), ht.splat_idx, ht.splat_weights, CAPS[0]),
           jops.splat(jnp.asarray(vals), hj.splat_idx, hj.splat_weights, CAPS[0]))  # fmt: skip
    _grads(lambda v: jops.splat(v, hj.splat_idx, hj.splat_weights, CAPS[0]),
           lambda v: tops.splat(v, ht.splat_idx, ht.splat_weights, CAPS[0]), vals)  # fmt: skip


@pytest.mark.parametrize("local_mean", [True, False])
def test_distribute_and_distribute_module(local_mean):
    pts, mask, vals, _, hj, ht = _data()
    rj, ij = jops.distribute(jnp.asarray(pts), jnp.asarray(vals), hj.splat_idx, hj.splat_weights, CAPS[0],
                             point_mask=jnp.asarray(mask), subtract_local_mean=local_mean)  # fmt: skip
    rt, it = tops.distribute(_t(pts), _t(vals), ht.splat_idx, ht.splat_weights, CAPS[0],
                             point_mask=_t(mask), subtract_local_mean=local_mean)  # fmt: skip
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(rt, rj)
    if local_mean:
        rm, im = tnm.distribute_module(_t(pts), _t(vals), ht.splat_idx, ht.splat_weights, CAPS[0], _t(mask))
        rmj, _ = jnm.distribute_module(jnp.asarray(pts), jnp.asarray(vals), hj.splat_idx,
                                       hj.splat_weights, CAPS[0], jnp.asarray(mask))  # fmt: skip
        _close(rm, rmj)
        np.testing.assert_array_equal(im.numpy(), it.numpy())


# ---------------------------------------------------------------------------
# module 12: slice and gather
# ---------------------------------------------------------------------------


def test_slice_and_gather_lattice():
    _, _, _, lv, hj, ht = _data()
    for fj, ft in ((jops.slice_lattice, tops.slice_lattice), (jops.gather_lattice, tops.gather_lattice)):
        _close(ft(_t(lv), ht.splat_idx, ht.splat_weights), fj(jnp.asarray(lv), hj.splat_idx, hj.splat_weights))
        _grads(lambda v, w, fj=fj: fj(v, hj.splat_idx, w), lambda v, w, ft=ft: ft(v, ht.splat_idx, w),
               lv, np.asarray(hj.splat_weights))  # fmt: skip
    _close(tnm.SliceModule()(_t(lv), ht.splat_idx, ht.splat_weights),
           jops.slice_lattice(jnp.asarray(lv), hj.splat_idx, hj.splat_weights))  # fmt: skip


# ---------------------------------------------------------------------------
# module 13: blur, depthwise conv, expand, the splatting mask
# ---------------------------------------------------------------------------


def test_blur_and_bilateral_blur():
    _, _, _, lv, hj, ht = _data()
    nj, nt = hj.neighbors_same[0], ht.neighbors_same[0]
    for axis in range(4):
        _close(tops.blur(_t(lv), nt, axis), jops.blur(jnp.asarray(lv), nj, axis))
    with pytest.raises(ValueError, match="out of range"):
        tops.blur(_t(lv), nt, 4)
    _close(tops.bilateral_blur(_t(lv), nt), jops.bilateral_blur(jnp.asarray(lv), nj))
    _grads(lambda v: jops.bilateral_blur(v, nj), lambda v: tops.bilateral_blur(v, nt), lv)


def test_depthwise_conv():
    _, _, _, lv, hj, ht = _data()
    w = np.random.default_rng(3).normal(size=(9, C)).astype(np.float32)
    for lvl, same in ((0, True), (0, False)):
        nj = hj.neighbors_same[lvl] if same else hj.neighbors_coarsen[0]
        nt = ht.neighbors_same[lvl] if same else ht.neighbors_coarsen[0]
        _close(tops.depthwise_conv(_t(lv), nt, _t(w), same), jops.depthwise_conv(jnp.asarray(lv), nj, jnp.asarray(w), same))
        _grads(lambda v, k, nj=nj, same=same: jops.depthwise_conv(v, nj, k, same),
               lambda v, k, nt=nt, same=same: tops.depthwise_conv(v, nt, k, same), lv, w)  # fmt: skip


def _expand_both(noise, seed=11):
    pts, mask, vals, _, _, _ = _data()
    n = 1024
    p, m, v = pts[:n], mask[:n].copy(), vals[:n]
    m[-50:] = False
    gen = torch.Generator().manual_seed(seed)
    st, vid, w, sv = tops.expand(_t(p), SIGMA, 8192, 2, noise, gen, values=_t(v), point_mask=_t(m))
    return p, m, v, (st, vid, w, sv)


def test_expand_without_noise_equals_jax():
    p, m, v, (st, vid, w, sv) = _expand_both(0.0)
    sj, vidj, wj, svj = jops.expand(jnp.asarray(p), SIGMA, 8192, 2, 0.0, jax.random.PRNGKey(0),
                                    values=jnp.asarray(v), point_mask=jnp.asarray(m))  # fmt: skip
    np.testing.assert_array_equal(st.keys.numpy(), np.asarray(sj.keys))
    assert int(st.nr_verts) == int(sj.nr_verts) and int(st.nr_overflow) == int(sj.nr_overflow)
    np.testing.assert_array_equal(vid.numpy(), np.asarray(vidj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    _close(sv, svj)


def test_expand_with_noise_is_the_structure_of_its_noisy_points():
    noise = 0.2
    p, m, v, (st, vid, w, sv) = _expand_both(noise, seed=12)
    # the port's draws, again from its generator's seed
    reps = np.tile(p, (2, 1))
    drawn = torch.randn(reps.shape, generator=torch.Generator().manual_seed(12)).numpy()
    expanded = np.concatenate([p, reps + noise * drawn])
    sj, vidj, wj = js.build_structure(jnp.asarray(expanded), SIGMA, 8192, point_mask=jnp.asarray(np.tile(m, 3)))
    np.testing.assert_array_equal(st.keys.numpy(), np.asarray(sj.keys))
    np.testing.assert_array_equal(vid.numpy(), np.asarray(vidj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    pad = np.zeros((2 * len(p), C), np.float32)
    _close(sv, jops.splat(jnp.asarray(np.concatenate([v, pad])), vidj, wj, 8192))
    assert int(st.nr_verts) > int(tops.expand(_t(p), SIGMA, 8192, 2, 0.0, None)[0].nr_verts)


def test_create_splatting_mask_keeps_every_edge_under_the_cap():
    _, _, _, _, hj, ht = _data()
    counts = np.asarray(jops.segment_sum(jnp.ones((N * 4, 1)), hj.splat_idx.reshape(-1), CAPS[0]))[:, 0]
    cap_pts = int(counts.max())
    mj = jops.create_splatting_mask(jax.random.PRNGKey(0), hj.splat_idx, cap_pts, CAPS[0])
    mt = tops.create_splatting_mask(torch.Generator().manual_seed(0), ht.splat_idx, cap_pts, CAPS[0])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(hj.splat_idx) < CAPS[0])


def test_create_splatting_mask_survivors_match_the_expectation():
    _, _, _, _, hj, ht = _data()
    max_pts = 4
    flat = np.asarray(hj.splat_idx).reshape(-1)
    valid = flat < CAPS[0]
    counts = np.asarray(jops.segment_sum(jnp.ones((N * 4, 1)), jnp.asarray(flat), CAPS[0]))[:, 0]
    p = np.minimum(1.0, max_pts / np.maximum(counts[np.minimum(flat, CAPS[0] - 1)], 1.0))[valid]
    expect, var = p.sum(), (p * (1 - p)).sum()
    assert p.min() < 0.5  # the cap bites
    sure = np.zeros_like(valid)
    sure[np.nonzero(valid)[0][p == 1.0]] = True
    survivors = []
    for seed in range(DRAWS):
        mt = tops.create_splatting_mask(torch.Generator().manual_seed(seed), ht.splat_idx, max_pts, CAPS[0])
        m = mt.numpy().reshape(-1)
        assert not m[~valid].any() and m[sure].all()
        survivors.append(m.sum())
    bound = SURVIVOR_SIGMAS * np.sqrt(var / DRAWS)
    assert abs(np.mean(survivors) - expect) <= bound, (np.mean(survivors), expect, bound)
    # JAX's own draw lies in the same band (one draw: sqrt(var))
    mj = np.asarray(jops.create_splatting_mask(jax.random.PRNGKey(0), hj.splat_idx, max_pts, CAPS[0]))
    assert abs(mj.sum() - expect) <= SURVIVOR_SIGMAS * np.sqrt(var)
