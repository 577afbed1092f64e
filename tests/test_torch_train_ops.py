"""The port's backward operators vs the JAX package, on the CPU.

* The im2row conv's flip-neighbours adjoint (value and weight gradients)
  against ``jax.vjp`` of ``conv_im2row`` with ``neighbors_t``, for the
  same-level table and both cross-level directions: f32, to 1e-5 relative
  plus 1e-5 absolute (sums of O(1) products in another order).  The weight
  gradient sums over every one of ~1000 query rows, so its absolute
  tolerance is 2e-6 of its largest entry instead.
* K1's adjoint (``patch_scatter_plain``, the plain version of K1-bwd)
  against ``_patch_gather_bwd``: an f32 scatter-add in the same index
  order, bit-equal.
* K2's adjoint (``seg_max_carry_bwd_plain``, the plain version of K2-bwd)
  against ``_seg_max_fast_bwd`` (the Pallas scan in interpret mode) on
  integer-valued inputs full of ties: ``d_vals`` bit-equal, ``d_carry`` to
  2e-5 absolute (a sum of up to C unit-normal cotangents in another order:
  a few ulps of partial sums that reach ~30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.ops_tpu import patch as jpatch
from lattice_net_tpu.ops_tpu import segment as jseg
from lattice_net_tpu_torch.interop import hierarchy_from_numpy
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.ops_cuda import patch as tpatch
from lattice_net_tpu_torch.ops_cuda import segment as tseg

torch.set_num_threads(2)

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
DW_ATOL_OF_MAX = 2e-6
CARRY_ATOL = 2e-5
CAPS = (1024, 512)


@pytest.fixture(scope="module")
def hier():
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(3000, 3)) * 2.0).astype(np.float32)
    hj = js.build_hierarchy(jnp.asarray(pts), 0.35, 1, CAPS)
    return hj, hierarchy_from_numpy(hj, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


# table, its pair, rows of the source values
CONVS = {
    "same": ("neighbors_same", "neighbors_same", CAPS[0]),
    "coarsen": ("neighbors_coarsen", "neighbors_finefy", CAPS[0]),
    "finefy": ("neighbors_finefy", "neighbors_coarsen", CAPS[1]),
}


@pytest.mark.parametrize("kind", sorted(CONVS))
def test_conv_adjoint_matches_jax_vjp(hier, kind):
    hj, ht = hier
    table, pair, cap_src = CONVS[kind]
    same = kind == "same"
    nj, ntj = getattr(hj, table)[0], getattr(hj, pair)[0]
    nt, ntt = getattr(ht, table)[0], getattr(ht, pair)[0]
    c_in, c_out = 12, 10
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(cap_src, c_in)).astype(np.float32)
    w = (rng.normal(size=(9 * c_in, c_out)) * 0.1).astype(np.float32)
    g = rng.normal(size=(nj.shape[0], c_out)).astype(np.float32)

    def jconv(v, wt):
        return jops.conv_im2row(v, nj, wt, same_level=same, neighbors_t=ntj)

    out_j, vjp = jax.vjp(jconv, jnp.asarray(vals), jnp.asarray(w))
    dv_j, dw_j = vjp(jnp.asarray(g))

    v_t = _t(vals).requires_grad_()
    w_t = _t(w).requires_grad_()
    # same-level convs pair with their own table by default
    out_t = tops.conv_im2row(v_t, nt, w_t, same, torch.float32, neighbors_t=None if same else ntt)
    dv_t, dw_t = torch.autograd.grad(out_t, (v_t, w_t), _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **CONV_TOL)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), **CONV_TOL)
    dw_j = np.asarray(dw_j)
    np.testing.assert_allclose(
        dw_t.numpy(), dw_j, rtol=CONV_TOL["rtol"], atol=DW_ATOL_OF_MAX * np.abs(dw_j).max()
    )
    assert dv_t.dtype == dw_t.dtype == torch.float32


def test_conv_adjoint_is_the_transpose(hier):
    # <conv(v), g> == <v, adjoint(g)>: the flipped conv over the paired
    # table is the exact transpose of the gather-and-multiply
    _, ht = hier
    rng = np.random.default_rng(2)
    v = _t(rng.normal(size=(CAPS[0], 6)).astype(np.float64)).requires_grad_()
    w = _t(rng.normal(size=(54, 5)).astype(np.float64))
    g = _t(rng.normal(size=(CAPS[1], 5)).astype(np.float64))
    nt, ntt = ht.neighbors_coarsen[0], ht.neighbors_finefy[0]
    out = tops.conv_im2row(v, nt, w, False, torch.float64, neighbors_t=ntt)
    (dv,) = torch.autograd.grad(out, v, g)
    assert torch.allclose((out * g).sum(), (v * dv).sum(), rtol=1e-12, atol=0)


def test_cross_level_value_gradient_needs_the_pair(hier):
    _, ht = hier
    v = torch.randn(CAPS[0], 4)
    w = torch.randn(36, 3, requires_grad=True)
    out = tops.conv_im2row(v, ht.neighbors_coarsen[0], w, False, torch.float32)
    (dw,) = torch.autograd.grad(out.sum(), w)  # the weight gradient needs no pair
    assert dw.shape == w.shape
    with pytest.raises(NotImplementedError):
        tops.conv_im2row(v.requires_grad_(), ht.neighbors_coarsen[0], w, False, torch.float32)


def test_flip_filter_bank_matches_jax():
    w = np.random.default_rng(3).normal(size=(9 * 4, 6)).astype(np.float32)
    ref = jops._flip_filter_bank(jnp.asarray(w), 9, 4, 6)
    np.testing.assert_array_equal(np.asarray(ref), tops._flip_filter_bank(_t(w), 9, 4, 6).numpy())
    for k in (8, 9):
        assert tops._swap_pm_perm(k) == list(jops._swap_pm_perm(k))


@pytest.mark.parametrize(
    "table,center", [("same", True), ("same", False), ("coarsen", False), ("head", False)]
)
def test_patch_adjoint_plain_matches_jax(hier, table, center):
    hj, ht = hier
    if table == "head":
        nbr = np.array(hj.splat_idx)
        nbr[::7, 1] = CAPS[0]  # invalid ids drop
    else:
        nbr = np.array(getattr(hj, f"neighbors_{table}")[0])
    cap = CAPS[0]
    q, k = nbr.shape
    g = np.random.default_rng(4).normal(size=(q, k + int(center), 7)).astype(np.float32)
    proto = jnp.zeros((cap, 0), jnp.float32)
    ref, _ = jpatch._patch_gather_bwd(center, (proto, jnp.asarray(nbr)), jnp.asarray(g))
    got = tpatch.patch_scatter_plain(_t(g), _t(nbr), cap, center)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # the differentiable gather's backward on the CPU is that plain version
    v = torch.zeros(cap, 7, requires_grad=True)
    (dv,) = torch.autograd.grad(tpatch.patch_gather(v, _t(nbr), center), v, _t(g))
    assert torch.equal(dv, got)


def test_patch_scatter_wrapper_on_cpu_is_plain_and_uncounted(hier):
    _, ht = hier
    g = torch.randn(CAPS[0], 9, 5)
    before = tpatch.patch_scatter.launches
    got = tpatch.patch_scatter(g, ht.neighbors_same[0], CAPS[0], True)
    assert torch.equal(got, tpatch.patch_scatter_plain(g, ht.neighbors_same[0], CAPS[0], True))
    assert tpatch.patch_scatter.launches == before
    with pytest.raises(ValueError):
        tpatch.patch_scatter(g.to("meta"), ht.neighbors_same[0].to("meta"), CAPS[0], True)
    with pytest.raises(TypeError):
        tpatch._check_scatter(g.double(), ht.neighbors_same[0], CAPS[0], True)
    with pytest.raises(ValueError):
        tpatch._check_scatter(g[:, :8], ht.neighbors_same[0], CAPS[0], True)


@pytest.mark.parametrize("negative", ["below_minus_cap", "minus_cap_to_minus_one"])
def test_patch_adjoint_plain_with_invalid_ids(hier, negative):
    # ids = cap and ids below -cap drop on both sides.  Ids in [-cap, -1] lie
    # outside the reference's convention (invalid = cap): JAX's scatter-add
    # wraps them to cap + id, while the port drops them, as its forward
    # gather reads zeros for them
    hj, _ = hier
    cap = CAPS[0]
    nbr = np.array(hj.splat_idx)
    nbr[::7, 1] = cap
    neg = -cap - 5 if negative == "below_minus_cap" else -1
    nbr[::11, 2] = neg
    nbr[::13, 0] = -cap if negative == "minus_cap_to_minus_one" else -2 * cap
    q, k = nbr.shape
    g = np.random.default_rng(14).normal(size=(q, k, 8)).astype(np.float32)
    proto = jnp.zeros((cap, 0), jnp.float32)
    ref, _ = jpatch._patch_gather_bwd(False, (proto, jnp.asarray(nbr)), jnp.asarray(g))
    got = tpatch.patch_scatter_plain(_t(g), _t(nbr), cap, False)
    dropped = np.where(nbr < 0, cap, nbr)
    np.testing.assert_array_equal(
        got.numpy(), tpatch.patch_scatter_plain(_t(g), _t(dropped), cap, False).numpy()
    )
    if negative == "below_minus_cap":
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    else:
        wrapped = np.where(nbr < 0, nbr + cap, nbr)
        want = tpatch.patch_scatter_plain(_t(g), _t(wrapped), cap, False)
        np.testing.assert_array_equal(np.asarray(ref), want.numpy())
        assert not np.array_equal(np.asarray(ref), got.numpy())


def test_patch_scatter_checks_ids_and_alignment(hier):
    _, ht = hier
    nbr = ht.neighbors_same[0]
    q, k = nbr.shape
    with pytest.raises(TypeError):
        tpatch._check_scatter(torch.zeros(q, k + 1, 8), nbr.long(), CAPS[0], True)
    # the kernel reads C % 4 == 0 rows as float4: a view 4 bytes into a
    # buffer is refused there, and taken at other widths (scalar atomics)
    with pytest.raises(ValueError, match="16-byte"):
        tpatch._check_scatter(torch.empty(q * (k + 1) * 8 + 1)[1:].view(q, k + 1, 8), nbr, CAPS[0], True)
    tpatch._check_scatter(torch.empty(q * (k + 1) * 13 + 1)[1:].view(q, k + 1, 13), nbr, CAPS[0], True)


def _seg_case(hier, c, seed):
    hj, ht = hier
    m = hj.edges.vertex.shape[0]
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, size=(m, c)).astype(np.float32)  # exact ties
    carry = rng.normal(size=(m,)).astype(np.float32)
    g_max = rng.normal(size=(CAPS[0], c)).astype(np.float32)
    g_carry = rng.normal(size=(CAPS[0], c)).astype(np.float32)
    return hj, ht, vals, carry, g_max, g_carry


@pytest.mark.parametrize("c", [16, 32])
def test_seg_max_adjoint_plain_matches_jax(hier, c):
    hj, ht, vals, carry, g_max, g_carry = _seg_case(hier, c, 5)
    e = hj.edges
    maxed, _ = jseg._seg_max_pallas_impl(
        jnp.asarray(vals), jnp.asarray(carry), e.vertex, e.ends, CAPS[0], interpret=True
    )
    res = (jnp.asarray(vals), e.vertex, e.ends, maxed)
    dv_j, dc_j, _, _ = jseg._seg_max_fast_bwd(
        CAPS[0], res, (jnp.asarray(g_max), jnp.asarray(g_carry))
    )
    # the ties are real: some (vertex, channel) has several maximal edges
    ids = np.asarray(e.vertex)
    hits = np.zeros((CAPS[0] + 1, c))
    np.add.at(hits, np.minimum(ids, CAPS[0]), vals == np.asarray(maxed)[np.minimum(ids, CAPS[0] - 1)])
    assert hits[: CAPS[0]].max() > 1

    v_t = _t(vals).requires_grad_()
    c_t = _t(carry).requires_grad_()
    mx, cw = tops.seg_max_sorted(v_t, c_t, ht.edges, CAPS[0])
    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(maxed))
    dv_t, dc_t = torch.autograd.grad((mx, cw), (v_t, c_t), (_t(g_max), _t(g_carry)))
    np.testing.assert_array_equal(dv_t.numpy(), np.asarray(dv_j))
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), rtol=0, atol=CARRY_ATOL)


def test_seg_max_bwd_wrapper_on_cpu_is_plain_and_checked(hier):
    _, ht, vals, carry, g_max, g_carry = _seg_case(hier, 8, 6)
    e = ht.edges
    maxed, _ = tseg.seg_max_carry_plain(_t(vals), _t(carry), e.vertex, e.run_end)
    args = (_t(vals), e.vertex, e.run_end, maxed, _t(g_max), _t(g_carry))
    before = tseg.seg_max_carry_bwd.launches
    got = tseg.seg_max_carry_bwd(*args)
    want = tseg.seg_max_carry_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tseg.seg_max_carry_bwd.launches == before
    vals_t, ids, run_end, maxed, gm, gc = args
    tseg._check_bwd(*args)
    with pytest.raises(ValueError):
        tseg._check_bwd(vals_t, ids, run_end, maxed[:10], gm, gc)
    with pytest.raises(ValueError):
        tseg._check_bwd(vals_t, ids[:-1], run_end, maxed, gm, gc)
    with pytest.raises(TypeError):
        tseg._check_bwd(vals_t, ids, run_end.long(), maxed, gm, gc)
    with pytest.raises(TypeError):
        tseg._check_bwd(vals_t, ids.long(), run_end, maxed, gm, gc)
    # the kernel reads C % 4 == 0 rows as float4: a view 4 bytes into a buffer
    # is refused there, and taken at other widths (the scalar kernel)
    shifted = torch.empty(vals_t.numel() + 1)[1:].view(vals_t.shape).copy_(vals_t)
    with pytest.raises(ValueError, match="16-byte"):
        tseg._check_bwd(shifted, ids, run_end, maxed, gm, gc)
    narrow = (t[:, :7].contiguous() for t in (maxed, gm, gc))
    tseg._check_bwd(torch.empty(vals_t.shape[0] * 7 + 1)[1:].view(-1, 7), ids, run_end, *narrow)
    with pytest.raises(ValueError):
        tseg.seg_max_carry_bwd(*(t.to("meta") for t in args))
