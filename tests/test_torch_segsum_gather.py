"""K3 (segmented sum) and K4 (clamped row gather): their plain versions,
adjoints and the edge-sort head gather vs the JAX package, on the CPU.

* K4's plain version (``take_rows_plain``, which the wrapper runs for CPU
  tensors) equals ``take_rows_reference`` and the Pallas kernel in
  interpret mode bit for bit, in f32 and bf16, with ids >= cap clamped.
  Its adjoint (an f32 scatter-add at the clamped ids) matches ``jax.vjp``
  of ``take_rows`` to 1e-6, including the cotangent of clamped ids that
  lands on row cap - 1.
* K3's plain version matches ``seg_sum_sorted_fast`` (its XLA path on the
  CPU) to 1e-6 relative, at C = 28 (the head's preclassified width) and
  C = 8 + 48 (the gather-then-classify width of the tests' small model),
  on a masked build with invalid trailing edges and empty rows.  Both
  adjoints (sum -> broadcast, broadcast -> sum) match the JAX backward
  rules (``jax.grad`` cannot differentiate that pair, see below).
* ``gather_rows_clustered_segbwd`` equals ``gather_rows_clustered`` in the
  forward; its gradient matches the JAX ``gather_rows_clustered_segbwd`` on
  a mask-free and a masked build to 1e-6 (f32 sums of the same rows in
  another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.ops_tpu import gather as jgather
from lattice_net_tpu.ops_tpu import segment as jseg
from lattice_net_tpu_torch.interop import hierarchy_from_numpy
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.ops_cuda import gather as tgather
from lattice_net_tpu_torch.ops_cuda import segment as tseg

torch.set_num_threads(2)

TOL = 1e-6
CAP = 1024


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30)
    )


@pytest.fixture(scope="module")
def hiers():
    """One mask-free and one masked build of a 1200-point cloud: the masked
    one has invalid trailing edges, and both leave rows past nr_verts
    empty."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (1200, 3)).astype(np.float32)
    # jitted: the eager build dispatches op by op and takes 10x longer
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=0.7, nr_levels=1,
                                      capacities=(CAP, CAP // 2)))  # fmt: skip
    out = []
    for mask in (None, np.arange(1200) < 1100):
        hj = build(jnp.asarray(pos), point_mask=None if mask is None else jnp.asarray(mask))
        out.append((hj, hierarchy_from_numpy(hj, device="cpu")))
    return out


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _take_inputs(seed, cap=512, c=28, m=2000):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(cap, c)).astype(np.float32)
    idx = rng.integers(0, cap + 40, size=(m,)).astype(np.int32)  # some ids >= cap
    return vals, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_plain_matches_reference_and_pallas(dtype):
    vals, idx = _take_inputs(1)
    assert (idx >= vals.shape[0]).sum() > 0
    vj = jnp.asarray(vals, getattr(jnp, dtype))
    ref = jgather.take_rows_reference(vj, jnp.asarray(idx))
    pallas = jgather._take_rows_impl(vj, jnp.asarray(idx), interpret=True)
    got = tgather.take_rows_plain(_t(vals).to(getattr(torch, dtype)), _t(idx))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(np.asarray(ref, np.float32), got.float().numpy())
    np.testing.assert_array_equal(np.asarray(pallas, np.float32), got.float().numpy())


def test_take_rows_vjp_matches_jax():
    vals, idx = _take_inputs(2)
    ct = np.random.default_rng(3).normal(size=(idx.shape[0], vals.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jgather.take_rows(v, jnp.asarray(idx)), jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(ct))
    v = _t(vals).requires_grad_()
    tgather.take_rows(v, _t(idx)).backward(_t(ct))
    _close(v.grad.numpy(), want)
    # the clamped ids' cotangent lands on the last row
    last = ct[idx >= vals.shape[0] - 1].sum(0)
    _close(v.grad[-1].numpy(), last)


def test_take_rows_vjp_keeps_the_values_dtype():
    vals, idx = _take_inputs(4, c=8)
    v = _t(vals).bfloat16().requires_grad_()
    tgather.take_rows(v, _t(idx)).sum().backward()
    assert v.grad.dtype == torch.bfloat16
    want = torch.zeros(vals.shape).index_add_(0, _t(idx).long().clamp(max=511), torch.ones(2000, 8))
    torch.testing.assert_close(v.grad.float(), want.bfloat16().float(), rtol=0, atol=0)


def test_gather_rows_matches_jax():
    vals, _ = _take_inputs(5)
    idx2 = np.random.default_rng(6).integers(0, 530, size=(700, 4)).astype(np.int32)
    ref = jops.gather_rows(jnp.asarray(vals), jnp.asarray(idx2))
    got = tops.gather_rows(_t(vals), _t(idx2))
    assert got.shape == (700, 4, 28)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_take_rows_wrapper_on_cpu_is_plain_and_uncounted():
    vals, idx = _take_inputs(7)
    before = tgather.take_rows.launches
    got = tgather.take_rows(_t(vals), _t(idx))
    assert torch.equal(got, tgather.take_rows_plain(_t(vals), _t(idx)))
    assert tgather.take_rows.launches == before


def test_take_rows_input_checks():
    vals, idx = torch.zeros(16, 8), torch.zeros(30, dtype=torch.int32)
    tgather._check(vals, idx)
    with pytest.raises(TypeError):
        tgather._check(vals, idx.long())
    with pytest.raises(ValueError):
        tgather._check(vals.t(), idx)
    with pytest.raises(ValueError):
        tgather._check(vals, idx[None])
    with pytest.raises(ValueError):
        tgather._check(vals[:0], idx)
    with pytest.raises(ValueError):  # neither the plain version's nor the kernel's device
        tgather.take_rows(vals.to("meta"), idx.to("meta"))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["mask_free", "masked"])
@pytest.mark.parametrize("c", [28, 8 + 48])
def test_seg_sum_plain_matches_jax(hiers, masked, c):
    hj, ht = hiers[int(masked)]
    ids = np.asarray(hj.edges.vertex)
    nr = int(hj.structures[0].nr_verts)
    assert nr < CAP  # empty rows past nr_verts
    assert (ids >= CAP).any() == masked  # invalid trailing edges
    vals = np.random.default_rng(c).normal(size=(ids.shape[0], c)).astype(np.float32)
    want = jseg.seg_sum_sorted_fast(jnp.asarray(vals), jnp.asarray(ids), CAP)
    e = ht.edges
    got = tseg.seg_sum_sorted_fast(_t(vals), e.vertex, e.run_end, CAP)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    assert not got[nr:].any()
    _close(tseg.seg_sum_sorted_plain(_t(vals), e.vertex, CAP).numpy(), want)
    # the dispatcher: K3 for C > 8, in the input's dtype
    want = jops.seg_sum_sorted(jnp.asarray(vals), hj.edges, CAP)
    _close(tops.seg_sum_sorted(_t(vals), e, CAP).numpy(), want)


def test_seg_sum_adjoints_match_jax(hiers):
    # jax.grad cannot differentiate seg_sum_sorted_fast or
    # seg_broadcast_sorted_fast: their custom_vjp forward rules keep a dtype
    # in the residuals, which JAX refuses (test below); the JAX model only
    # calls the sum inside another backward.  So the port is held against
    # the two backward rules themselves.
    hj, ht = hiers[1]
    ids, e = jnp.asarray(hj.edges.vertex), ht.edges
    m, c = ids.shape[0], 28
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(m, c)).astype(np.float32)
    ct_sum = rng.normal(size=(CAP, c)).astype(np.float32)
    table = rng.normal(size=(CAP, c)).astype(np.float32)
    ct_bc = rng.normal(size=(m, c)).astype(np.float32)

    # sum -> its adjoint, the masked broadcast
    (want,) = jseg._seg_sum_bwd(CAP, (ids, jnp.float32), jnp.asarray(ct_sum))[:1]
    v = _t(vals).requires_grad_()
    tseg.seg_sum_sorted_fast(v, e.vertex, e.run_end, CAP).backward(_t(ct_sum))
    _close(v.grad.numpy(), want)
    assert not v.grad[np.asarray(ids) >= CAP].any()

    # broadcast -> its adjoint, the segmented sum
    (want,) = jseg._seg_broadcast_bwd((ids, CAP, jnp.float32), jnp.asarray(ct_bc))[:1]
    t = _t(table).requires_grad_()
    got_bc = tseg.seg_broadcast_sorted(t, e.vertex, e.run_end)
    want_bc = jseg.seg_broadcast_sorted_fast(jnp.asarray(table), ids)
    np.testing.assert_array_equal(got_bc.detach().numpy(), np.asarray(want_bc))
    got_bc.backward(_t(ct_bc))
    _close(t.grad.numpy(), want)


def test_jax_cannot_differentiate_its_seg_sum_pair():
    # the reference fault the test above works around
    ids = jnp.asarray([0, 0, 1, 2, 2, 3], jnp.int32)
    with pytest.raises(TypeError):
        jax.grad(lambda v: jseg.seg_sum_sorted_fast(v, ids, 4).sum())(jnp.ones((6, 9)))
    with pytest.raises(TypeError):
        jax.grad(lambda t: jseg.seg_broadcast_sorted_fast(t, ids).sum())(jnp.ones((4, 9)))


def test_seg_sum_wrapper_on_cpu_is_uncounted_and_checks(hiers):
    _, ht = hiers[0]
    e = ht.edges
    vals = torch.randn(e.vertex.shape[0], 12)
    before = tseg.seg_sum_sorted_fast.launches
    got = tseg.seg_sum_sorted_fast(vals, e.vertex, e.run_end, CAP)
    assert torch.equal(got, tseg.seg_sum_sorted_plain(vals, e.vertex, CAP))
    assert tseg.seg_sum_sorted_fast.launches == before
    tseg._check_sum(vals, e.run_end, CAP)
    with pytest.raises(TypeError):
        tseg._check_sum(vals.double(), e.run_end, CAP)
    with pytest.raises(TypeError):
        tseg._check_sum(vals, e.run_end.long(), CAP)
    with pytest.raises(ValueError):
        tseg._check_sum(vals, e.run_end[:-1], CAP)
    with pytest.raises(ValueError):
        tseg.seg_sum_sorted_fast(vals.to("meta"), e.vertex, e.run_end, CAP)


# ---------------------------------------------------------------------------
# the edge-sort head gather: K4 forward, K3 adjoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["mask_free", "masked"])
def test_head_gather_segbwd_matches_jax(hiers, masked):
    hj, ht = hiers[int(masked)]
    rng = np.random.default_rng(10)
    n, d1 = hj.splat_idx.shape
    vals = rng.normal(size=(CAP, 28)).astype(np.float32)
    ct = rng.normal(size=(n, d1, 28)).astype(np.float32)

    def loss(v):
        return jnp.vdot(jops.gather_rows_clustered_segbwd(v, hj.splat_idx, hj.edges), jnp.asarray(ct))

    want = jax.grad(loss)(jnp.asarray(vals))
    for plain in (False, True):
        v = _t(vals).requires_grad_()
        out = tops.gather_rows_clustered_segbwd(v, ht.splat_idx, ht.edges, plain=plain)
        np.testing.assert_array_equal(
            out.detach().numpy(), tops.gather_rows_clustered(_t(vals), ht.splat_idx).numpy()
        )
        out.backward(_t(ct))
        _close(v.grad.numpy(), want)
    # the scatter adjoint of the K1 head gather gives the same gradient
    v = _t(vals).requires_grad_()
    tops.gather_rows_clustered(v, ht.splat_idx).backward(_t(ct))
    _close(v.grad.numpy(), want)


def test_head_gather_segbwd_keeps_bf16(hiers):
    _, ht = hiers[1]
    v = torch.randn(CAP, 16).bfloat16().requires_grad_()
    out = tops.gather_rows_clustered_segbwd(v, ht.splat_idx, ht.edges)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert v.grad.dtype == torch.bfloat16
    ones = torch.ones(ht.splat_idx.numel())
    counts = torch.zeros(CAP + 1).index_add_(0, ht.splat_idx.reshape(-1).long(), ones)
    torch.testing.assert_close(v.grad[:, 0].float(), counts[:CAP], rtol=0, atol=0)
