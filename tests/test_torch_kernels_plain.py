"""The kernels' plain PyTorch versions and the lattice ops vs the JAX package.

K1 (patch gather) and K2 (segmented max with carry) are CUDA kernels; their
plain versions, which the wrappers run for CPU tensors and which the card
run holds the kernels against, must equal the JAX functions bit for bit:
both the XLA formulations and the Pallas kernels in interpret mode.  The
f32 ops around them (distribute, segment sums, the conv) compare to 1e-5
absolute: inputs are O(1) and the sums run in another order.
"""

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

F32_ATOL = 1e-5


@pytest.fixture(scope="module")
def hier():
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(3000, 3)) * 2.0).astype(np.float32)
    feats = rng.normal(size=(3000, 2)).astype(np.float32)
    hj = js.build_hierarchy(jnp.asarray(pts), 0.35, 1, (1024, 512), point_feats=jnp.asarray(feats))
    return hj, hierarchy_from_numpy(hj, device="cpu"), pts, feats


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("include_center", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_patch_plain_matches_xla_same_level(hier, include_center, dtype):
    hj, ht, _, _ = hier
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(1024, 32)).astype(np.float32)
    ref = jops.gather_neighbor_values_xla(
        jnp.asarray(vals, getattr(jnp, dtype)), hj.neighbors_same[0], include_center
    )
    got = tpatch.patch_gather_plain(
        _t(vals).to(getattr(torch, dtype)), ht.neighbors_same[0], include_center
    )
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


@pytest.mark.parametrize("table", ["coarsen", "finefy"])
def test_patch_plain_matches_xla_cross_level(hier, table):
    hj, ht, _, _ = hier
    nj = getattr(hj, f"neighbors_{table}")[0]
    nt = getattr(ht, f"neighbors_{table}")[0]
    cap_src = 1024 if table == "coarsen" else 512
    vals = np.random.default_rng(2).normal(size=(cap_src, 16)).astype(np.float32)
    ref = jops.gather_neighbor_values_xla(jnp.asarray(vals, jnp.bfloat16), nj, False)
    got = tpatch.patch_gather_plain(_t(vals).bfloat16(), nt, False)
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


def _pallas_patch(values, neighbors, include_center):
    w = jpatch.window_width(values.shape[0], neighbors.shape[0])
    ids, ws, ok, _ = jpatch._prepare(neighbors, values.shape[0], w)
    assert bool(ok), "test cloud should be window-coverable"
    out = jpatch._patch_gather_pallas(values.T, ids, ws, include_center, w, interpret=True)
    return out.transpose(2, 0, 1)[: neighbors.shape[0]]


@pytest.mark.parametrize("include_center", [True, False])
def test_patch_plain_matches_pallas_interpret(hier, include_center):
    hj, ht, _, _ = hier
    vals = np.random.default_rng(3).normal(size=(1024, 32)).astype(np.float32)
    ref = _pallas_patch(jnp.asarray(vals, jnp.bfloat16), hj.neighbors_same[0], include_center)
    got = tpatch.patch_gather_plain(_t(vals).bfloat16(), ht.neighbors_same[0], include_center)
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


def test_patch_plain_matches_pallas_interpret_coarsen(hier):
    hj, ht, _, _ = hier
    vals = np.random.default_rng(4).normal(size=(1024, 16)).astype(np.float32)
    ref = _pallas_patch(jnp.asarray(vals, jnp.bfloat16), hj.neighbors_coarsen[0], False)
    got = tpatch.patch_gather_plain(_t(vals).bfloat16(), ht.neighbors_coarsen[0], False)
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


def test_head_gather_matches(hier):
    # the head's per-point gather: (N, d+1) splat ids into an f32 table
    hj, ht, _, _ = hier
    vals = np.random.default_rng(5).normal(size=(1024, 28)).astype(np.float32)
    idx = np.array(hj.splat_idx)
    idx[::7, 1] = 1024  # invalid ids read zero rows
    ref = jops.gather_rows_clustered(jnp.asarray(vals), jnp.asarray(idx))
    got = tops.gather_rows_clustered(_t(vals), _t(idx))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_patch_wrapper_on_cpu_is_plain_and_uncounted(hier):
    _, ht, _, _ = hier
    vals = torch.randn(1024, 8)
    before = tpatch.patch_gather.launches
    got = tpatch.patch_gather(vals, ht.neighbors_same[0], True)
    assert torch.equal(got, tpatch.patch_gather_plain(vals, ht.neighbors_same[0], True))
    assert tpatch.patch_gather.launches == before


def test_patch_input_checks():
    vals = torch.zeros(16, 8)
    nbr = torch.zeros(16, 8, dtype=torch.int32)
    tpatch._check(vals, nbr, True)
    with pytest.raises(TypeError):
        tpatch._check(vals, nbr.long(), True)
    with pytest.raises(TypeError):
        tpatch._check(vals.double(), nbr, True)
    with pytest.raises(ValueError):
        tpatch._check(vals.t(), nbr[:8], False)
    with pytest.raises(ValueError):
        tpatch._check(vals[:8], nbr, True)
    with pytest.raises(ValueError):  # neither the plain version's nor the kernel's device
        tpatch.patch_gather(vals.to("meta"), nbr.to("meta"), True)


def _seg_inputs(hier, c, seed):
    hj, ht, _, _ = hier
    m = hj.edges.vertex.shape[0]
    rng = np.random.default_rng(seed)
    # integer-valued floats plant many exact ties
    vals = rng.integers(-3, 4, size=(m, c)).astype(np.float32)
    carry = rng.normal(size=(m,)).astype(np.float32)
    return hj, ht, vals, carry


@pytest.mark.parametrize("c", [16, 32])
def test_seg_max_plain_matches_xla(hier, c):
    hj, ht, vals, carry = _seg_inputs(hier, c, 6)
    mj, cj = jops.seg_max_sorted(jnp.asarray(vals), jnp.asarray(carry), hj.edges, 1024)
    mt, ct = tops.seg_max_sorted(_t(vals), _t(carry), ht.edges, 1024)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())


@pytest.mark.parametrize("c", [16, 32])  # 32: the PointNet width of the slice
def test_seg_max_plain_matches_pallas_interpret(hier, c):
    hj, ht, vals, carry = _seg_inputs(hier, c, 7)
    e = hj.edges
    mj, cj = jseg._seg_max_pallas_impl(
        jnp.asarray(vals), jnp.asarray(carry), e.vertex, e.ends, 1024, interpret=True
    )
    mt, ct = tseg.seg_max_carry_plain(_t(vals), _t(carry), ht.edges.vertex, ht.edges.run_end)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())


def test_seg_max_input_checks():
    vals, carry = torch.zeros(10, 4), torch.zeros(10)
    ids, run_end = torch.zeros(10, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    tseg._check(vals, carry, ids, run_end)
    with pytest.raises(TypeError):
        tseg._check(vals.bfloat16(), carry, ids, run_end)
    with pytest.raises(TypeError):
        tseg._check(vals, carry, ids, run_end.long())
    with pytest.raises(ValueError):
        tseg._check(vals, carry[:5], ids, run_end)
    with pytest.raises(ValueError):
        tseg._check(vals.t().contiguous().t(), carry, ids, run_end)
    with pytest.raises(ValueError):
        tseg.seg_max_carry(*(t.to("meta") for t in (vals, carry, ids, run_end)))


@pytest.mark.parametrize("n", [1, 16, 17, 4097, 20000])
def test_cumsum_matches_jax_bitwise(n):
    x = (np.random.default_rng(n).normal(size=(n, 3)) * 20 + 10).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(ref, tops._cumsum_f32(_t(x)).numpy())


def test_segment_reductions_match(hier):
    hj, ht, _, _ = hier
    m = hj.edges.vertex.shape[0]
    vals = np.random.default_rng(8).normal(size=(m, 3)).astype(np.float32) * 10
    for fn in ("seg_sum_sorted", "seg_mean_sorted"):
        ref = getattr(jops, fn)(jnp.asarray(vals), hj.edges, 1024)
        got = getattr(tops, fn)(_t(vals), ht.edges, 1024)
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0, atol=F32_ATOL)
    np.testing.assert_array_equal(
        np.asarray(jops.seg_counts_sorted(hj.edges, 1024)),
        tops.seg_counts_sorted(ht.edges, 1024).numpy(),
    )
    table = np.random.default_rng(9).normal(size=(1024, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jops.take_sorted(jnp.asarray(table), hj.edges.vertex)),
        tops.take_sorted(_t(table), ht.edges.vertex).numpy(),
    )


def test_distribute_sorted_carried_rows(hier):
    hj, ht, pts, feats = hier
    rj, ij = jops.distribute_sorted(jnp.asarray(pts), jnp.asarray(feats), hj.edges, 1024)
    rt, it = tops.distribute_sorted(_t(pts), _t(feats), ht.edges, 1024)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(np.asarray(rj), rt.numpy(), rtol=0, atol=F32_ATOL)


def test_distribute_sorted_needs_carried_rows():
    # a hierarchy built without point_feats carries no rows: the port serves
    # only the carried-rows form and says so
    rng = np.random.default_rng(10)
    pts = (rng.normal(size=(2000, 3)) * 2.0).astype(np.float32)
    hj = js.build_hierarchy(jnp.asarray(pts), 0.35, 1, (1024, 512))
    ht = hierarchy_from_numpy(hj, device="cpu")
    assert ht.edges.rows is None
    with pytest.raises(ValueError):
        tops.distribute_sorted(_t(pts), torch.zeros(2000, 1), ht.edges, 1024)


@pytest.mark.parametrize("table", ["same", "coarsen", "finefy"])
def test_conv_im2row_forward_f32(hier, table):
    hj, ht, _, _ = hier
    nj = getattr(hj, f"neighbors_{table}")[0]
    nt = getattr(ht, f"neighbors_{table}")[0]
    cap_src = 512 if table == "finefy" else 1024
    c_in, c_out = 12, 10
    rng = np.random.default_rng(11)
    vals = rng.normal(size=(cap_src, c_in)).astype(np.float32)
    same = table == "same"
    w = (rng.normal(size=(9 * c_in, c_out)) * 0.1).astype(np.float32)
    ref = jops.conv_im2row(jnp.asarray(vals), nj, jnp.asarray(w), same_level=same)
    got = tops.conv_im2row(_t(vals), nt, _t(w), same, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0, atol=F32_ATOL)


def test_conv_im2row_bf16_on_cpu_returns_f32(hier):
    # bf16 operands, f32 result (JAX: preferred_element_type=f32)
    _, ht, _, _ = hier
    vals = torch.randn(1024, 8)
    w = torch.randn(72, 4)
    got = tops.conv_im2row(vals, ht.neighbors_same[0], w, True, torch.bfloat16)
    patch = tpatch.patch_gather_plain(vals.bfloat16(), ht.neighbors_same[0], True)
    ref = patch.reshape(1024, 72).float() @ w.bfloat16().float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _chunk_tie_edges(c):
    """A sorted edge list whose runs the card's K2 cuts at 32-row chunks:
    vertex 3's 100-edge run starts at row 32 (chunks at 32, 64, 96, 128),
    with equal maxima at rows 31/32 of the run (even channels) and 63/64
    (odd channels); vertices 1 and 5 are empty, and 10 edges with id = cap
    follow the last run."""
    cap = 6
    lengths = [20, 0, 12, 100, 3, 0]
    ids = np.concatenate([np.full(n, v, np.int32) for v, n in enumerate(lengths)])
    ids = np.concatenate([ids, np.full(10, cap, np.int32)])
    rng = np.random.default_rng(12)
    vals = rng.normal(size=(ids.shape[0], c)).astype(np.float32)
    carry = rng.normal(size=(ids.shape[0],)).astype(np.float32)
    start = 32
    for first in (31, 63):
        cols = slice(0, None, 2) if first == 31 else slice(1, None, 2)
        vals[start + first : start + first + 2, cols] = 10.0
    ends = np.full(cap, -1, np.int32)
    ends[np.array(lengths) > 0] = np.cumsum(lengths)[np.array(lengths) > 0] - 1
    return ids, ends, vals, carry, cap, start


@pytest.mark.parametrize("c", [32, 7])  # 32: the packed Pallas kernel; 7: the unpacked one
def test_seg_max_plain_matches_pallas_interpret_chunk_ties(c):
    ids, ends, vals, carry, cap, start = _chunk_tie_edges(c)
    mj, cj = jseg._seg_max_pallas_impl(
        jnp.asarray(vals), jnp.asarray(carry), jnp.asarray(ids), jnp.asarray(ends), cap,
        interpret=True,
    )
    run_end = _t(np.maximum.accumulate(ends))
    mt, ct = tseg.seg_max_carry_plain(_t(vals), _t(carry), _t(ids), run_end)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    # the later row of each tied pair wins; empty vertices give zeros
    assert np.all(mt[3].numpy() == 10.0)
    np.testing.assert_array_equal(ct[3, 0::2].numpy(), carry[start + 32])
    np.testing.assert_array_equal(ct[3, 1::2].numpy(), carry[start + 64])
    assert not mt[[1, 5]].any() and not ct[[1, 5]].any()


def test_seg_max_input_checks_ids_and_alignment():
    m, cap = 10, 5
    carry, ids = torch.zeros(m), torch.zeros(m, dtype=torch.int32)
    run_end = torch.zeros(cap, dtype=torch.int32)
    with pytest.raises(TypeError):
        tseg._check(torch.zeros(m, 8), carry, ids.long(), run_end)
    # the kernel reads C % 4 == 0 rows as float4: a view 4 bytes into a
    # buffer is refused there, and taken at other widths (the scalar kernel)
    with pytest.raises(ValueError, match="16-byte"):
        tseg._check(torch.empty(m * 8 + 1)[1:].view(m, 8), carry, ids, run_end)
    tseg._check(torch.empty(m * 13 + 1)[1:].view(m, 13), carry, ids, run_end)
