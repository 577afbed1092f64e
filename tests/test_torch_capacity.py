"""The port's capacity tools and row-chunked conv vs the JAX package, on the CPU.

* ``capacity_schedule_from_occupancy`` and ``escalate_capacities`` equal
  JAX's on the JAX tests' cases (``tests/test_scannet_scale.py``) and on
  random ones.
* ``compact_hierarchy`` of a large-capacity build gives JAX's
  ``compact_hierarchy`` table for table, row for row; the port's compacted
  hierarchy feeds a forward equal to that of a build made at the small
  capacities, to 1e-5.
* ``scout_occupancy`` equals JAX's on three small indoor scenes of unequal
  size (each padded to the largest with a point mask).
* The 5M-capacity build of a 128-point cloud at two levels (5,242,880 and
  2,621,440: a 31-bit simplex signature, so both packages re-splat) equals
  JAX's, every table.
* The row-chunked conv: ``LNT_CONV_CHUNK_BYTES`` set small on both sides
  (3-5 row blocks, ``cq % nb != 0``), same-level and cross-level tables:
  forward, d_values and d_weight against JAX's chunked ``_conv_flip`` to
  1e-5 relative, and against the port's own unchunked conv; a block that
  starts past row 0 gets its own centre rows (K1's ``row0``, its plain
  version and its adjoint).
* ``capacity_mode=auto`` in the training CLI: the port's trainer prints the
  JAX trainer's scout line on a small ScanNet-format directory and trains.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.misc.scannet_scale_probe import make_indoor_scene
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu.train import setup_worker as jsw
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data.synth_scannet import write_scannet_dir
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.ops_cuda import patch as tpatch
from lattice_net_tpu_torch.train import ln_train as tln
from lattice_net_tpu_torch.train import setup as tsetup

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCANNET_TRAIN = ROOT / "config" / "lnn_train_scannet.cfg"
CONV_RTOL = 1e-5
FWD_ATOL = 1e-5
SIGMA = 0.08


def _assert_tables_equal(hj, ht):
    """Every table and counter of a JAX and a port hierarchy, row for row."""
    for a, b in zip(hj.structures, ht.structures, strict=True):
        assert (a.capacity, int(a.nr_verts), int(a.nr_overflow)) == (b.capacity, int(b.nr_verts),
                                                                      int(b.nr_overflow))  # fmt: skip
        np.testing.assert_array_equal(np.asarray(a.keys), b.keys.numpy())
        np.testing.assert_array_equal(
            np.asarray(js.unpack_key_pairs(a.keys2, a.pos_dim)),
            ts.unpack_keys(b.packed, b.pos_dim).where(b.occupancy_mask()[:, None], js.SENTINEL).numpy(),
        )
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, b in zip(getattr(hj, name), getattr(ht, name), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(hj.splat_idx), ht.splat_idx.numpy())
    np.testing.assert_array_equal(np.asarray(hj.edges.vertex), ht.edges.vertex.numpy())
    np.testing.assert_array_equal(np.asarray(hj.edges.ends), ht.edges.ends.numpy())
    np.testing.assert_array_equal(np.asarray(hj.edges.perm), ht.edges.perm.numpy())


# ---------------------------------------------------------------------------
# capacity schedules
# ---------------------------------------------------------------------------


OCCUPANCY_CASES = [
    ([72340, 17930, 4430, 1088], 1.5, True),
    ([1], 2.0, True),
    ([100000], 2.0, False),
    ([73282, 17249, 4292, 1036], 1.5, True),
    ([0, 255, 256, 257], 1.0, True),
]


@pytest.mark.parametrize("occ, headroom, pow2", OCCUPANCY_CASES)
def test_capacity_schedule_from_occupancy_matches_jax(occ, headroom, pow2):
    got = ts.capacity_schedule_from_occupancy(occ, headroom, snap_pow2=pow2)
    assert got == js.capacity_schedule_from_occupancy(occ, headroom, snap_pow2=pow2)
    assert all(type(c) is int for c in got)


def test_capacity_schedules_match_jax_on_random_cases():
    rng = np.random.default_rng(0)
    for _ in range(200):
        levels = int(rng.integers(1, 5))
        occ = rng.integers(0, 3_000_000, levels).tolist()
        head = float(rng.choice([1.0, 1.25, 1.5, 2.0, 3.7]))
        pow2 = bool(rng.integers(0, 2))
        assert ts.capacity_schedule_from_occupancy(occ, head, snap_pow2=pow2) == \
            js.capacity_schedule_from_occupancy(occ, head, snap_pow2=pow2)  # fmt: skip
        caps = [int(c) for c in rng.integers(256, 1 << 20, levels)]
        ovf = [int(o) for o in rng.integers(0, 3, levels) * rng.integers(0, 100000, levels)]
        assert ts.escalate_capacities(caps, ovf) == js.escalate_capacities(caps, ovf)
        assert ts.escalate_capacities(caps, ovf, occ, head) == js.escalate_capacities(caps, ovf, occ, head)


@pytest.mark.parametrize(
    "args",
    [((1024, 512), (0, 0)), ((1024, 512), (3, 0)), ((1024, 512), (1, 1)),
     ((8192, 8192), (52262, 0), (8192, 4000), 1.5)],
)  # fmt: skip
def test_escalate_capacities_matches_jax(args):
    assert ts.escalate_capacities(*args) == js.escalate_capacities(*args)


# ---------------------------------------------------------------------------
# compact_hierarchy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compacted():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    vals = rng.normal(size=(4096, 1)).astype(np.float32)
    big = (1 << 15, 1 << 14, 1 << 13)
    build = jax.jit(lambda p, v: js.build_hierarchy(p, 0.3, 2, big, point_feats=v))
    hj_big = build(pos, vals)
    occ = [int(s.nr_verts) for s in hj_big.structures]
    small = js.capacity_schedule_from_occupancy(occ, headroom=1.5)
    ht_big = ts.build_hierarchy(torch.from_numpy(pos), 0.3, 2, big, point_feats=torch.from_numpy(vals))
    return dict(pos=pos, vals=vals, big=big, small=small, hj=js.compact_hierarchy(hj_big, small),
                ht=ts.compact_hierarchy(ht_big, small), ht_big=ht_big)  # fmt: skip


def test_compact_hierarchy_matches_jax(compacted):
    assert all(s < b for s, b in zip(compacted["small"], compacted["big"]))
    _assert_tables_equal(compacted["hj"], compacted["ht"])
    et = compacted["ht"].edges
    assert et.ends.shape[0] == compacted["small"][0]
    assert torch.equal(et.run_end, torch.where(et.ends >= 0, et.ends, et.ends.max()))


def test_compacted_forward_matches_a_small_build(compacted):
    pos, vals, small = compacted["pos"], compacted["vals"], compacted["small"]
    mp = tlnn.ModelParams(
        nr_classes=5, pointnet_channels_per_layer=(8, 8), pointnet_start_nr_channels=8,
        nr_downsamples=2, nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1,
        nr_blocks_up_stage=(1, 1), nr_levels_down_with_normal_resnet=2,
        nr_levels_up_with_normal_resnet=2,
    )  # fmt: skip
    model = tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32).eval()
    p, v = torch.from_numpy(pos), torch.from_numpy(vals)
    h_small = ts.build_hierarchy(p, 0.3, 2, small, point_feats=v)
    with torch.inference_mode():
        want, _ = model(h_small, p, v)
        got, _ = model(compacted["ht"], p, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_ATOL, rtol=FWD_ATOL)


def test_compact_hierarchy_overflow_and_refusal(compacted):
    h = compacted["ht_big"]
    nv0 = int(h.structures[0].nr_verts)
    too_small = (1 << (nv0 - 1).bit_length() >> 1,) + compacted["big"][1:]
    hc = ts.compact_hierarchy(h, too_small)
    assert int(hc.structures[0].nr_overflow) == nv0 - too_small[0]
    assert int(hc.structures[0].nr_verts) == too_small[0]
    assert int(hc.edges.vertex.max()) == too_small[0]
    with pytest.raises(ValueError, match="shrink"):
        ts.compact_hierarchy(h, (1 << 16,) + compacted["big"][1:])
    with pytest.raises(ValueError, match="capacities"):
        ts.compact_hierarchy(h, compacted["big"][:2])


# ---------------------------------------------------------------------------
# the scout and the 5M build
# ---------------------------------------------------------------------------


def test_scout_occupancy_matches_jax():
    clouds = [make_indoor_scene(n, seed=s)[0] for n, s in ((3000, 0), (2200, 1), (2600, 2))]
    mp = jlnn.ModelParams(nr_downsamples=3)
    caps, limits = (16384, 8192, 4096, 2048), (16384, 8192, 2048, 2048)
    occ_j, caps_j = jsw.scout_occupancy(mp, SIGMA, caps, clouds, 1.5, limits)
    occ_t, caps_t = tsetup.scout_occupancy(tlnn.ModelParams(nr_downsamples=3), SIGMA, caps, clouds, 1.5,
                                           limits, device="cpu")  # fmt: skip
    np.testing.assert_array_equal(occ_t, occ_j)
    assert caps_t == tuple(caps_j)
    assert caps_t[2] == 2048  # capped by the limit


def test_5m_build_matches_jax_in_resplat_mode():
    pts = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32)
    caps = (5242880, 2621440)
    hj = jax.jit(lambda p: js.build_hierarchy(p, SIGMA, 1, caps))(pts)
    ht = ts.build_hierarchy(torch.from_numpy(pts), SIGMA, 1, caps)
    _assert_tables_equal(hj, ht)
    assert int(ht.structures[0].nr_overflow) == 0 and int(ht.structures[0].nr_verts) > 128
    # the signature width the simplex mode needs: 2 bits a rank entry, 4
    # entries and the vertex id, 31 bits at this capacity (the limit is 30)
    assert 2 * 4 + (caps[0] + 1).bit_length() == 31
    with pytest.raises(ValueError, match="simplex"):
        js.build_hierarchy(jnp.asarray(pts), SIGMA, 1, caps, coarse_mode="simplex")


# ---------------------------------------------------------------------------
# the row-chunked conv
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conv_setup():
    rng = np.random.default_rng(3)
    pos = make_indoor_scene(3000, seed=3)[0]
    caps = (8195, 4099)  # no multiple of the block counts
    hj = jax.jit(lambda p: js.build_hierarchy(p, SIGMA, 1, caps))(pos)
    ht = ts.build_hierarchy(torch.from_numpy(pos), SIGMA, 1, caps)
    c_in, c_out = 6, 5
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        hj=hj, ht=ht, caps=caps, c_in=c_in, c_out=c_out,
        v0=arr(caps[0], c_in), w_same=arr(9 * c_in, c_out) * 0.1, cot0=arr(caps[0], c_out),
        w_cross=arr(9 * c_in, c_out) * 0.1, cot1=arr(caps[1], c_out),
    )  # fmt: skip


def _jax_conv(s, same):
    """Forward, d_values and d_weight of JAX's conv_im2row (its chunked
    ``_conv_flip`` under a small LNT_CONV_CHUNK_BYTES)."""
    h = s["hj"]
    v = jnp.asarray(s["v0"])
    if same:
        w, cot = jnp.asarray(s["w_same"]), jnp.asarray(s["cot0"])

        def f(v, w):
            return jops.conv_im2row(v, h.neighbors_same[0], w, same_level=True)
    else:
        w, cot = jnp.asarray(s["w_cross"]), jnp.asarray(s["cot1"])

        def f(v, w):
            return jops.conv_im2row(v, h.neighbors_coarsen[0], w, False, neighbors_t=h.neighbors_finefy[0])

    out, vjp = jax.vjp(f, v, w)
    return [np.asarray(x) for x in (out, *vjp(cot))]


def _port_conv(s, same):
    h = s["ht"]
    v = torch.from_numpy(s["v0"]).requires_grad_(True)
    if same:
        w, cot = torch.from_numpy(s["w_same"]).requires_grad_(True), torch.from_numpy(s["cot0"])
        out = tops.conv_im2row(v, h.neighbors_same[0], w, True)
    else:
        w, cot = torch.from_numpy(s["w_cross"]).requires_grad_(True), torch.from_numpy(s["cot1"])
        out = tops.conv_im2row(v, h.neighbors_coarsen[0], w, False, neighbors_t=h.neighbors_finefy[0])
    dv, dw = torch.autograd.grad(out, (v, w), cot)
    return [x.detach().numpy() for x in (out, dv, dw)]


def _close(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=CONV_RTOL, atol=CONV_RTOL * np.abs(w).max())


@pytest.mark.parametrize("same, rows", [(True, 2200), (False, 1200)], ids=["same_level", "cross_level"])
def test_row_chunked_conv_matches_jax_chunked(conv_setup, same, rows, monkeypatch):
    s = conv_setup
    cq = s["caps"][0] if same else s["caps"][1]
    budget = rows * 9 * s["c_in"] * 4  # the forward's patch of `rows` f32 rows
    unchunked = _port_conv(s, same)
    monkeypatch.setenv("LNT_CONV_CHUNK_BYTES", str(budget))
    nb = tops._conv_row_blocks(cq, 9, s["c_in"], 4)
    assert nb == jops._conv_row_blocks(cq, 9, s["c_in"], 4)
    assert 3 <= nb <= 5 and cq % nb != 0
    calls = []
    gather = tpatch.patch_gather

    def counting(values, neighbors, include_center, plain=False, row0=0):
        calls.append((neighbors.shape[0], include_center, row0))
        return gather(values, neighbors, include_center, plain=plain, row0=row0)

    monkeypatch.setattr(tops, "patch_gather", counting)
    got = _port_conv(s, same)
    want = _jax_conv(s, same)
    _close(got, want)
    _close(got, unchunked)
    # the forward and d_w's recomputed patch gather the same nb blocks, each
    # a K1 call at its own row offset (d_values' flipped conv blocks by its
    # own widths); same-level blocks carry their own centre rows
    fwd = [(rows, row0) for rows, _, row0 in calls[:nb]]
    b = -(-cq // nb)
    assert fwd == [(min(b, cq - r0), r0) for r0 in range(0, cq, b)]
    assert calls[nb : 2 * nb] == calls[:nb]
    assert all(c == same for _, c, _ in calls)


def test_chunked_conv_block_gets_its_own_centre_rows(monkeypatch):
    # a same-level conv whose middle block starts past row 0: the centre
    # slice of the bank must meet that block's own rows, not rows 0..B
    rng = np.random.default_rng(5)
    cap, c_in, c_out = 10, 2, 3
    nbr = torch.full((cap, 8), cap, dtype=torch.int32)  # no neighbours: the centre alone
    v = torch.from_numpy(rng.normal(size=(cap, c_in)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(9 * c_in, c_out)).astype(np.float32))
    monkeypatch.setenv("LNT_CONV_CHUNK_BYTES", str(4 * 9 * c_in * 4))  # 4 rows a block
    assert tops._conv_row_blocks(cap, 9, c_in, 4) == 3
    assert tops._row_blocks(cap, 3) == [(0, 4), (4, 8), (8, 10)]
    got = tops.conv_im2row(v, nbr, w, True)
    np.testing.assert_allclose(got.numpy(), (v @ w[8 * c_in:]).numpy(), rtol=1e-6, atol=1e-6)


def test_patch_gather_row_offset_and_its_adjoint():
    """K1's plain version with a row offset: the block's rows of the whole
    table's patch; its adjoint adds the centre column to those rows."""
    rng = np.random.default_rng(9)
    cap, c, k, r0, r1 = 50, 3, 8, 17, 41
    nbr = torch.from_numpy(rng.integers(-2, cap + 2, (cap, k)).astype(np.int32))
    v = torch.from_numpy(rng.normal(size=(cap, c)).astype(np.float32))
    whole = tpatch.patch_gather_plain(v, nbr, True)
    block = tpatch.patch_gather_plain(v, nbr[r0:r1], True, row0=r0)
    assert torch.equal(block, whole[r0:r1])
    g = torch.from_numpy(rng.normal(size=(r1 - r0, k + 1, c)).astype(np.float32))
    leaf = v.clone().requires_grad_(True)
    (d_block,) = torch.autograd.grad(tpatch.patch_gather(leaf, nbr[r0:r1], True, row0=r0), leaf, g)
    g_whole = torch.zeros(cap, k + 1, c)
    g_whole[r0:r1] = g
    want = tpatch.patch_scatter_plain(g_whole, nbr, cap, True)
    np.testing.assert_allclose(d_block.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="centre column"):
        tpatch._check(v, nbr[r0:r1], True, row0=cap - 5)


def test_conv_row_blocks_match_jax(monkeypatch):
    for budget in (None, 1 << 20, 12345, 1):
        if budget is None:
            monkeypatch.delenv("LNT_CONV_CHUNK_BYTES", raising=False)
        else:
            monkeypatch.setenv("LNT_CONV_CHUNK_BYTES", str(budget))
        for args in ((5_000_000, 9, 128, 2), (625_000, 9, 256, 2), (131072, 9, 32, 4), (7, 9, 3, 4)):
            assert tops._conv_row_blocks(*args) == jops._conv_row_blocks(*args)
    monkeypatch.delenv("LNT_CONV_CHUNK_BYTES")
    # the ScanNet eval's widest level-0 conv: 11.5 GB of bf16 patch in 11 blocks
    assert tops._conv_row_blocks(5_000_000, 9, 128, 2) == 11


# ---------------------------------------------------------------------------
# capacity_mode=auto in the training CLI
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def test_trainer_auto_capacity_scout_line_matches_jax(tmp_path, capsys, monkeypatch):
    root = write_scannet_dir(tmp_path / "scannet", nr_train=2, nr_test=1, n_points=2048, seed=0)
    overrides = [
        f"loader_scannet.dataset_path={root}", f"train.checkpoint_path={tmp_path}/ckpt",
        "lattice_gpu.capacity_mode=auto", "lattice_gpu.capacity_headroom=1.5",
        "lattice_gpu.hash_table_capacity=32768", "model.nr_blocks_down_stage=[1,1,1]",
        "model.nr_blocks_bottleneck=1", "model.nr_blocks_up_stage=[1,1,1]", "train.with_tensorboard=false",
    ]  # fmt: skip

    def stop(*args, **kwargs):
        raise _Stop

    # the JAX trainer prints the scout line before its build and init
    with monkeypatch.context() as m:
        m.setattr(jsw, "build_and_init", stop)
        with pytest.raises(_Stop):
            jln.run(str(SCANNET_TRAIN), max_epochs=1, overrides=overrides)
    want = [l for l in capsys.readouterr().out.splitlines() if l.startswith("capacity_mode=auto")]
    state = tln.run(SCANNET_TRAIN, max_epochs=1, overrides=overrides, device="cpu")
    out = capsys.readouterr().out
    got = [l for l in out.splitlines() if l.startswith("capacity_mode=auto")]
    assert len(want) == 1 and got == want
    caps = tuple(int(x) for x in re.search(r"-> caps \[([0-9, ]+)\]", got[0]).group(1).split(","))
    assert f"caps={caps}" in out and caps[0] < 32768
    assert state.step == 2  # one epoch of the two train scenes


def test_capacities_from_config_modes():
    cfg = tconfig.load_config(SCANNET_TRAIN)
    mp = tconfig.model_params_from_config(cfg, 21)
    lp = tconfig.LatticeParams.from_config(cfg)
    assert lp.capacity_headroom == 2.0
    assert tsetup.capacities_from_config(lp, mp) == (5000000, 2500000, 1250000, 625000)
    auto = tconfig.LatticeParams.from_config(
        tconfig.apply_overrides(cfg, ["lattice_gpu.capacity_mode=auto", "lattice_gpu.capacity_headroom=1.5"])
    )
    assert (auto.capacity_mode, auto.capacity_headroom) == ("auto", 1.5)
    with pytest.raises(ValueError, match="scout"):
        tsetup.capacities_from_config(auto, mp)
