"""The fused masked GroupNorm + activation (``ops_cuda/norm.py``) on the CPU.

* ``group_norm_act``'s plain version, which the CPU runs, is bit-equal to
  the composition the modules ran, ``F.relu(masked_group_norm(...)).to(dtype)``,
  for every (C, groups) the configs under ``config/`` build, C = 7 in one
  group and the one-group norm of ``ResnetBlock2``, with masks that mark a
  prefix, no row, every row and a scattered set of rows; and within 1e-5
  (of the largest output) of a float64 NumPy oracle of the masked statistics.
* The modules take it once a norm outside autograd and never under it:
  each module's output under ``inference_mode`` equals its output under
  autograd bit for bit, and under autograd its output and gradients equal
  the composition's.  A small LNN's log-probabilities under
  ``inference_mode`` equal those under autograd.
* Inside ``norm_stats_distributed`` the composition runs; ``plain=True`` and
  ``LNT_FAST_OPS=0`` reach the wrapper as ``plain``; the kernel's argument
  checks raise.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.nn import modules as lnm
from lattice_net_tpu_torch.ops_cuda import norm as k_norm

torch.set_num_threads(2)

# every (C, groups) of config/*.cfg's models (32 groups, else C / 2), C = 7
# in one group, and ResnetBlock2's one-group norm
SHAPES = [(8, 4), (12, 6), (16, 8), (24, 12), (32, 32), (48, 24), (64, 32), (96, 32), (128, 32), (192, 32),
          (256, 32), (7, 1), (32, 1)]  # fmt: skip
MASKS = ["prefix", "none", "all", "scattered"]
CAP = 96
SIGMA, CAPS = 0.6, (4096, 2048, 1024)
MODEL = dict(
    nr_classes=5, values_mode="intensity", pointnet_channels_per_layer=(8, 16), pointnet_start_nr_channels=16,
    nr_downsamples=2, nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
)  # fmt: skip


def _mask(kind, cap, rng):
    if kind == "prefix":
        return torch.arange(cap) < cap // 3
    if kind == "none":
        return torch.zeros(cap, dtype=torch.bool)
    if kind == "all":
        return torch.ones(cap, dtype=torch.bool)
    m = torch.from_numpy(rng.random(cap) < 0.4)
    m[0] = True
    return m


def _inputs(c, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    lv = torch.from_numpy((rng.normal(size=(CAP, c)) * 3 + 40).astype(np.float32))  # |mean| >> spread
    scale = torch.from_numpy(rng.normal(1.0, 0.3, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(np.float32))
    return lv, _mask(mask_kind, CAP, rng), scale, bias


def _oracle(lv, mask, groups, scale, bias, eps=1e-5):
    """float64 NumPy masked GroupNorm: statistics over the marked rows about
    row 0's group means (with no marked row, the mean is that shift and the
    variance 0), every row normalised."""
    x = lv.numpy().astype(np.float64)
    cap, c = x.shape
    gs = c // groups
    shift = x[0].reshape(groups, gs).mean(1)
    d = x[mask.numpy()].reshape(-1, groups, gs) - shift[:, None]
    n = max(d.shape[0] * gs, 1)
    m = d.sum((0, 2)) / n
    var = np.maximum((d**2).sum((0, 2)) / n - m**2, 0.0)
    mean_c, inv_c = np.repeat(m + shift, gs), np.repeat(1.0 / np.sqrt(var + eps), gs)
    return (x - mean_c) * inv_c * scale.numpy() + bias.numpy()


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("c,groups", SHAPES)
def test_plain_version_is_the_composition(c, groups, mask_kind):
    lv, mask, scale, bias = _inputs(c, mask_kind)
    launches = k_norm.group_norm_act.launches
    for relu in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            want = lnm.masked_group_norm(lv, mask, groups, scale, bias)
            want = (F.relu(want) if relu else want).to(dtype)
            for plain in (False, True):
                got = k_norm.group_norm_act(lv, mask, groups, scale, bias, relu, dtype, plain=plain)
                assert got.dtype == dtype and torch.equal(got, want), (relu, dtype, plain)
    assert k_norm.group_norm_act.launches == launches  # the CPU launches nothing
    oracle = _oracle(lv, mask, groups, scale, bias)
    got = k_norm.group_norm_act(lv, mask, groups, scale, bias, False, torch.float32)
    # f32 rounding of the shift, amplified as far as the outputs reach (rsqrt(eps) with no marked row)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5 * np.abs(oracle).max())


@pytest.fixture(scope="module")
def hierarchy():
    c = make_scene(700, seed=3)
    pos, _, _ = tlnn.prepare_cloud(c, tlnn.ModelParams(**MODEL))
    return st.build_hierarchy(torch.from_numpy(pos), SIGMA, 2, CAPS)


def _module_case(kind, h):
    """(module, its forward's arguments without ``plain``, the composition
    the module ran: a function of the same arguments)."""
    gen = torch.Generator().manual_seed(7)
    masks = [s.occupancy_mask() for s in h.structures]
    bf16 = torch.bfloat16
    rng = np.random.default_rng(11)

    def values(cap, c):
        return torch.from_numpy(rng.normal(size=(cap, c)).astype(np.float32))

    def gn(m, lv, mask):
        return F.relu(m.GroupNormLattice_0(lv, mask))

    if kind == "GnReluConv":
        m = lnm.GnReluConv(16, 24, gen, conv_dtype=bf16)
        args = (values(CAPS[0], 16), h.neighbors_same[0], masks[0])
        return m, args, lambda lv, nb, mask: m.ConvIm2Row_0(gn(m, lv, mask), nb)
    if kind == "GnRelu1x1":
        m = lnm.GnRelu1x1(48, 12, gen, use_bias=True)
        args = (values(CAPS[0], 48), masks[0])
        return m, args, lambda lv, mask: gn(m, lv, mask) @ m.kernel + m.bias
    if kind == "GnReluFinefy":
        m = lnm.GnReluFinefy(32, 16, gen, conv_dtype=bf16)
        args = (values(CAPS[1], 32), h.neighbors_finefy[0], masks[1], h.neighbors_coarsen[0])
        return m, args, lambda lv, fin, mask, coa: m.FinefyConv_0(gn(m, lv, mask), fin, coa)
    if kind == "GnReluCoarsen":
        m = lnm.GnReluCoarsen(16, 32, gen, conv_dtype=bf16)
        args = (values(CAPS[0], 16), h.neighbors_coarsen[0], masks[0], h.neighbors_finefy[0])
        return m, args, lambda lv, coa, mask, fin: m.CoarsenConv_0(gn(m, lv, mask), coa, fin)
    if kind == "GnReluDepthwiseConv":
        m = lnm.GnReluDepthwiseConv(24, gen)
        args = (values(CAPS[0], 24), h.neighbors_same[0], masks[0])
        return m, args, lambda lv, nb, mask: lnm.lops.depthwise_conv(gn(m, lv, mask), nb, m.weight, True)
    if kind == "ResnetBlock2":
        m = lnm.ResnetBlock2(16, gen, conv_dtype=bf16)

        def composition(lv, nb, mask):
            out = m.ConvIm2Row_0(lv, nb)
            out = lnm.masked_group_norm(out, mask, 1, m.ln_scale, m.ln_bias)
            return lnm.leaky_relu(m.ConvIm2Row_1(out, nb)) + lv

        return m, (values(CAPS[0], 16), h.neighbors_same[0], masks[0]), composition
    m = lnm.SliceFastModule(32, 5, gen)  # the head's three GnRelu1x1
    args = (values(CAPS[0], 32), masks[0], h.splat_idx, h.splat_weights)

    def head(lv, mask, idx, w):
        lv_b = lv
        for i in range(3):
            sub = getattr(m, f"GnRelu1x1_{i}")
            lv_b = gn(sub, lv_b, mask) @ sub.kernel
        return torch.cat([lv_b, lv @ m.classify_kernel.T], 1)  # the table the head gathers from

    return m, args, head


KINDS = ["GnReluConv", "GnRelu1x1", "GnReluFinefy", "GnReluCoarsen", "GnReluDepthwiseConv", "ResnetBlock2",
         "SliceFastModule"]  # fmt: skip


def _counting(monkeypatch):
    calls = []
    fused = lnm.group_norm_act

    def counted(*args, **kwargs):
        calls.append(kwargs.get("plain"))
        return fused(*args, **kwargs)

    monkeypatch.setattr(lnm, "group_norm_act", counted)
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_modules_fuse_outside_autograd_only(kind, hierarchy, monkeypatch):
    m, args, composition = _module_case(kind, hierarchy)
    norms = sum(isinstance(x, lnm.GroupNormLattice) for x in m.modules()) or 1
    calls = _counting(monkeypatch)
    forward = m
    if kind == "SliceFastModule":  # compare the table the head gathers from, which its norms feed
        tables = []
        real = lnm.lops.gather_rows_clustered
        monkeypatch.setattr(lnm.lops, "gather_rows_clustered", lambda v, i, plain=False: tables.append(v) or real(v, i))
        forward = lambda *a: (m(*a), tables[-1])[1]  # noqa: E731
    # under autograd: the composition, output and gradients
    lv = args[0].clone().requires_grad_(True)
    out = forward(lv, *args[1:])
    assert not calls
    lv_c = args[0].clone().requires_grad_(True)
    want = composition(lv_c, *args[1:])
    assert torch.equal(out, want)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
    params = list(m.parameters())
    got_grads = torch.autograd.grad(out, [lv, *params], g.to(out.dtype), allow_unused=True)
    want_grads = torch.autograd.grad(want, [lv_c, *params], g.to(want.dtype), allow_unused=True)
    for a, b in zip(got_grads, want_grads):
        assert (a is None and b is None) or torch.equal(a, b)
    # outside autograd: one fused call a norm, the same values
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            got = forward(*args)
        assert torch.equal(got, want.detach()), mode
    assert calls == [False] * (2 * norms)


def test_lnn_inference_equals_the_composition(hierarchy, monkeypatch):
    mp = tlnn.ModelParams(**MODEL)
    model = tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.bfloat16).eval()
    c = make_scene(700, seed=3)
    pos, vals, _ = tlnn.prepare_cloud(c, mp)
    pos, vals = torch.from_numpy(pos), torch.from_numpy(vals)
    calls = _counting(monkeypatch)
    want, _ = model(hierarchy, pos, vals)  # autograd on: the composition
    assert want.requires_grad and not calls
    with torch.inference_mode():
        got, _ = model(hierarchy, pos, vals)
    assert torch.equal(got, want.detach())
    assert calls == [False] * 16


class _OneRankMesh:
    def psum(self, x, axis):
        return x

    def size(self, axis):
        return 1


def test_distributed_statistics_keep_the_composition(monkeypatch):
    lv, mask, scale, bias = _inputs(16, "scattered")
    own = torch.from_numpy(np.random.default_rng(2).random(CAP) < 0.7)
    calls = _counting(monkeypatch)
    with torch.inference_mode(), lnm.norm_stats_distributed(_OneRankMesh(), "sp", {CAP: own}):
        got = lnm.norm_act(lv, mask, 8, scale, bias, torch.bfloat16)
    assert not calls and got.dtype == torch.float32
    want = F.relu(lnm.masked_group_norm(lv, mask & own, 8, scale, bias))
    assert torch.equal(got, want)


def test_plain_and_fast_ops_reach_the_wrapper(monkeypatch):
    lv, mask, scale, bias = _inputs(16, "prefix")
    calls = _counting(monkeypatch)
    with torch.no_grad():
        lnm.norm_act(lv, mask, 8, scale, bias, torch.float32)
        lnm.norm_act(lv, mask, 8, scale, bias, torch.float32, plain=True)
        monkeypatch.setenv("LNT_FAST_OPS", "0")
        lnm.norm_act(lv, mask, 8, scale, bias, torch.float32)
    assert calls == [False, True, True]


@pytest.mark.parametrize("fault", ["mask_dtype", "values_dtype", "groups", "scale_shape", "strided", "out_dtype",
                                   "mask_length", "too_wide"])  # fmt: skip
def test_kernel_checks_its_arguments(fault):
    lv, mask, scale, bias = _inputs(16, "prefix")
    groups, out_dtype = 8, torch.bfloat16
    if fault == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif fault == "values_dtype":
        lv = lv.double()
    elif fault == "groups":
        groups = 5
    elif fault == "scale_shape":
        scale = scale[:8]
    elif fault == "strided":
        lv = torch.cat([lv, lv], 1)[:, ::2]
    elif fault == "out_dtype":
        out_dtype = torch.float16
    elif fault == "mask_length":
        mask = mask[1:]
    else:
        lv, mask = torch.zeros((4, k_norm.MAX_CHANNELS + 4)), torch.ones(4, dtype=torch.bool)
        scale = bias = torch.ones(k_norm.MAX_CHANNELS + 4)
        groups = 1
    with pytest.raises((ValueError, TypeError)):
        k_norm._check(lv, mask, groups, scale, bias, out_dtype)
    lv, mask, scale, bias = _inputs(16, "prefix")
    k_norm._check(lv, mask, 8, scale, bias, torch.bfloat16)  # the sound call passes
