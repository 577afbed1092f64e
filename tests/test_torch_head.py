"""The slice-classify head (``SliceFastModule``) and channel dropout vs the
JAX package, in f32 on the CPU.

* Every branch of the head: the edge-sort adjoint on and off
  (``LNT_HEAD_SEGVJP``, read by both sides) against JAX's head with
  preclassify on and off (``LNT_HEAD_PRECLASSIFY``, JAX's alone: the port
  always classifies first), and ``experiment="slice_no_deform"``.  Both
  modules get the same table, hierarchy and weights (the flax params
  converted by ``params_from_flax``), with the switches set before either
  side traces.  Logits agree to 1e-5 absolute; the gradients of a fixed
  linear function of the logits, in the vertex table and every parameter,
  to a relative L2 error of 1e-5 (f32 GroupNorm and GEMM sums in another
  order).
* Dropout in eval: an ``LNN`` with ``dropout_last_layer > 0`` gives JAX's
  deterministic output (to the 1e-4 of ``tests/test_torch_model.py``), JAX
  on its gather-then-classify branch, which gathers the table again.
* The experiment modes through a whole ``LNN`` (the small model, eval
  mode): ``slice_no_deform`` and the ablations ``splat`` and
  ``pointnet_no_local_mean``, which drop the distribute's local mean, give
  JAX's log-probabilities to 1e-4 and its labels.
* Dropout in training: whole channels are zeroed, survivors scaled by
  1 / (1 - p), one seed gives one mask; and given the same keep mask (JAX's
  ``jax.random.bernoulli`` patched to return it), the port's train-mode head
  equals JAX's on both of JAX's branches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.nn import modules as jlnm
from lattice_net_tpu_torch.interop import hierarchy_from_numpy, params_from_flax
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.nn import modules as tlnm

torch.set_num_threads(2)

LOGIT_ATOL = 1e-5
GRAD_REL_L2 = 1e-5
LOGP_ATOL = 1e-4
CAP, C_IN, CLASSES, P = 1024, 48, 5, 0.5
# (LNT_HEAD_SEGVJP, LNT_HEAD_PRECLASSIFY, experiment)
BRANCHES = [
    ("0", "1", "none"), ("1", "1", "none"), ("0", "0", "none"), ("1", "0", "none"),
    ("0", "1", "slice_no_deform"),
]  # fmt: skip


@pytest.fixture(scope="module")
def head_inputs():
    """A masked build of a 1200-point cloud (invalid trailing edges, empty
    rows past nr_verts), a random vertex table and a cotangent."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (1200, 3)).astype(np.float32)
    mask = np.arange(1200) < 1100
    # jitted: the eager build dispatches op by op and takes 10x longer
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=0.7, nr_levels=1,
                                      capacities=(CAP, CAP // 2)))  # fmt: skip
    hj = build(jnp.asarray(pos), point_mask=jnp.asarray(mask))
    ht = hierarchy_from_numpy(hj, device="cpu")
    lv = rng.normal(size=(CAP, C_IN)).astype(np.float32)
    ct = rng.normal(size=(1200, CLASSES)).astype(np.float32)
    return hj, ht, lv, ct


def _jax_head(hj, dropout=0.0, experiment="none"):
    module = jlnm.SliceFastModule(C_IN, CLASSES, dropout=dropout, experiment=experiment)
    s0 = hj.structures[0]
    args = (s0.occupancy_mask(), hj.splat_idx, hj.splat_weights)
    return module, args


def _port_head(params, dropout=0.0, experiment="none"):
    head = tlnm.SliceFastModule(
        C_IN, CLASSES, torch.Generator().manual_seed(0), dropout=dropout, experiment=experiment
    )
    head.load_state_dict(params_from_flax(params))
    return head


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("segvjp,preclassify,experiment", BRANCHES)
def test_slice_fast_module_matches_jax(head_inputs, monkeypatch, segvjp, preclassify, experiment):
    monkeypatch.setenv("LNT_HEAD_SEGVJP", segvjp)
    monkeypatch.setenv("LNT_HEAD_PRECLASSIFY", preclassify)
    hj, ht, lv, ct = head_inputs
    module, args = _jax_head(hj, experiment=experiment)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(lv), *args, edges=hj.edges)

    def loss(params, lv):
        logits = module.apply(params, lv, *args, edges=hj.edges)
        return jnp.vdot(logits, jnp.asarray(ct)), logits

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, logits_j), (g_params, g_lv) = grad_fn(params, jnp.asarray(lv))

    head = _port_head(params, experiment=experiment)
    lv_t = torch.from_numpy(lv).requires_grad_()
    s0 = ht.structures[0]
    logits = head(lv_t, s0.occupancy_mask(), ht.splat_idx, ht.splat_weights, ht.edges)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), rtol=0, atol=LOGIT_ATOL)
    (logits * torch.from_numpy(ct)).sum().backward()
    want = {k: v.numpy() for k, v in params_from_flax(g_params).items()}
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in head.named_parameters()}
    errs = {k: _rel_l2(g.numpy(), want[k]) for k, g in grads.items()}
    errs["lv"] = _rel_l2(lv_t.grad.numpy(), g_lv)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])
    if experiment == "slice_no_deform":  # no offsets: nothing reaches the offset head
        assert head.delta_kernel.grad is None and not want["delta_kernel"].any()


def test_channel_dropout_drops_whole_channels():
    lv = torch.randn(300, 40) + 5.0  # no zero entries of its own
    out = tlnm.channel_dropout(lv, P, True, torch.Generator().manual_seed(3))
    dropped = (out == 0).all(0)
    kept = ~dropped
    assert 0 < int(dropped.sum()) < 40
    assert not (out[:, kept] == 0).any()
    torch.testing.assert_close(out[:, kept], lv[:, kept] / (1 - P), rtol=0, atol=0)
    again = tlnm.channel_dropout(lv, P, True, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    other = tlnm.channel_dropout(lv, P, True, torch.Generator().manual_seed(4))
    assert not torch.equal(out, other)
    assert tlnm.channel_dropout(lv, P, False, None) is lv
    assert tlnm.channel_dropout(lv, 0.0, True, None) is lv
    with pytest.raises(ValueError):
        tlnm.channel_dropout(lv, P, True, None)


@pytest.mark.parametrize("preclassify", ["1", "0"])
def test_dropout_head_in_training_matches_jax_with_one_mask(head_inputs, monkeypatch, preclassify):
    monkeypatch.setenv("LNT_HEAD_PRECLASSIFY", preclassify)
    hj, ht, lv, _ = head_inputs
    keep = np.random.default_rng(5).uniform(size=(1, C_IN)) < 1 - P
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    monkeypatch.setattr(tlnm, "channel_keep_mask", lambda c, p, gen, dev: torch.from_numpy(keep))
    module, args = _jax_head(hj, dropout=P)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(lv), *args, edges=hj.edges)
    want = module.apply(
        params, jnp.asarray(lv), *args, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)},
        edges=hj.edges,
    )  # fmt: skip
    head = _port_head(params, dropout=P)
    s0 = ht.structures[0]
    with torch.no_grad():
        got = head(torch.from_numpy(lv), s0.occupancy_mask(), ht.splat_idx, ht.splat_weights,
                   ht.edges, True, torch.Generator())  # fmt: skip
        evaluated = head(torch.from_numpy(lv), s0.occupancy_mask(), ht.splat_idx, ht.splat_weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert not torch.allclose(got, evaluated)


MODEL = dict(
    nr_classes=CLASSES, values_mode="intensity", pointnet_channels_per_layer=(8, 16),
    pointnet_start_nr_channels=16, nr_downsamples=2, nr_blocks_down_stage=(1, 1),
    nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1), nr_levels_down_with_normal_resnet=3,
    nr_levels_up_with_normal_resnet=3, dropout_last_layer=P,
)  # fmt: skip


def test_lnn_with_dropout_in_eval_matches_jax(monkeypatch):
    monkeypatch.setenv("LNT_HEAD_PRECLASSIFY", "0")
    c = make_scene(2048, seed=2)
    pos, vals = jnp.asarray(c.V), jnp.asarray(c.I)
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=0.6, nr_levels=2,
                                      capacities=(4096, 2048, 1024)))  # fmt: skip
    hj = build(pos, point_feats=vals)
    model = jlnn.LNN(jlnn.ModelParams(**MODEL))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, pos, vals)
    want, _ = jax.jit(model.apply)(params, hj, pos, vals)
    port = tlnn.LNN(
        tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
        conv_dtype=torch.float32,
    ).eval()  # fmt: skip
    port.load_state_dict(params_from_flax(params))
    ht = hierarchy_from_numpy(hj, device="cpu")
    with torch.no_grad():
        got, _ = port(ht, torch.from_numpy(np.asarray(c.V)), torch.from_numpy(np.asarray(c.I)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGP_ATOL)


@pytest.fixture(scope="module")
def experiment_ref():
    """A jitted JAX build of a 1024-point scene and the JAX init of the
    small model (the experiment modes keep every parameter)."""
    c = make_scene(1024, seed=3)
    pos, vals = jnp.asarray(c.V), jnp.asarray(c.I)
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=0.6, nr_levels=2,
                                      capacities=(2048, 1024, 512)))  # fmt: skip
    hj = build(pos, point_feats=vals)
    params = jax.jit(jlnn.LNN(jlnn.ModelParams(**MODEL)).init)(jax.random.PRNGKey(0), hj, pos, vals)
    return c, hj, params


@pytest.mark.parametrize("experiment", ["slice_no_deform", "splat", "pointnet_no_local_mean"])
def test_lnn_experiment_modes(experiment, experiment_ref):
    # every mode keeps the parameters, so the flax params convert unchanged;
    # the last two drop the local mean in the distribute
    c, hj, params = experiment_ref
    model = jlnn.LNN(jlnn.ModelParams(**MODEL, experiment=experiment))
    want, _ = jax.jit(model.apply)(params, hj, jnp.asarray(c.V), jnp.asarray(c.I))
    port = tlnn.LNN(
        tlnn.ModelParams(**MODEL, experiment=experiment), torch.Generator().manual_seed(0), device="cpu",
        conv_dtype=torch.float32,
    ).eval()  # fmt: skip
    port.load_state_dict(params_from_flax(params))
    assert port.SliceFastModule_0.experiment == experiment
    ht = hierarchy_from_numpy(hj, device="cpu")
    with torch.no_grad():
        got, _ = port(ht, torch.from_numpy(np.asarray(c.V)), torch.from_numpy(np.asarray(c.I)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGP_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    with pytest.raises(ValueError, match="unknown experiment"):
        tlnn.LNN(tlnn.ModelParams(**MODEL, experiment="no_such_mode"), torch.Generator(), device="cpu")
