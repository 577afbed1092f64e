"""``remat_blocks`` and the ``LNT_LOVASZ`` variants of the port vs the JAX
package, on the CPU.

* ``model.remat_blocks`` reaches ``ModelParams`` from a config.  The port's
  remat model has the ``state_dict`` keys of the plain one and gives the
  same loss and gradients (checkpointed blocks recomputed in the backward,
  on the step's own parameter tensors, not the module's); both hold
  against JAX's remat model: log-probabilities 1e-4, loss 1e-5, gradients
  1e-4 (relative L2).  A JAX checkpoint loads into either.
* The port's one Lovász formulation (JAX's default, ``packed``) against
  each of JAX's variants (``packed``, ``batched``, ``sortvjp``,
  ``condskip``, picked by ``LNT_LOVASZ``) at 1e-6, loss and input
  gradients, on log-probabilities without exact error ties (ties let each
  side pick another valid subgradient inside a tie block;
  ``tests/test_losses.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu import losses as jl
from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch import losses as tl
from lattice_net_tpu_torch.interop import hierarchy_from_numpy, params_from_flax
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.train import checkpoint as tck
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

LOGP_ATOL, LOSS_ATOL, GRAD_REL, LOVASZ_ATOL = 1e-4, 1e-5, 1e-4, 1e-6
N_POINTS, N_REAL, CAPS, SIGMA = 2048, 1800, (4096, 2048, 1024), 0.6
MODEL = dict(
    nr_classes=5, values_mode="intensity", pointnet_channels_per_layer=(8, 16),
    pointnet_start_nr_channels=8, nr_downsamples=2, nr_blocks_down_stage=(1, 1),
    nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1), nr_levels_down_with_normal_resnet=1,
    nr_levels_up_with_normal_resnet=1,
)  # fmt: skip


def test_config_reads_remat_blocks():
    cfg = {"model": {"remat_blocks": True}}
    assert tconfig.model_params_from_config(cfg, 5).remat_blocks
    assert jconfig.model_params_from_config(cfg, 5).remat_blocks
    assert not tconfig.model_params_from_config({"model": {}}, 5).remat_blocks


@functools.lru_cache(maxsize=None)
def _ref():
    """JAX's remat model: its init, log-probabilities and the loss and
    gradients of one batch."""
    c = make_scene(N_REAL, seed=4)
    mp = jlnn.ModelParams(**MODEL, remat_blocks=True)
    pos, vals, tgt = jlnn.prepare_cloud(c, mp)
    cloud = (pos, vals, tgt % MODEL["nr_classes"])
    batch = jdp.make_batch([cloud], None, N_POINTS, rng=np.random.default_rng(3))
    b0 = {k: v[0] for k, v in batch.items()}
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=2, capacities=CAPS))
    h = build(b0["positions"], point_mask=b0["point_mask"], point_feats=b0["values"])
    model = jlnn.LNN(mp)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), h, b0["positions"], b0["values"])
    logp, _ = jax.jit(model.apply)(params, h, b0["positions"], b0["values"])
    loss_fn = jdp.make_loss_fn(model, SIGMA, 2, CAPS)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch, jax.random.PRNGKey(1))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return dict(cloud=cloud, batch=to_np(batch), params=to_np(params), logp=np.asarray(logp),
                loss=float(loss), grads=params_from_flax(to_np(grads)), h=h)  # fmt: skip


def _port(remat: bool):
    model = tlnn.LNN(tlnn.ModelParams(**MODEL, remat_blocks=remat), torch.Generator().manual_seed(5),
                     device="cpu", conv_dtype=torch.float32)  # fmt: skip
    return model


def _loss_and_grads(model, params, batch):
    loss_fn = tdp.make_loss_fn(model, SIGMA, 2, CAPS)
    leaves, loss, _ = tdp.forward_loss(loss_fn, params, batch)
    return float(loss.detach()), tdp.gradients(loss, leaves)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b), min=1e-12))


def test_remat_on_and_off_agree_and_hold_against_jax():
    ref = _ref()
    flax_sd = params_from_flax(ref["params"])
    plain, remat = _port(False), _port(True)
    assert list(plain.state_dict()) == list(remat.state_dict()) and set(flax_sd) == set(remat.state_dict())
    # the step's parameters are not the module's: the recompute must use them
    batch = tdp.make_batch([ref["cloud"]], N_POINTS, rng=np.random.default_rng(3), device="cpu")
    out = {name: _loss_and_grads(m, flax_sd, batch) for name, m in (("plain", plain), ("remat", remat))}
    assert abs(out["plain"][0] - out["remat"][0]) <= LOSS_ATOL
    assert abs(out["remat"][0] - ref["loss"]) <= LOSS_ATOL
    for k, g in out["remat"][1].items():
        assert _rel(g, out["plain"][1][k]) <= GRAD_REL, k
        assert _rel(g, ref["grads"][k]) <= GRAD_REL, k
    remat.load_state_dict(flax_sd)
    b0 = {k: v[0] for k, v in batch.items()}
    with torch.no_grad():
        logp, _ = remat(hierarchy_from_numpy(ref["h"], device="cpu"), b0["positions"], b0["values"])
    np.testing.assert_allclose(logp.numpy(), ref["logp"], rtol=0, atol=LOGP_ATOL)


def test_jax_checkpoint_loads_with_remat_on_and_off(tmp_path):
    ref = _ref()
    tx_j = jo.make_optimizer(1e-3, 1e-4)
    jck.save_checkpoint(tmp_path / "jax.ckpt", jdp.TrainState.create(ref["params"], tx_j))
    want = params_from_flax(ref["params"])
    for remat in (False, True):
        model = _port(remat)
        tx = to.make_optimizer(1e-3, 1e-4)
        got = tck.load_checkpoint(tmp_path / "jax.ckpt", tdp.TrainState.create(model.state_dict(), tx))
        for k in want:
            torch.testing.assert_close(got.params[k], want[k], rtol=0, atol=0)
        model.load_state_dict(tck.load_params(tmp_path / "jax.ckpt", model.state_dict()))


# ---------------------------------------------------------------------------
# module 2: the Lovász variants
# ---------------------------------------------------------------------------

VARIANTS = ("packed", "batched", "sortvjp", "condskip")
N, C = 700, 6


def _lovasz_case(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, C)).astype(np.float32) * 2
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    target = rng.integers(0, C - 1, size=N).astype(np.int32)  # class C-1 never occurs
    target[rng.random(N) < 0.1] = -1
    mask = rng.random(N) < 0.9
    return logp, target, mask


@pytest.mark.parametrize("variant", VARIANTS)
def test_lovasz_variant_matches_jax(variant, monkeypatch):
    monkeypatch.setenv("LNT_LOVASZ", variant)  # JAX reads it at each call
    logp, target, mask = _lovasz_case()
    vj, gj = jax.value_and_grad(
        lambda lp: jl.lovasz_softmax(lp, jnp.asarray(target), -1, jnp.asarray(mask))
    )(jnp.asarray(logp))
    lp = torch.from_numpy(logp.copy()).requires_grad_()
    vt = tl.lovasz_softmax(lp, torch.from_numpy(target), -1, torch.from_numpy(mask))
    (gt,) = torch.autograd.grad(vt, lp)
    assert abs(float(vt.detach()) - float(vj)) <= LOVASZ_ATOL
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=LOVASZ_ATOL)
