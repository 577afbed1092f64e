"""The model on the canonical point order, the port vs the JAX package on
the CPU.

* Serving: bench.py's ``LNT_CANONICAL=1`` program against the default path
  on the input order, labels exactly (see below).
* The canonical train step (``make_host_batch(canonical=sigma)``,
  ``canonical_points=True``) against JAX's ``make_batch(canonical=...)``
  step: loss 1e-5, gradients 1e-4 (relative L2).
* The trainer's ``LNT_CANONICAL_TRAIN=1``, applied in its loader thread.

The default path's outputs depend on the point order: the distribute's local
mean is an f32 prefix sum over the edge stream, whose rounding follows the
edge order, and the PointNet max-pool's winner flips on such rounding.  So
bench.py's ``LNT_CANONICAL=1`` program (reorder, fast build, forward, labels
scattered back) and its default program disagree on a few points, in JAX as
in the port.  This file pins JAX's own agreement below 1 and holds the port's
labels of both programs, and so its agreement, to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp

torch.set_num_threads(2)

SIGMA, CAPS, N = 0.6, (8192, 4096), 1 << 12
MODEL = dict(
    nr_classes=4, pointnet_channels_per_layer=(8, 16), pointnet_start_nr_channels=8,
    nr_downsamples=1, nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
)  # fmt: skip


def _jax_labels(model, params, pos, vals):
    """bench.py's two programs: (canonical labels in input order, default labels)."""
    perm = js.canonical_point_order(pos, SIGMA)
    pos_c, vals_c = pos[perm], vals[perm]
    h = js.build_hierarchy(pos_c, SIGMA, 1, CAPS, canonical_points=True)
    logp_c, _ = model.apply(params, h, pos_c, vals_c)
    pred_c = jnp.zeros(pos.shape[0], jnp.int32).at[perm].set(jnp.argmax(logp_c, -1).astype(jnp.int32))
    h = js.build_hierarchy(pos, SIGMA, 1, CAPS, point_feats=vals)
    logp_d, _ = model.apply(params, h, pos, vals)
    return pred_c, jnp.argmax(logp_d, -1).astype(jnp.int32)


def _port_labels(model, pos, vals):
    perm = ts.canonical_point_order(pos, SIGMA)
    h = ts.build_hierarchy(pos[perm], SIGMA, 1, CAPS, canonical_points=True)
    logp_c, _ = model(h, pos[perm], vals[perm])
    pred_c = torch.empty_like(perm).scatter_(0, perm, logp_c.argmax(-1))
    h = ts.build_hierarchy(pos, SIGMA, 1, CAPS, point_feats=vals)
    return pred_c, model(h, pos, vals)[0].argmax(-1)


def test_canonical_labels_vs_input_order_match_jax():
    pts = np.asarray(make_scene(N, seed=3).V, np.float32)
    vals = np.zeros((N, 1), np.float32)
    model_j = jlnn.LNN(jlnn.ModelParams(**MODEL))
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=1, capacities=CAPS))
    h0 = build(jnp.asarray(pts))
    params = jax.jit(model_j.init)(jax.random.PRNGKey(0), h0, jnp.asarray(pts), jnp.asarray(vals))
    run = jax.jit(functools.partial(_jax_labels, model_j))
    canon_j, default_j = (np.asarray(x) for x in run(params, jnp.asarray(pts), jnp.asarray(vals)))
    agree_j = float((canon_j == default_j).mean())
    # JAX's own programs disagree on a few points (0.9917 of this scan)
    assert 0.95 <= agree_j < 1.0, agree_j

    model_t = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
                       conv_dtype=torch.float32)  # fmt: skip
    model_t.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        canon_t, default_t = (x.numpy() for x in _port_labels(model_t, torch.from_numpy(pts), torch.from_numpy(vals)))
    # the port gives JAX's labels in both programs, so JAX's agreement
    np.testing.assert_array_equal(canon_t, canon_j)
    np.testing.assert_array_equal(default_t, default_j)
    assert float((canon_t == default_t).mean()) == agree_j


def test_canonical_train_step_matches_jax(rng):
    n, n_points, sigma, caps = 1500, 2048, 0.4, (4096, 2048)
    pts = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    vals = rng.normal(size=(n, 1)).astype(np.float32)
    tgt = rng.integers(0, 4, n).astype(np.int32)
    bj = jdp.make_batch([(pts, vals, tgt)], None, n_points, canonical=sigma)
    bt = tdp.make_host_batch([(pts, vals, tgt)], n_points, canonical=sigma)
    for k in bt:
        np.testing.assert_array_equal(bt[k], np.asarray(bj[k]), err_msg=k)
    model_j = jlnn.LNN(jlnn.ModelParams(**MODEL))
    b0 = {k: v[0] for k, v in bj.items()}
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=sigma, nr_levels=1, capacities=caps))
    h0 = build(b0["positions"], point_mask=b0["point_mask"])
    params = jax.jit(model_j.init)(jax.random.PRNGKey(0), h0, b0["positions"], b0["values"])
    loss_j = jdp.make_loss_fn(model_j, sigma, 1, caps, canonical_points=True)
    (lj, _), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params, bj, jax.random.PRNGKey(3))

    model_t = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
                       conv_dtype=torch.float32)  # fmt: skip
    model_t.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    loss_t = tdp.make_loss_fn(model_t, sigma, 1, caps, canonical_points=True)
    batch = tdp.to_device(bt, "cpu")
    leaves, lt, _ = tdp.forward_loss(loss_t, model_t.state_dict(), batch)
    gt = tdp.gradients(lt, leaves)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5
    gj = params_from_flax(jax.tree.map(np.asarray, gj))
    for k, g in gt.items():
        rel = float(torch.linalg.vector_norm(g - gj[k]) / torch.clamp(torch.linalg.vector_norm(gj[k]), min=1e-12))
        assert rel <= 1e-4, (k, rel)


def _first_step_losses(monkeypatch, ln_train, toy, args):
    """Runs the trainer; returns the loss of each train step's batch."""
    losses = []
    make = ln_train.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def train_step(state, batch, generator=None):
            new, metrics = step(state, batch, generator)
            losses.append(float(metrics["loss"]))
            return new, metrics

        return train_step

    with monkeypatch.context() as m:
        m.setattr(ln_train, "make_train_step", recording)
        ln_train.run(toy, **args)
    return losses


def test_trainer_canonical_order_in_its_loader_thread(monkeypatch, capsys, tmp_path):
    import threading
    from pathlib import Path

    from lattice_net_tpu_torch.train import ln_train

    toy = Path(__file__).resolve().parent.parent / "config" / "ln_train_toy.cfg"
    monkeypatch.chdir(tmp_path)
    args = dict(max_epochs=1, overrides=["train.save_checkpoint=false"], device="cpu")
    plain = _first_step_losses(monkeypatch, ln_train, toy, args)
    seen = []
    make = ln_train.make_host_batch

    def recording(clouds, n_points, rng=None, canonical=None):
        seen.append((canonical, threading.current_thread() is threading.main_thread()))
        return make(clouds, n_points, rng, canonical)

    monkeypatch.setattr(ln_train, "make_host_batch", recording)
    monkeypatch.setenv("LNT_CANONICAL_TRAIN", "1")
    canon = _first_step_losses(monkeypatch, ln_train, toy, args)
    assert "LNT_CANONICAL_TRAIN=1" in capsys.readouterr().out
    # the first cloud's sanity build on the main thread; every batch after it
    # in canonical order, made in the loader thread
    assert seen[1:] and all(c == 0.2 and not main for c, main in seen[1:])
    # the first step, from the same weights, has the same loss; later steps
    # drift apart (a max-pool tie's winner follows the point order)
    assert len(canon) == len(plain) == 6 and np.isfinite(canon).all()
    assert abs(canon[0] - plain[0]) <= 1e-5
