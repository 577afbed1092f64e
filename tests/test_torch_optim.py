"""The port's optimizer and schedule vs the JAX package's optax chain.

* ``cosine_warm_restarts`` against the JAX schedule over steps 0..2500,
  for t_mult 1 and 2: to 1e-6 relative (both in f32; ``cos`` may differ in
  its last bit) plus 1e-10 absolute (where the cosine crosses 0).
* Three ``AdamWAmsgrad`` steps on the same gradients against optax, with
  and without the global-norm clip.  The second step's gradients are 100x
  smaller, so the bias-corrected second moment ``nu_hat`` falls: optax keeps
  its max over ``nu_hat``, ``torch.optim.AdamW(amsgrad=True)`` its max over
  the raw moment, and the two part ways there.  Parameters agree to 2e-7
  absolute (O(1) values, updates of ~1e-3 computed in f32 in another
  order), the moments to 1e-5 relative (the bias corrections are f32
  powers of 0.999, which may round differently in their last bit).
* ``opt_state_from_optax``: a run of two optax steps resumes in the port and
  its third step agrees with optax's to the same tolerances.
* ``reduce_on_plateau`` (the chain of every dataset but SemanticKITTI): 40
  updates fed a loss that improves, plateaus past the patience twice and
  improves again, with accumulation 1 and 4.  The updates agree with
  optax's to 1e-6 relative, every plateau-state field exactly (value and
  dtype), and the scale drops twice.  ``opt_state_from_optax`` of the chain
  halfway resumes in the port to the same end.

The JAX ``make_optimizer`` raises ``UnboundLocalError`` when given
``max_grad_norm`` (its function-local ``import optax.contrib`` makes
``optax`` a local name), so the clipped reference is the chain it means to
build: ``clip_by_global_norm`` in front of the unclipped optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu_torch.interop import opt_state_from_optax, params_from_flax
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

PARAM_ATOL = 2e-7
MOMENT_RTOL = 1e-5
SHAPES = {"Layer_0": {"kernel": (5, 4), "bias": (4,)}, "Layer_1": {"scale": (7,)}}


@pytest.mark.parametrize("t_mult", [1, 2])
def test_cosine_warm_restarts_matches_jax(t_mult):
    want = np.asarray(jax.vmap(jo.cosine_warm_restarts(1e-3, 1000, t_mult))(jnp.arange(2501)))
    sched = to.cosine_warm_restarts(1e-3, 1000, t_mult)
    got = np.array([sched(i) for i in range(2501)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    assert got[0] == np.float32(1e-3)


def _tree(rng, scale=1.0):
    return {
        "params": {
            mod: {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in leaves.items()}
            for mod, leaves in SHAPES.items()
        }
    }


def _grads(seed):
    # the second gradients are 100x smaller: nu_hat falls at step 2
    rng = np.random.default_rng(seed)
    g1 = _tree(rng)
    g2 = jax.tree.map(lambda x: x * 0.01, g1)
    g3 = _tree(rng, 0.5)
    return [g1, g2, g3]


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def _jax_tx(max_grad_norm=None, **kw):
    tx = jo.make_optimizer(**kw)
    if max_grad_norm is None:
        return tx
    return optax.chain(optax.clip_by_global_norm(max_grad_norm), tx)


def _jax_run(tx, params, grads):
    state = tx.init(params)
    history = []
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        history.append((params, state))
    return history


def _assert_params(got: dict, want_tree):
    want = _flat(want_tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


def _amsgrad_state(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu_max"))
                if hasattr(s, "nu_max"))  # fmt: skip


@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
@pytest.mark.parametrize("schedule", ["none", "cosine_warm_restarts"])
def test_adamw_amsgrad_matches_optax(schedule, max_grad_norm):
    kw = dict(lr=1e-3, weight_decay=1e-3, schedule=schedule, t0_steps=2, max_grad_norm=max_grad_norm)
    params0 = _tree(np.random.default_rng(0))
    grads = _grads(1)
    history = _jax_run(_jax_tx(**kw), params0, grads)

    tx = to.make_optimizer(**kw)
    params = params_from_flax(params0)
    state = tx.init(params)
    for g, (want_params, want_state) in zip(grads, history):
        updates, state = tx.update(params_from_flax(g), state, params)
        params = {k: p + updates[k] for k, p in params.items()}
        _assert_params(params, want_params)
        ams = _amsgrad_state(want_state)
        assert state["count"] == int(ams.count)
        for name in ("mu", "nu", "nu_max"):
            want = _flat(getattr(ams, name))
            for k, v in state[name].items():
                np.testing.assert_allclose(v.numpy(), want[k], rtol=MOMENT_RTOL, err_msg=name)


def test_torch_amsgrad_is_another_optimizer():
    # the step where nu_hat falls tells optax's max from torch's
    params0 = _tree(np.random.default_rng(0))
    grads = _grads(1)
    history = _jax_run(jo.make_optimizer(1e-3, 1e-3), params0, grads)
    names = list(params_from_flax(params0))
    ps = [params_from_flax(params0)[k].clone().requires_grad_() for k in names]
    opt = torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-3, amsgrad=True)
    moved = []
    for g, (want_params, _) in zip(grads, history):
        gt = params_from_flax(g)
        for p, k in zip(ps, names):
            p.grad = gt[k]
        opt.step()
        want = _flat(want_params)
        moved.append(max(np.abs(p.detach().numpy() - want[k]).max() for p, k in zip(ps, names)))
    assert moved[0] < 1e-6  # step 1: the same update
    assert moved[1] > 1e-4  # step 2: nu_hat fell, torch divides by a smaller max


@pytest.mark.parametrize("max_grad_norm", [None, 1.0])
def test_resume_from_optax_state(max_grad_norm):
    kw = dict(lr=1e-3, weight_decay=1e-3, schedule="cosine_warm_restarts", t0_steps=5,
              max_grad_norm=max_grad_norm)  # fmt: skip
    params0 = _tree(np.random.default_rng(2))
    grads = _grads(3)
    history = _jax_run(_jax_tx(**kw), params0, grads)
    params2, state2 = history[1]

    tx = to.make_optimizer(**kw)
    state = opt_state_from_optax(state2, device="cpu")
    assert state["count"] == 2
    params = params_from_flax(params2)
    updates, state = tx.update(params_from_flax(grads[2]), state, params)
    _assert_params({k: p + updates[k] for k, p in params.items()}, history[2][0])
    assert state["count"] == 3


def _plateau_losses(accumulation, n=40):
    """Per-update losses whose means over ``accumulation`` updates improve,
    stay flat for 5 means (two drops of the scale at a patience of 2), and
    improve again."""
    blocks = n // accumulation
    means = np.array([3.0, 2.5, 2.0] + [2.0] * 5 + list(np.linspace(1.9, 1.0, blocks - 8)))
    jitter = np.random.default_rng(4).normal(0, 1e-3, (blocks, accumulation))
    jitter -= jitter.mean(axis=1, keepdims=True)  # the means stay put
    return (means[:, None] + jitter).reshape(-1).astype(np.float32)


def _assert_plateau_state(got: dict, want):
    for f in to.PLATEAU_FIELDS:
        w = np.asarray(getattr(want, f))
        g = got[f].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("accumulation", [1, 4])
def test_reduce_on_plateau_matches_optax(accumulation):
    kw = dict(lr=1e-3, weight_decay=1e-3, schedule="reduce_on_plateau", plateau_patience=2,
              plateau_factor=0.5, plateau_accumulation=accumulation)  # fmt: skip
    losses = _plateau_losses(accumulation)
    rng = np.random.default_rng(6)
    grads = [_tree(rng) for _ in losses]
    jtx, tx = jo.make_optimizer(**kw), to.make_optimizer(**kw)
    jparams = _tree(np.random.default_rng(7))
    jstate = jdp.TrainState.create(jparams, jtx).opt_state
    params = params_from_flax(jparams)
    state = tx.init(params)
    scales = []
    for i, (g, loss) in enumerate(zip(grads, losses)):
        jup, jstate = jtx.update(g, jstate, jparams, value=jnp.float32(loss))
        jparams = optax.apply_updates(jparams, jup)
        up, state = tx.update(params_from_flax(g), state, params, value=torch.tensor(loss))
        params = {k: p + up[k] for k, p in params.items()}
        for k, v in _flat(jup).items():
            np.testing.assert_allclose(up[k].numpy(), v, rtol=1e-6, atol=0, err_msg=f"update {i} {k}")
        _assert_plateau_state(state["plateau"], jstate[1])
        scales.append(float(state["plateau"]["scale"]))
        if i == len(losses) // 2:  # resume the optax state halfway
            resumed = opt_state_from_optax(jstate, device="cpu")
            _assert_plateau_state(resumed["plateau"], jstate[1])
            assert resumed["count"] == state["count"]
    assert sorted(set(scales), reverse=True) == [1.0, 0.5, 0.25]  # dropped twice
    assert float(state["plateau"]["best_value"]) < 2.0  # and improved after


def test_reduce_on_plateau_needs_the_loss():
    tx = to.make_optimizer(schedule="reduce_on_plateau")
    params = params_from_flax(_tree(np.random.default_rng(0)))
    assert tx.wants_value and not to.make_optimizer(schedule="none").wants_value
    with pytest.raises(ValueError):
        tx.update(params, tx.init(params), params)


def test_unported_schedules_raise():
    # every schedule of the JAX make_optimizer is ported; others raise
    with pytest.raises(ValueError):
        to.make_optimizer(schedule="step")
