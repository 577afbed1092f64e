"""The port's losses vs the JAX package's, values and input gradients.

Inputs are made with numpy: log-probabilities of 600 points over 6
classes, with ignore labels, a point mask, a class that never occurs, and
(in the "ties" case) logits drawn from a few integers, so many errors tie
exactly and the Lovász sort must keep JAX's stable order for the per-entry
gradients to agree.  Values and gradients agree to 1e-6 absolute (f32 sums
in another order; every term is O(1) and there are a few hundred).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu import losses as jl
from lattice_net_tpu_torch import losses as tl

torch.set_num_threads(2)

ATOL = 1e-6
N, C = 600, 6


def _case(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        logits = rng.integers(0, 3, size=(N, C)).astype(np.float32)
    else:
        logits = rng.normal(size=(N, C)).astype(np.float32) * 2
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    target = rng.integers(0, C - 1, size=N).astype(np.int32)  # class C-1 never occurs
    target[rng.random(N) < 0.1] = -1  # ignore label
    mask = rng.random(N) < 0.9
    weights = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    return logp, target, mask, weights


def _jax(name, logp, target, mask, weights, ignore_index):
    fn = getattr(jl, name)
    kw = dict(ignore_index=ignore_index, point_mask=jnp.asarray(mask))
    if name in ("nll_loss", "segmentation_loss"):
        kw["class_weights"] = jnp.asarray(weights)
    value, grad = jax.value_and_grad(lambda lp: fn(lp, jnp.asarray(target), **kw))(
        jnp.asarray(logp)
    )
    return float(value), np.asarray(grad)


def _torch(name, logp, target, mask, weights, ignore_index):
    fn = getattr(tl, name)
    kw = dict(ignore_index=ignore_index, point_mask=torch.from_numpy(mask))
    if name in ("nll_loss", "segmentation_loss"):
        kw["class_weights"] = torch.from_numpy(weights)
    lp = torch.from_numpy(logp).requires_grad_()
    value = fn(lp, torch.from_numpy(target), **kw)
    (grad,) = torch.autograd.grad(value, lp)
    return float(value), grad.numpy()


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("ignore_index", [-1, 2])
@pytest.mark.parametrize(
    "name", ["lovasz_softmax", "nll_loss", "generalized_dice_loss", "segmentation_loss"]
)
def test_loss_and_gradient_match_jax(name, ignore_index, kind):
    args = (*_case(kind), ignore_index)
    vj, gj = _jax(name, *args)
    vt, gt = _torch(name, *args)
    assert abs(vj - vt) <= ATOL, (vj, vt)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=ATOL)


def test_ties_case_has_tied_errors():
    logp, target, mask, _ = _case("ties")
    p = np.exp(logp[:, 0])[mask & (target >= 0)]
    assert len(np.unique(p)) < len(p) // 5


def test_packed_key_sorts_like_jax():
    # the key folds (error bits, gt, valid); ties among equal keys keep the
    # input order in both sorts
    rng = np.random.default_rng(3)
    errors = rng.integers(0, 4, size=(3, 50)).astype(np.float32) / 4
    gt = (rng.random((3, 50)) < 0.5).astype(np.float32)
    valid = rng.random((3, 50)) < 0.8
    kj = jl._pack_lovasz_key(jnp.asarray(errors), jnp.asarray(gt), jnp.asarray(valid))
    kt = tl._pack_lovasz_key(torch.from_numpy(errors), torch.from_numpy(gt), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    iota = jnp.broadcast_to(jnp.arange(50, dtype=jnp.int32), (3, 50))
    _, perm_j = jax.lax.sort((-kj, iota), num_keys=1)
    _, perm_t = torch.sort(-kt, dim=-1, stable=True)
    np.testing.assert_array_equal(np.asarray(perm_j), perm_t.numpy())
