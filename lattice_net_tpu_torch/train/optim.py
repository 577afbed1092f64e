"""The training optimizer and LR schedules (counterpart of
``lattice_net_tpu/train/optim.py``).

The JAX package builds AdamW-amsgrad as the optax chain
``scale_by_amsgrad -> add_decayed_weights -> scale_by_learning_rate``, with
``clip_by_global_norm`` in front when asked.  :class:`AdamWAmsgrad` is that
chain written out over dictionaries of tensors, in optax's order of
operations.  It is not ``torch.optim.AdamW(amsgrad=True)``: optax takes the
running max over the bias-corrected second moment ``nu_hat`` and divides
by nothing afterwards, torch takes it over the raw second moment and
divides by the bias correction afterwards, and the two part ways at the
first step where ``nu_hat`` falls.

The schedule is evaluated on the host in float32 from the step count, which
stays a Python int, so a step makes no device-to-host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["cosine_warm_restarts", "AdamWAmsgrad", "make_optimizer"]

# optax's defaults for scale_by_amsgrad, the only values the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_warm_restarts(base_lr: float, t0_steps: int, t_mult: int = 1, eta_min: float = 0.0):
    """torch ``CosineAnnealingWarmRestarts`` as a function of the 0-based
    step count, in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        count = f32(count)
        if t_mult == 1:
            t_cur = np.fmod(count, f32(t0_steps))
            t_i = f32(t0_steps)
        else:
            ratio = count * f32(t_mult - 1) / f32(t0_steps) + f32(1.0)
            n = np.floor(np.log(ratio) / np.log(f32(t_mult)))
            start = f32(t0_steps) * (np.power(f32(t_mult), n) - f32(1.0)) / f32(t_mult - 1)
            t_cur = count - start
            t_i = f32(t0_steps) * np.power(f32(t_mult), n)
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t_cur / t_i))
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min)) * cos)

    return schedule


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclasses.dataclass(frozen=True)
class AdamWAmsgrad:
    """AdamW with amsgrad, decoupled weight decay on every parameter (no
    mask) and an optional global-norm clip, over ``{name: tensor}`` dicts.

    ``init(params)`` gives the state ``{"count": 0, "mu", "nu", "nu_max"}``
    (the optax amsgrad state; ``count`` also drives the schedule, whose own
    optax count always equals it).  ``update(grads, state, params)`` returns
    ``(updates, new_state)``; the new parameters are ``params + updates``.
    """

    learning_rate: float | Callable[[int], float]
    weight_decay: float = 0.0
    max_grad_norm: float | None = None

    def init(self, params: dict) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros(), "nu_max": zeros()}

    def update(self, grads: dict, state: dict, params: dict):
        grads = {k: grads[k] for k in params}
        if self.max_grad_norm is not None:
            norm = _global_norm(grads.values())
            keep = norm < self.max_grad_norm
            grads = {
                k: torch.where(keep, g, (g / norm) * self.max_grad_norm) for k, g in grads.items()
            }
        count = state["count"] + 1
        # the bias corrections in f32, as optax forms 1 - decay**count
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        lr = self.learning_rate
        step = -np.float32(lr(state["count"]) if callable(lr) else lr)
        new = {"count": count, "mu": {}, "nu": {}, "nu_max": {}}
        updates = {}
        for k, g in grads.items():
            mu = (1 - B1) * g + B1 * state["mu"][k]
            nu = (1 - B2) * (g * g) + B2 * state["nu"][k]
            nu_max = torch.maximum(state["nu_max"][k], nu / bc2)
            u = (mu / bc1) / (torch.sqrt(nu_max) + EPS)
            updates[k] = float(step) * (u + self.weight_decay * params[k])
            new["mu"][k], new["nu"][k], new["nu_max"][k] = mu, nu, nu_max
        return updates, new


def make_optimizer(
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    schedule: str = "none",
    t0_steps: int = 3000,
    max_grad_norm: float | None = None,
) -> AdamWAmsgrad:
    """The training optimizer from config-level knobs: ``schedule`` is
    ``"none"`` or ``"cosine_warm_restarts"`` (the SemanticKITTI recipe).
    ``"reduce_on_plateau"`` (the other datasets) is not ported yet."""
    if schedule == "cosine_warm_restarts":
        learning_rate = cosine_warm_restarts(lr, t0_steps)
    elif schedule == "none":
        learning_rate = lr
    elif schedule == "reduce_on_plateau":
        raise NotImplementedError("schedule 'reduce_on_plateau' is not ported yet")
    else:
        raise ValueError(f"unknown schedule {schedule}")
    return AdamWAmsgrad(learning_rate, weight_decay, max_grad_norm)
