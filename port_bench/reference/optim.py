"""The training optimizer and LR schedules (counterpart of
``lattice_net_tpu/train/optim.py``).

The JAX package builds AdamW-amsgrad as the optax chain
``scale_by_amsgrad -> add_decayed_weights -> scale_by_learning_rate``, with
``clip_by_global_norm`` in front when asked, and for every dataset but
SemanticKITTI ``optax.contrib.reduce_on_plateau`` behind it.
:class:`AdamWAmsgrad` is that chain written out over dictionaries of
tensors, in optax's order of operations, and :class:`ReduceOnPlateau` the
plateau stage.  It is not ``torch.optim.AdamW(amsgrad=True)``: optax takes the
running max over the bias-corrected second moment ``nu_hat`` and divides
by nothing afterwards, torch takes it over the raw second moment and
divides by the bias correction afterwards, and the two part ways at the
first step where ``nu_hat`` falls.

The schedule is evaluated on the host in float32 from the step count, which
stays a Python int; the plateau state stays on the device.  So a step makes
no device-to-host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["cosine_warm_restarts", "ReduceOnPlateau", "AdamWAmsgrad", "make_optimizer"]

# optax's defaults for scale_by_amsgrad, the only values the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_warm_restarts(base_lr: float, t0_steps: int):
    """torch ``CosineAnnealingWarmRestarts`` (T_mult 1, eta_min 0) as a
    function of the 0-based step count, in float32 as the JAX schedule
    computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        t_cur = np.fmod(f32(count), f32(t0_steps))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t_cur / f32(t0_steps)))
        return float(f32(base_lr) * cos)

    return schedule


# optax's reduce_on_plateau fields, in its ReduceLROnPlateauState order
PLATEAU_FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count", "avg_value")
_INT32_MAX = 2**31 - 1
PLATEAU_RTOL = 1e-4  # optax's default; atol 0, cooldown 0 and min_scale 0 drop out


def _safe_increment(x: torch.Tensor) -> torch.Tensor:
    """optax's ``numerics.safe_increment`` of an int32: saturates at the max."""
    return torch.where(x < _INT32_MAX, x + 1, x)


@dataclasses.dataclass(frozen=True)
class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` with the JAX package's arguments
    (rtol 1e-4, atol 0, cooldown 0, min_scale 0): every update is scaled
    by ``scale``, which drops by ``factor`` after ``patience``
    accumulations of ``accumulation`` losses without improvement.
    :class:`AdamWAmsgrad` folds the scale into its learning rate.

    The state is optax's, as f32 and int32 0-d tensors on the parameters'
    device: ``scale``, ``best_value``, ``plateau_count``, ``cooldown_count``
    (always 0 at cooldown 0), ``count`` and ``avg_value``.  :meth:`update`
    uses no host value, so it reads nothing back from the card."""

    patience: int = 10
    factor: float = 0.1
    accumulation: int = 1

    def _update_scale(self, st: dict) -> dict:
        """optax's ``_update_scale`` outside a cooldown: improvement is ``avg
        < (1 - rtol) * best - atol``.  A Python float times an f32 tensor
        is rounded to f32 first, as JAX rounds a weakly typed scalar."""
        zero = torch.zeros_like(st["plateau_count"])
        improved = st["avg_value"] < st["best_value"] * (1 - PLATEAU_RTOL)
        plateau = torch.where(improved, zero, _safe_increment(st["plateau_count"]))
        hit = plateau == self.patience
        return dict(
            scale=torch.where(hit, st["scale"] * self.factor, st["scale"]),
            best_value=torch.where(improved, st["avg_value"], st["best_value"]),
            plateau_count=torch.where(hit, zero, plateau),
            cooldown_count=zero,
            count=zero,
            avg_value=torch.zeros_like(st["avg_value"]),
        )

    def update(self, state: dict, value: torch.Tensor) -> dict:
        """The new state after folding ``value`` (the step's loss) into the
        running mean; its ``scale`` multiplies this step's update."""
        count = state["count"]
        new_count = _safe_increment(count)
        avg = (count.to(torch.float32) * state["avg_value"] + value.to(torch.float32)) / (
            new_count.to(torch.float32)
        )
        st = dict(state, avg_value=avg, count=new_count)
        ready = new_count == self.accumulation
        scaled = self._update_scale(st)
        return {k: torch.where(ready, scaled[k], st[k]) for k in PLATEAU_FIELDS}


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclasses.dataclass(frozen=True)
class AdamWAmsgrad:
    """AdamW with amsgrad, decoupled weight decay on every parameter (no
    mask), an optional global-norm clip and an optional plateau stage, over
    ``{name: tensor}`` dicts.

    The state is the port's ``{"count", "mu", "nu", "nu_max"}`` (the optax
    amsgrad state; ``count`` also drives the schedule), plus ``"plateau"``
    (the :class:`ReduceOnPlateau` state) when ``plateau`` is set; the
    reference takes it from the program.  ``update(grads, state, params,
    value=None)`` returns ``(updates,
    new_state)``; the new parameters are ``params + updates``.  ``value``,
    the step's loss, is required when ``wants_value``.
    """

    learning_rate: float | Callable[[int], float]
    weight_decay: float = 0.0
    max_grad_norm: float | None = None
    plateau: ReduceOnPlateau | None = None

    @property
    def wants_value(self) -> bool:
        return self.plateau is not None

    def update(self, grads: dict, state: dict, params: dict, value: torch.Tensor | None = None):
        if self.wants_value and value is None:
            raise ValueError("the plateau stage needs the step's loss: pass value=")
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
        step = float(-np.float32(lr(state["count"]) if callable(lr) else lr))
        new = {"count": count, "mu": {}, "nu": {}, "nu_max": {}}
        if self.plateau is not None:
            # the plateau stage scales the whole update: fold its scale into
            # the learning rate, a 0-d tensor that stays on the device
            new["plateau"] = self.plateau.update(state["plateau"], value)
            step = new["plateau"]["scale"] * step
        updates = {}
        for k, g in grads.items():
            mu = (1 - B1) * g + B1 * state["mu"][k]
            nu = (1 - B2) * (g * g) + B2 * state["nu"][k]
            nu_max = torch.maximum(state["nu_max"][k], nu / bc2)
            u = (mu / bc1) / (torch.sqrt(nu_max) + EPS)
            updates[k] = step * (u + self.weight_decay * params[k])
            new["mu"][k], new["nu"][k], new["nu_max"][k] = mu, nu, nu_max
        return updates, new


def make_optimizer(
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    schedule: str = "none",
    t0_steps: int = 3000,
    max_grad_norm: float | None = None,
    plateau_patience: int = 10,
    plateau_factor: float = 0.1,
    plateau_accumulation: int = 1,
) -> AdamWAmsgrad:
    """The training optimizer from config-level knobs: ``schedule`` is
    ``"none"``, ``"cosine_warm_restarts"`` (the SemanticKITTI recipe) or
    ``"reduce_on_plateau"`` (the other datasets: a constant lr scaled down
    by ``plateau_factor`` after ``plateau_patience`` means of
    ``plateau_accumulation`` step losses without improvement; the trainer
    sets the accumulation to the steps of an epoch)."""
    plateau = None
    if schedule == "cosine_warm_restarts":
        learning_rate = cosine_warm_restarts(lr, t0_steps)
    elif schedule in ("none", "reduce_on_plateau"):
        learning_rate = lr
    else:
        raise ValueError(f"unknown schedule {schedule}")
    if schedule == "reduce_on_plateau":
        plateau = ReduceOnPlateau(plateau_patience, plateau_factor, max(1, plateau_accumulation))
    return AdamWAmsgrad(learning_rate, weight_decay, max_grad_norm, plateau)
