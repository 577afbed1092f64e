"""The train step: batch, loss, gradients and optimizer update (counterpart
of ``lattice_net_tpu/parallel/data_parallel.py``).

As in the JAX package, the step is a function of an immutable
:class:`TrainState` (a ``{name: tensor}`` parameter dict, the optimizer
state and the step count) and a padded batch.  The model's module supplies
the computation; :func:`torch.func.functional_call` runs it on the state's
parameters.  A batch of B clouds is a loop over the clouds whose losses
are averaged (the JAX package vmaps it); data parallelism over several
cards is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.losses import segmentation_loss
from lattice_net_tpu_torch.train.callbacks import iou_counts_device


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict  # {name: tensor}, the model's state_dict names
    opt_state: dict
    step: int

    @classmethod
    def create(cls, params, tx):
        """State at step 0 for ``params`` (any ``{name: tensor}`` mapping,
        e.g. ``model.state_dict()``) and the optimizer ``tx``."""
        params = {k: v.detach() for k, v in dict(params).items()}
        return cls(params=params, opt_state=tx.init(params), step=0)


_batch_rng = np.random.default_rng(0)


def make_batch(clouds, n_points: int, rng: np.random.Generator | None = None, device=None):
    """Pad a list of (positions, values, target) numpy triples to a static
    batch on ``device`` (the card unless ``"cpu"``).

    Returns ``positions`` (B, N, d) f32, ``values`` (B, N, C) f32,
    ``target`` (B, N) int32 and ``point_mask`` (B, N) bool.  Clouds larger
    than ``n_points`` are subsampled with ``rng.choice`` (the module's own
    generator when ``rng`` is None), so the same numpy generator picks the
    same points as the JAX package's ``make_batch``."""
    device = resolve_device(device)
    rng = _batch_rng if rng is None else rng
    ps, vs, ts, ms = [], [], [], []
    for positions, values, target in clouds:
        n = positions.shape[0]
        if n > n_points:
            sel = rng.choice(n, n_points, replace=False)
            positions, values, target = positions[sel], values[sel], target[sel]
            n = n_points
        pad = n_points - n
        ps.append(np.pad(positions, ((0, pad), (0, 0))))
        vs.append(np.pad(values, ((0, pad), (0, 0))))
        ts.append(np.pad(target, (0, pad)))
        ms.append(np.arange(n_points) < n)
    out = {
        "positions": np.stack(ps).astype(np.float32),
        "values": np.stack(vs).astype(np.float32),
        "target": np.stack(ts).astype(np.int32),
        "point_mask": np.stack(ms),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def make_loss_fn(
    model,
    sigma,
    nr_levels: int,
    capacities: Sequence[int],
    ignore_index: int = -1,
    class_weights=None,
):
    """``loss_fn(params, batch, plain=False) -> (loss, metrics)``: the mean
    over the batch's clouds of each cloud's hierarchy build, forward and
    ``segmentation_loss``, with the JAX step's metrics (``loss``, ``acc``,
    ``nr_verts_mean``, ``nr_overflow_mean``, ``nr_points_mean``,
    ``iou_intersection``, ``iou_union``), all left on the device.

    ``plain=True`` runs the kernels' plain versions, forward and backward,
    to hold the kernels against them on the card."""
    capacities = tuple(int(c) for c in capacities)

    def per_cloud(params, positions, values, target, point_mask, plain):
        h = build_hierarchy(
            positions, sigma, nr_levels, capacities, point_mask=point_mask, point_feats=values
        )
        logp, _ = functional_call(model, params, (h, positions, values), {"plain": plain})
        loss = segmentation_loss(logp, target, ignore_index, class_weights, point_mask)
        valid = point_mask & (target != ignore_index)
        correct = ((torch.argmax(logp, dim=-1) == target) & valid).sum()
        inter, union = iou_counts_device(logp, target, logp.shape[-1], ignore_index, point_mask)
        overflow = sum(s.nr_overflow for s in h.structures)
        aux = (correct, valid.sum(), h.structures[0].nr_verts, overflow, inter, union)
        return loss, aux + (point_mask.sum(),)

    def loss_fn(params, batch, plain=False):
        fields = ("positions", "values", "target", "point_mask")
        outs = [
            per_cloud(params, *(batch[f][i] for f in fields), plain)
            for i in range(batch["positions"].shape[0])
        ]
        loss = torch.stack([o[0] for o in outs]).mean()
        correct, valid, nr_verts, overflow, inter, union, nr_points = (
            torch.stack([o[1][j] for o in outs]) for j in range(7)
        )
        metrics = {
            "loss": loss.detach(),
            "acc": correct.sum() / torch.clamp(valid.sum(), min=1),
            "nr_verts_mean": nr_verts.float().mean(),
            "nr_overflow_mean": overflow.float().mean(),
            "nr_points_mean": nr_points.float().mean(),
            "iou_intersection": inter.sum(dim=0),
            "iou_union": union.sum(dim=0),
        }
        return loss, metrics

    return loss_fn


def forward_loss(loss_fn, params, batch, plain=False):
    """The step's first stage: ``(leaves, loss, metrics)``, ``loss_fn`` run
    on fresh leaves of ``params`` (sharing their storage) that require
    grad."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, metrics = loss_fn(leaves, batch, plain=plain)
    return leaves, loss, metrics


def gradients(loss, leaves):
    """The step's second stage: ``{name: d loss / d leaf}``, zeros where the
    loss does not reach a leaf."""
    grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    return dict(zip(leaves, grads))


def apply_update(tx, state: TrainState, grads) -> TrainState:
    """The step's last stage: the next state after ``tx``'s update with
    ``grads``, in new tensors."""
    with torch.no_grad():
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = {k: p + updates[k] for k, p in state.params.items()}
    return TrainState(new_params, opt_state, state.step + 1)


def make_train_step(
    model, tx, sigma, nr_levels, capacities, ignore_index=-1, class_weights=None
):
    """``train_step(state, batch) -> (new_state, metrics)``: gradients of
    :func:`make_loss_fn`'s loss in every parameter, then ``tx``'s update
    (:func:`forward_loss`, :func:`gradients`, :func:`apply_update`).  The
    step allocates new parameter and optimizer tensors and leaves ``state``
    as it was."""
    loss_fn = make_loss_fn(model, sigma, nr_levels, capacities, ignore_index, class_weights)

    def train_step(state: TrainState, batch):
        leaves, loss, metrics = forward_loss(loss_fn, state.params, batch)
        return apply_update(tx, state, gradients(loss, leaves)), metrics

    return train_step
