"""The train step: batch, loss, gradients and optimizer update (counterpart
of ``lattice_net_tpu/parallel/data_parallel.py``).

As in the JAX package, the step is a function of an immutable
:class:`TrainState` (a ``{name: tensor}`` parameter dict, the optimizer
state and the step count) and a padded batch.  The model's module supplies
the computation; :func:`torch.func.functional_call` runs it on the state's
parameters.  A batch of B clouds is a loop over the clouds whose losses
are averaged (the JAX package vmaps it).  :func:`make_dp_train_step` is
the data-parallel step over a mesh axis of torch.distributed ranks (see
``parallel/mesh.py``): each rank takes its slice of the batch
(:func:`shard_batch`), gradients and metrics are pmean'd, and every rank
applies the same update to its replica of the state
(:func:`replicate_state`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call

from lattice_net_tpu_torch import tracing
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.host_order import canonical_point_order_np
from lattice_net_tpu_torch.lattice.structure import build_hierarchy, static_general_branches
from lattice_net_tpu_torch.losses import segmentation_loss
from lattice_net_tpu_torch.parallel.mesh import Mesh, broadcast_tree, check_replicated
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


def make_host_batch(
    clouds, n_points: int, rng: np.random.Generator | None = None, canonical=None
) -> dict:
    """Pad a list of (positions, values, target) numpy triples to a static
    batch of numpy arrays: ``positions`` (B, N, d) f32, ``values`` (B, N, C)
    f32, ``target`` (B, N) int32 and ``point_mask`` (B, N) bool.  Clouds
    larger than ``n_points`` are subsampled with ``rng.choice`` (the
    module's own generator when ``rng`` is None), so the same numpy
    generator picks the same points as the JAX package's ``make_batch``.
    ``canonical`` (a sigma, or None) reorders each cloud by
    ``canonical_point_order_np`` for the build's ``canonical_points`` path;
    the padded suffix stays last.  It touches no device, so a loader thread
    may call it."""
    rng = _batch_rng if rng is None else rng
    ps, vs, ts, ms = [], [], [], []
    for positions, values, target in clouds:
        n = positions.shape[0]
        if n > n_points:
            sel = rng.choice(n, n_points, replace=False)
            positions, values, target = positions[sel], values[sel], target[sel]
            n = n_points
        if canonical is not None:
            order = canonical_point_order_np(positions, canonical)
            positions, values, target = positions[order], values[order], target[order]
        pad = n_points - n
        ps.append(np.pad(positions, ((0, pad), (0, 0))))
        vs.append(np.pad(values, ((0, pad), (0, 0))))
        ts.append(np.pad(target, (0, pad)))
        ms.append(np.arange(n_points) < n)
    return {
        "positions": np.stack(ps).astype(np.float32),
        "values": np.stack(vs).astype(np.float32),
        "target": np.stack(ts).astype(np.int32),
        "point_mask": np.stack(ms),
    }


def to_device(host_batch: dict, device=None) -> dict:
    """A :func:`make_host_batch` batch as tensors on ``device`` (the card
    unless ``"cpu"``)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}


def make_batch(
    clouds, n_points: int, rng: np.random.Generator | None = None, device=None, canonical=None
):
    """:func:`make_host_batch` on ``device`` (the card unless ``"cpu"``)."""
    return to_device(make_host_batch(clouds, n_points, rng, canonical), device)


def make_loss_fn(
    model,
    sigma,
    nr_levels: int,
    capacities: Sequence[int],
    ignore_index: int = -1,
    class_weights=None,
    full_mask: bool = False,
    canonical_points: bool = False,
    force_vmap: bool = False,
):
    """``loss_fn(params, batch, generator=None, train=True, plain=False) ->
    (loss, metrics)``: the mean over the batch's clouds of each cloud's
    hierarchy build, forward and ``segmentation_loss``, with the JAX step's
    metrics (``loss``, ``acc``, ``nr_verts_mean``, ``nr_overflow_mean``,
    ``nr_points_mean``, ``iou_intersection``, ``iou_union``), all left on
    the device.

    ``train`` and ``generator`` are the JAX ``train`` and ``rng``: the
    forward runs in training mode (the head's channel dropout, if the model
    has one, draws from ``generator``; the clouds of a batch draw one after
    another).  ``plain=True`` runs the kernels' plain versions, forward and
    backward, to hold the kernels against them on the card.

    ``full_mask=True`` promises that every point mask is all true (the
    loader's clouds all have the batch's size): the build then gets
    ``point_mask=None``, as the JAX package's does; the loss and the
    metrics still apply the mask.

    ``canonical_points=True`` builds level 0 by the corner-dedup fast build;
    the batch then comes from ``make_host_batch(..., canonical=sigma)``
    (any order stays right, an order that is not canonical is only
    slower).

    A batch of more than one cloud (or of one, with ``force_vmap``, the JAX
    flag that keeps its vmapped program) builds every cloud under
    :func:`static_general_branches`, as JAX's vmapped build traces: the
    general branch of each data-dependent fast path, with no host read.  A
    batch of one takes the fast paths."""
    capacities = tuple(int(c) for c in capacities)

    def per_cloud(params, positions, values, target, point_mask, generator, train, plain):
        h = build_hierarchy(
            positions, sigma, nr_levels, capacities,
            point_mask=None if full_mask else point_mask, point_feats=values,
            canonical_points=canonical_points,
        )  # fmt: skip
        kwargs = dict(plain=plain, train=train, generator=generator)
        logp, _ = functional_call(model, params, (h, positions, values), kwargs)
        loss = segmentation_loss(logp, target, ignore_index, class_weights, point_mask)
        valid = point_mask & (target != ignore_index)
        correct = ((torch.argmax(logp, dim=-1) == target) & valid).sum()
        inter, union = iou_counts_device(logp, target, logp.shape[-1], ignore_index, point_mask)
        overflow = sum(s.nr_overflow for s in h.structures)
        aux = (correct, valid.sum(), h.structures[0].nr_verts, overflow, inter, union)
        return loss, aux + (point_mask.sum(),)

    def loss_fn(params, batch, generator=None, train=True, plain=False):
        fields = ("positions", "values", "target", "point_mask")
        b = batch["positions"].shape[0]
        branches = static_general_branches() if b > 1 or force_vmap else contextlib.nullcontext()
        with branches:
            outs = [per_cloud(params, *(batch[f][i] for f in fields), generator, train, plain) for i in range(b)]
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


def forward_loss(loss_fn, params, batch, generator=None, plain=False):
    """The step's first stage: ``(leaves, loss, metrics)``, ``loss_fn`` run
    in training mode on fresh leaves of ``params`` (sharing their storage)
    that require grad."""
    with tracing.span(tracing.STEP_FORWARD_LOSS):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, metrics = loss_fn(leaves, batch, generator, plain=plain)
    return leaves, loss, metrics


def gradients(loss, leaves):
    """The step's second stage: ``{name: d loss / d leaf}``, zeros where the
    loss does not reach a leaf."""
    with tracing.span(tracing.STEP_BACKWARD):
        grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    return dict(zip(leaves, grads))


def apply_update(tx, state: TrainState, grads, loss=None) -> TrainState:
    """The step's last stage: the next state after ``tx``'s update with
    ``grads``, in new tensors.  An optimizer that ``wants_value`` (the
    plateau stage) gets the step's ``loss``, left on the device."""
    with tracing.span(tracing.STEP_UPDATE), torch.no_grad():
        extra = {"value": loss.detach()} if tx.wants_value else {}
        updates, opt_state = tx.update(grads, state.opt_state, state.params, **extra)
        new_params = {k: p + updates[k] for k, p in state.params.items()}
    return TrainState(new_params, opt_state, state.step + 1)


def make_train_step(
    model, tx, sigma, nr_levels, capacities, ignore_index=-1, class_weights=None,
    full_mask=False, canonical_points=False,
):  # fmt: skip
    """``train_step(state, batch, generator=None) -> (new_state, metrics)``:
    gradients of :func:`make_loss_fn`'s training loss in every parameter,
    then ``tx``'s update (:func:`forward_loss`, :func:`gradients`,
    :func:`apply_update`).  ``generator`` feeds the head's channel dropout
    (JAX's ``rng``).  The step allocates new parameter and optimizer tensors
    and leaves ``state`` as it was."""
    loss_fn = make_loss_fn(
        model, sigma, nr_levels, capacities, ignore_index, class_weights, full_mask,
        canonical_points,
    )  # fmt: skip

    def train_step(state: TrainState, batch, generator=None):
        leaves, loss, metrics = forward_loss(loss_fn, state.params, batch, generator)
        return apply_update(tx, state, gradients(loss, leaves), loss), metrics

    return train_step


def make_dp_train_step(
    model, tx, mesh: Mesh, sigma, nr_levels, capacities, ignore_index=-1, class_weights=None,
    axis: str = "dp", canonical_points=False, full_mask=False,
):  # fmt: skip
    """The data-parallel train step: ``step(state, batch, generator=None) ->
    (new_state, metrics)`` with ``batch`` this rank's slice of the global
    batch (:func:`shard_batch`).  Each rank differentiates the loss of its
    clouds, one all-reduce averages the gradients (another the metrics)
    over ``axis``, and every rank applies the same update to its replica of
    the state.  ``generator`` is this rank's (:func:`rank_generator`): the
    JAX step folds its rng with the axis index instead, so dropout masks
    differ from JAX's."""
    loss_fn = make_loss_fn(
        model, sigma, nr_levels, capacities, ignore_index, class_weights, full_mask, canonical_points
    )

    def step(state: TrainState, batch, generator=None):
        leaves, loss, metrics = forward_loss(loss_fn, state.params, batch, generator)
        grads = mesh.pmean_tree(gradients(loss, leaves), axis)
        metrics = mesh.pmean_tree({k: v.to(torch.float32) for k, v in metrics.items()}, axis)
        return apply_update(tx, state, grads, metrics["loss"]), metrics

    return step


def replicate_state(state: TrainState) -> TrainState:
    """``state`` as rank 0 holds it, on every rank (a broadcast of the
    parameters and the optimizer state), checked bit-equal across ranks."""
    params, opt_state = broadcast_tree(state.params), broadcast_tree(state.opt_state)
    check_replicated({"params": params, "opt_state": opt_state})
    return TrainState(params, opt_state, state.step)


def shard_batch(host_batch: dict, mesh: Mesh, axis: str = "dp", device=None) -> dict:
    """This rank's slice of a :func:`make_host_batch` batch along ``axis``
    (the batch size must divide evenly), on ``device``."""
    n, i = mesh.size(axis), mesh.axis_index(axis)
    b = len(next(iter(host_batch.values())))
    if b % n:
        raise ValueError(f"a batch of {b} clouds does not split over the {n} ranks of axis {axis!r}")
    per = b // n
    return to_device({k: v[i * per : (i + 1) * per] for k, v in host_batch.items()}, device)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The dropout generator of one rank: seeded from (seed, rank)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(rank))
