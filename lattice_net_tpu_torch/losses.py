"""Segmentation losses: Lovász-Softmax, generalized soft Dice, NLL.

Counterpart of ``lattice_net_tpu/losses.py`` in plain PyTorch with
autograd.  Classes absent from a sample and ignore-labelled or masked
points are masked, not filtered, as in the JAX package.  Only the default
(packed) Lovász formulation is ported.
"""

from __future__ import annotations

import torch

__all__ = ["lovasz_softmax", "nll_loss", "generalized_dice_loss", "segmentation_loss"]


def _lovasz_grad(gt_sorted: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. errors sorted descending
    along the last axis (Alg. 1); invalid entries count in neither the
    intersection nor the union."""
    gt = gt_sorted * valid_sorted
    gts = gt.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt, dim=-1)
    union = gts + torch.cumsum((1.0 - gt_sorted) * valid_sorted, dim=-1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def _pack_lovasz_key(errors: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor):
    """One int32 sort key per entry: ``(error bits << 1) | gt``, -1 where
    invalid.  Valid errors lie in [0, 1], whose f32 bit patterns order like
    the floats and stay below 2^30, so the key fits 31 bits."""
    bits = errors.to(torch.float32).view(torch.int32)
    key = (bits << 1) | gt.to(torch.int32)
    return torch.where(valid, key, -1)


def _lovasz_from_errors_packed(errors, gt, valid, w):
    """The JAX ``_lovasz_from_errors_packed`` with its custom VJP written as
    plain autograd.

    The descending sort of the packed key is ``torch.sort(-key,
    stable=True)``: ``jax.lax.sort`` is stable, so ties keep their input
    order on both sides, and the per-entry gradients inside a tie block,
    which depend on that order, agree.  The sorted errors are gathered from
    ``errors`` (the key's error bits are those errors exactly), so autograd
    routes d loss / d err_s = w * valid * lovasz_grad back through the
    permutation, which is the JAX backward."""
    key = _pack_lovasz_key(errors, gt, valid)
    _, perm = torch.sort(-key, dim=-1, stable=True)
    key_s = key.gather(-1, perm)
    val_s = (key_s >= 0).to(errors.dtype)
    gt_s = (key_s & 1).to(errors.dtype) * val_s
    err_s = errors.gather(-1, perm) * val_s
    grad = _lovasz_grad(gt_s, val_s)
    losses = (err_s * grad * val_s).sum(dim=-1)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def _valid_points(targets, ignore_index, point_mask):
    valid = targets != ignore_index
    return valid if point_mask is None else valid & point_mask


def lovasz_softmax(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-class Lovász-Softmax on (N, C) log-probabilities: per class
    present in the sample, errors |1_{y=c} - p_c| sorted descending and
    dotted with the Lovász gradient; the mean is over present classes."""
    n, nr_classes = log_probs.shape
    probs = torch.exp(log_probs)
    valid = _valid_points(targets, ignore_index, point_mask)
    validf = valid.to(probs.dtype)
    classes = torch.arange(nr_classes, device=log_probs.device)
    gt = (targets[None, :] == classes[:, None]).to(probs.dtype) * validf[None, :]
    diff = gt - probs.T
    # |diff| with JAX's subgradient at 0 (+1, where torch's abs gives 0)
    errors = torch.where(diff >= 0, diff, -diff)
    errors = torch.where(valid[None, :], errors, -1.0)
    present = gt.sum(dim=-1) > 0
    w = present.to(probs.dtype) * (classes != ignore_index).to(probs.dtype)
    return _lovasz_from_errors_packed(errors, gt, valid[None, :].expand(nr_classes, n), w)


def nll_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    class_weights: torch.Tensor | None = None,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``torch.nn.NLLLoss`` semantics with the point mask, as a one-hot
    contraction (the JAX formulation)."""
    n, nr_classes = log_probs.shape
    valid = _valid_points(targets, ignore_index, point_mask)
    t = targets.clamp(0, nr_classes - 1).to(torch.int64)
    classes = torch.arange(nr_classes, device=log_probs.device)
    one_hot = (t[:, None] == classes[None, :]).to(log_probs.dtype)
    picked = (log_probs * one_hot).sum(dim=-1)
    w = torch.ones(n, dtype=log_probs.dtype, device=log_probs.device)
    if class_weights is not None:
        w = class_weights.to(log_probs.dtype)[t]
    w = w * valid.to(log_probs.dtype)
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1e-12)


def generalized_dice_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Generalized soft Dice: per-class 2I/U, the ignore class weighted 0."""
    n, nr_classes = log_probs.shape
    probs = torch.exp(log_probs)
    valid = _valid_points(targets, ignore_index, point_mask)
    validf = valid.to(probs.dtype)[:, None]
    classes = torch.arange(nr_classes, device=log_probs.device)
    # jax.nn.one_hot: out-of-range labels (the ignore label) give zero rows
    one_hot = (targets[:, None] == classes[None, :]).to(probs.dtype) * validf
    probs = probs * validf
    intersect = (one_hot * probs).sum(dim=0)
    denom = (one_hot + probs).sum(dim=0)
    present = one_hot.sum(dim=0) > 0
    w = present.to(probs.dtype) * (classes != ignore_index).to(probs.dtype)
    dice = (2.0 * intersect + 1e-6) / (denom + 1e-6)
    return 1.0 - (dice * w).sum() / torch.clamp(w.sum(), min=1.0)


def segmentation_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    class_weights: torch.Tensor | None = None,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The training objective: 0.5 * Lovász + 0.5 * NLL."""
    lovasz = lovasz_softmax(log_probs, targets, ignore_index, point_mask)
    nll = nll_loss(log_probs, targets, ignore_index, class_weights, point_mask)
    return 0.5 * lovasz + 0.5 * nll
