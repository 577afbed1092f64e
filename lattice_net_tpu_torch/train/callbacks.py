"""Per-class IoU counts on the device (counterpart of
``lattice_net_tpu/train/callbacks.py``'s ``iou_counts_device``)."""

from __future__ import annotations

import torch


def iou_counts_device(logp, target, nr_classes: int, ignore_index: int = -1, point_mask=None):
    """(nr_classes,) int64 intersection and union of the argmax labels with
    the targets over valid points; stays on the device."""
    pred = torch.argmax(logp, dim=-1)
    valid = target != ignore_index
    if point_mask is not None:
        valid = valid & point_mask
    classes = torch.arange(nr_classes, device=logp.device)
    p = (pred[:, None] == classes) & valid[:, None]
    t = (target[:, None] == classes) & valid[:, None]
    return (p & t).sum(dim=0), (p | t).sum(dim=0)
