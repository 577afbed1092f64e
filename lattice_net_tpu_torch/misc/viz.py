"""Offline visual diagnostics: PLY dumps of predictions, GT diffs, features.

A copy of ``lattice_net_tpu/misc/viz.py`` (numpy only).  The reference
renders these live through easypbr's viewer
(``callbacks/viewer_callback.py:15-83``: prediction cloud, difference-to-GT
cloud, per-point confidence, PCA of features); here the same four
diagnostics are standard binary PLY files that any viewer (MeshLab,
CloudCompare, Open3D) opens.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = [
    "write_ply",
    "class_color_map",
    "prediction_cloud",
    "diff_cloud",
    "confidence_cloud",
    "pca_feature_cloud",
]


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY with per-vertex uchar colors."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    if not (xyz.shape[0] == rgb.shape[0] and xyz.shape[1] == 3 and rgb.shape[1] == 3):
        raise ValueError(f"write_ply needs (N, 3) xyz and rgb, got {xyz.shape} and {rgb.shape}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(xyz)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(
        len(xyz),
        dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
    )
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def class_color_map(nr_classes: int, seed: int = 3) -> np.ndarray:
    """(nr_classes, 3) uint8 — stable distinct colors, class 0 dark grey."""
    rng = np.random.default_rng(seed)
    hues = (np.arange(nr_classes) * 0.61803398875) % 1.0  # golden-ratio spacing
    sat = 0.55 + 0.35 * rng.random(nr_classes)
    val = 0.75 + 0.25 * rng.random(nr_classes)
    h6 = hues * 6.0
    i = h6.astype(int) % 6
    f = h6 - np.floor(h6)
    p, q, t = val * (1 - sat), val * (1 - sat * f), val * (1 - sat * (1 - f))
    rgb = np.select(
        [(i == k)[:, None] for k in range(6)],
        [
            np.stack([val, t, p], -1), np.stack([q, val, p], -1),
            np.stack([p, val, t], -1), np.stack([p, q, val], -1),
            np.stack([t, p, val], -1), np.stack([val, p, q], -1),
        ],
    )
    rgb = (rgb * 255).astype(np.uint8)
    rgb[0] = (60, 60, 60)
    return rgb


def prediction_cloud(path, xyz, pred, nr_classes: int) -> None:
    """Per-point predicted-class colors (``viewer_callback.py:35-45`` analogue)."""
    cmap = class_color_map(nr_classes)
    write_ply(path, xyz, cmap[np.clip(pred, 0, nr_classes - 1)])


def diff_cloud(path, xyz, pred, target, ignore_index: int = -1) -> None:
    """Green = correct, red = wrong, grey = ignored (``viewer_callback.py:47-58``)."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    rgb = np.where(
        (target == ignore_index)[:, None],
        np.array([[80, 80, 80]]),
        np.where((pred == target)[:, None], np.array([[40, 180, 60]]), np.array([[220, 40, 40]])),
    )
    write_ply(path, xyz, rgb)


def confidence_cloud(path, xyz, log_probs) -> None:
    """Max-probability heat map: blue (unsure) -> red (confident)."""
    p = np.exp(np.max(np.asarray(log_probs), axis=-1))
    rgb = np.stack([255 * p, 40 * np.ones_like(p), 255 * (1 - p)], axis=-1)
    write_ply(path, xyz, rgb)


def pca_feature_cloud(path, xyz, features) -> None:
    """First 3 PCA components of per-point features as RGB
    (``viewer_callback.py:60-83`` analogue)."""
    f = np.asarray(features, np.float64)
    f = f - f.mean(0, keepdims=True)
    # economical PCA via covariance eigendecomposition (C x C, C small)
    cov = f.T @ f / max(len(f) - 1, 1)
    w, v = np.linalg.eigh(cov)
    comps = f @ v[:, ::-1][:, :3]
    lo, hi = np.percentile(comps, 2, axis=0), np.percentile(comps, 98, axis=0)
    rgb = 255 * np.clip((comps - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    if rgb.shape[1] < 3:
        rgb = np.pad(rgb, ((0, 0), (0, 3 - rgb.shape[1])))
    write_ply(path, xyz, rgb)
