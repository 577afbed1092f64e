"""The cloud record the data generators return, and the procedural toy
dataset (``data/toy.py`` of the JAX package): a scene of simple geometric
parts whose part id is the segmentation label, deterministic per seed."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ToyCloud:
    V: np.ndarray  # (N, 3) xyz
    C: np.ndarray  # (N, 3) rgb
    I: np.ndarray  # (N, 1) intensity
    L_gt: np.ndarray  # (N, 1) labels
    # stable identity for submission naming (e.g. "08/000123" for KITTI);
    # empty for procedural clouds
    name: str = ""


def make_toy_cloud(n_points: int = 2000, nr_classes: int = 4, seed: int = 0) -> ToyCloud:
    """A scene of ``nr_classes`` displaced gaussian blobs/shells, label = blob id."""
    rng = np.random.default_rng(seed)
    per = n_points // nr_classes
    chunks, labels = [], []
    for c in range(nr_classes):
        center = rng.uniform(-1.0, 1.0, size=3)
        if c % 2 == 0:
            pts = center + rng.normal(scale=0.15, size=(per, 3))
        else:  # thin shell
            u = rng.normal(size=(per, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
            pts = center + u * (0.3 + rng.normal(scale=0.02, size=(per, 1)))
        chunks.append(pts)
        labels.append(np.full((per, 1), c, np.int32))
    rest = n_points - per * nr_classes
    if rest:
        chunks.append(rng.uniform(-1, 1, size=(rest, 3)))
        labels.append(np.zeros((rest, 1), np.int32))
    V = np.concatenate(chunks).astype(np.float32)
    L = np.concatenate(labels)
    perm = rng.permutation(n_points)
    V, L = V[perm], L[perm]
    C = np.clip(V * 0.5 + 0.5, 0, 1).astype(np.float32)
    I = np.linalg.norm(V, axis=1, keepdims=True).astype(np.float32)
    return ToyCloud(V=V, C=C, I=I, L_gt=L)


class ToyDataset:
    """Loader-shaped wrapper over procedural clouds (train/test splits by seed)."""

    nr_classes = 4
    ignore_index = -1

    def __init__(self, mode: str = "train", nr_samples: int = 20, n_points: int = 2000,
                 do_overfit: bool = False, seed: int = 0):  # fmt: skip
        self.mode = mode
        self.nr_samples = 1 if do_overfit else nr_samples
        self.n_points = n_points
        self.do_overfit = do_overfit
        self.base_seed = seed + (0 if mode == "train" else 10_000)

    def __len__(self):
        return self.nr_samples

    def get_cloud(self, idx: int) -> ToyCloud:
        if self.do_overfit:
            idx = 0
        return make_toy_cloud(self.n_points, self.nr_classes, seed=self.base_seed + idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_cloud(i)
