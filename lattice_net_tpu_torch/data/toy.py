"""The cloud record the data generators return (``data/toy.py`` of the JAX package)."""

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
