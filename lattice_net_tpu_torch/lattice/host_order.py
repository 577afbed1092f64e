"""The canonical point order on the host, in numpy.

A twin of :func:`lattice.structure.canonical_point_order` for the data
path: the trainer's loader thread reorders each cloud while the card runs
the previous step, so the step's build takes the corner-dedup fast path
(``build_hierarchy(..., canonical_points=True)``) at no cost on the card.
The arithmetic is the device order's (the same elevation, rem0 and rank)
in float32 numpy, whose product may round a borderline point differently
from the card's; that splits a simplex run, which the fast build handles
(it is right in any order), and never changes a result.
"""

from __future__ import annotations

import numpy as np

from .permutohedral import _elevation_matrix_np

__all__ = ["canonical_point_order_np"]


def canonical_point_order_np(positions: np.ndarray, sigma) -> np.ndarray:
    """(N,) int32 permutation sorting points by (level-0 simplex rem0,
    lexicographic; then the rank, entry d most significant), stable."""
    p = np.asarray(positions, np.float32)
    n, d = p.shape
    d1 = d + 1
    sig = np.broadcast_to(np.asarray(sigma, np.float32), (d,))
    elev = (p / sig) @ _elevation_matrix_np(d).astype(np.float32).T

    v = elev / d1
    up = np.ceil(v) * d1
    down = np.floor(v) * d1
    rem0 = np.where(up - elev < elev - down, up, down).astype(np.int32)
    s = rem0.sum(-1) // d1

    diff = elev - rem0
    di, dj = diff[:, :, None], diff[:, None, :]
    iu = np.triu(np.ones((d1, d1), bool), 1)
    il = np.tril(np.ones((d1, d1), bool), -1)
    rank = (((di < dj) & iu).sum(-1) + ((dj >= di) & il).sum(-1)).astype(np.int32)
    rank = rank + s[:, None]
    too_low, too_high = rank < 0, rank > d
    rank = np.where(too_low, rank + d1, np.where(too_high, rank - d1, rank))
    rem0 = np.where(too_low, rem0 + d1, np.where(too_high, rem0 - d1, rem0))

    # np.lexsort's last key is the primary one
    keys = tuple(rank[:, i] for i in range(d1)) + tuple(rem0[:, i] for i in range(d - 1, -1, -1))
    return np.lexsort(keys).astype(np.int32)
