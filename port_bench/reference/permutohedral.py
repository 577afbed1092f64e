"""Vectorised permutohedral-lattice math (Adams, Baek, Davis 2010).

Counterpart of ``lattice_net_tpu/lattice/permutohedral.py``: batched tensor
arithmetic over ``(..., pos_dim)`` positions.  Keys must equal the
reference's exactly, so the elevation is written as explicit f32
multiply-adds in a fixed order (no matmul whose precision or summation order
depends on the device, e.g. TF32 on the card).

Glossary (d = pos_dim):
  elevated     point embedded in the hyperplane H_d of R^{d+1} (sums to 0)
  rem0         the nearest "remainder-0" lattice point (all coords = 0 mod d+1)
  rank         per-coordinate rank of (elevated - rem0) in descending order
  barycentric  barycentric coordinates of the point inside its simplex
  keys         the d+1 simplex-vertex lattice coordinates; only the first d
               components are stored (they sum to 0 with the implicit last)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "elevation_matrix",
    "elevate",
    "find_enclosing_simplex",
    "vertex_keys",
    "splat_coords",
    "splat_coords_elevated",
]


@functools.lru_cache(maxsize=None)
def _elevation_matrix_np(pos_dim: int) -> np.ndarray:
    """(d+1, d) matrix E with elevate(p) = E @ p (see the JAX module for the
    derivation from the reference's sequential recurrence)."""
    d = pos_dim
    inv_std_dev = (d + 1) * np.sqrt(2.0 / 3.0)
    scale = inv_std_dev / np.sqrt((np.arange(d) + 1.0) * (np.arange(d) + 2.0))
    e = np.zeros((d + 1, d), dtype=np.float64)
    e[0, :] = 1.0
    for i in range(1, d + 1):
        e[i, i:] = 1.0
        e[i, i - 1] = -float(i)
    return e * scale[None, :]


def elevation_matrix(pos_dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_elevation_matrix_np(pos_dim), dtype=dtype, device=device)


def elevate(positions: torch.Tensor) -> torch.Tensor:
    """Embed ``(..., d)`` positions (already divided by sigma) into H_d.

    ``sum_j p_j * E[:, j]`` accumulated left to right in the input dtype:
    a float32 product on every device, never TF32."""
    d = positions.shape[-1]
    e = elevation_matrix(d, positions.dtype, positions.device)
    out = positions[..., 0:1] * e[:, 0]
    for j in range(1, d):
        out = out + positions[..., j : j + 1] * e[:, j]
    return out


def find_enclosing_simplex(elevated: torch.Tensor):
    """Locate the enclosing simplex of each elevated point.

    Returns ``rem0`` (..., d+1) int32, ``rank`` (..., d+1) int32 and
    ``barycentric`` (..., d+1) float; entry r of the last is the weight of
    the remainder-r simplex vertex.  Same arithmetic, in the same order, as
    the JAX function.
    """
    d1 = elevated.shape[-1]
    d = d1 - 1
    f = elevated.dtype
    dev = elevated.device

    # nearest multiple of (d+1); ties -> floor (the reference's strict '<')
    v = elevated / d1
    up = torch.ceil(v) * d1
    down = torch.floor(v) * d1
    rem0 = torch.where(up - elevated < elevated - down, up, down).to(torch.int32)

    s = torch.div(rem0.sum(-1), d1, rounding_mode="floor")  # (...,)

    # rank[i] = #{j > i : diff_i < diff_j} + #{j < i : diff_j >= diff_i}
    diff = elevated - rem0.to(f)
    di = diff[..., :, None]
    dj = diff[..., None, :]
    iu = torch.ones((d1, d1), dtype=torch.bool, device=dev).triu(1)
    il = torch.ones((d1, d1), dtype=torch.bool, device=dev).tril(-1)
    rank = (((di < dj) & iu).sum(-1) + ((dj >= di) & il).sum(-1)).to(torch.int32)

    # bring points that rounded off the plane back onto it
    rank = rank + s[..., None].to(torch.int32)
    too_low = rank < 0
    too_high = rank > d
    rank = torch.where(too_low, rank + d1, torch.where(too_high, rank - d1, rank))
    rem0 = torch.where(too_low, rem0 + d1, torch.where(too_high, rem0 - d1, rem0))

    # barycentric: b[d - rank_i] += delta_i ; b[d+1 - rank_i] -= delta_i.
    # Each slot receives exactly one delta per sum, so the sums are exact.
    delta = (elevated - rem0.to(f)) / d1
    slots = torch.arange(d1 + 1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    plus = torch.where((d - rank)[..., :, None] == slots, delta[..., :, None], zero)
    minus = torch.where((d1 - rank)[..., :, None] == slots, delta[..., :, None], zero)
    b = plus.sum(-2) - minus.sum(-2)
    b0 = b[..., 0] + 1.0 + b[..., d1]
    barycentric = torch.cat([b0[..., None], b[..., 1:d1]], dim=-1)
    return rem0, rank, barycentric


def vertex_keys(rem0: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """(..., d+1, d) int32 keys of the d+1 simplex vertices (vertex r has
    remainder r): ``key[r, i] = rem0[i] + r - (d+1) * [rank[i] > d - r]``."""
    d1 = rem0.shape[-1]
    d = d1 - 1
    r = torch.arange(d1, dtype=torch.int32, device=rem0.device)
    keys = rem0[..., None, :d] + r[:, None]
    wrap = rank[..., None, :d] > (d - r)[:, None]
    return (keys - wrap.to(torch.int32) * d1).to(torch.int32)


def splat_coords_elevated(elevated: torch.Tensor):
    """splat_coords for points already on H_d (the coarse-level builds)."""
    rem0, rank, bary = find_enclosing_simplex(elevated)
    return vertex_keys(rem0, rank), bary


def splat_coords(positions: torch.Tensor):
    """(..., d) positions divided by sigma -> (keys (..., d+1, d) int32,
    barycentric (..., d+1))."""
    return splat_coords_elevated(elevate(positions))
