"""The scene generators the traffic mixes draw their clouds from: frozen
copies of the port's ``data/synth_kitti.make_scene`` (a SemanticKITTI-like
LiDAR sweep) and ``misc/scannet_scale_probe.make_indoor_scene`` (a
ScanNet-like room), the same draws.  Each returns ``{"V": (N, 3) xyz, "C":
(N, 3) rgb, "I": (N, 1) intensity, "L": (N,) int32 labels}``.
"""

from __future__ import annotations

import numpy as np


def _scanner_sample(rng, n, max_range=50.0, nr_beams: int = 64, sensor_height: float = 1.73):
    """Azimuth/beam pattern of a rotating multi-beam scanner.

    Elevation is quantised into ``nr_beams`` discrete angles (like a HDL-64),
    so ground returns fall on concentric RINGS rather than covering the disk
    uniformly — this is what keeps real-KITTI lattice occupancy at ~10-30k
    vertices for sigma 0.6-1.0 instead of saturating the table (the round-1
    bench's mistake).
    """
    az = rng.uniform(0, 2 * np.pi, n)
    beam = rng.integers(0, nr_beams, n)
    # HDL-64-ish: -24.8 deg .. +2 deg
    elev = np.deg2rad(-24.8 + 26.8 * beam / (nr_beams - 1)) + rng.normal(0, 2e-4, n)
    # range of the ground return for down-pointing beams; far cap otherwise
    down = elev < np.deg2rad(-1.0)
    r_ground = np.where(down, sensor_height / np.tan(np.maximum(-elev, 1e-3)), max_range)
    r = np.clip(r_ground + rng.normal(0, 0.02, n), 2.0, max_range)
    return az, r


def make_scene(n_points: int = 131072, seed: int = 0, max_range: float = 50.0) -> dict:
    rng = np.random.default_rng(seed)
    az, r = _scanner_sample(rng, n_points, max_range)
    x, y = r * np.cos(az), r * np.sin(az)
    z = np.full(n_points, -1.6)
    label = np.zeros(n_points, np.int64)  # ground

    # gentle ground undulation + road noise
    z += 0.3 * np.sin(x * 0.05) * np.cos(y * 0.04) + rng.normal(0, 0.02, n_points)

    def claim(mask, new_z, cls):
        z[mask] = new_z[mask] if isinstance(new_z, np.ndarray) else new_z
        label[mask] = cls

    # buildings: boxes along both sides of a road corridor
    for _ in range(rng.integers(6, 12)):
        cx = rng.uniform(-45, 45)
        cy = rng.choice([-1, 1]) * rng.uniform(8, 40)
        w, d, h = rng.uniform(6, 18), rng.uniform(6, 18), rng.uniform(4, 14)
        near = (np.abs(x - cx) < w / 2) & (np.abs(y - cy) < d / 2)
        # points hitting the facade: project onto walls with height profile
        wall = near & (rng.random(n_points) < 0.85)
        claim(wall, -1.6 + np.mod(r * 7.3, 1.0) * h, 1)

    # poles / trunks: thin-ish cylinders (radius large enough that ring
    # sampling still hits them — real scans hit poles via dedicated returns)
    for _ in range(rng.integers(20, 35)):
        cx, cy = rng.uniform(-35, 35), rng.uniform(-35, 35)
        h = rng.uniform(2, 7)
        near = (x - cx) ** 2 + (y - cy) ** 2 < rng.uniform(0.25, 0.5) ** 2
        claim(near, -1.6 + np.mod(r * 11.7, 1.0) * h, 2)

    # vegetation: ellipsoidal canopies
    for _ in range(rng.integers(10, 20)):
        cx, cy = rng.uniform(-45, 45), rng.uniform(-45, 45)
        rad = rng.uniform(1.5, 4.0)
        cz = rng.uniform(0.5, 3.0)
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        near = d2 < rad**2
        lift = cz + np.sqrt(np.maximum(rad**2 - d2, 0)) * rng.uniform(0.4, 1.0)
        claim(near & (rng.random(n_points) < 0.7), -1.6 + lift + rng.normal(0, 0.15, n_points), 3)

    # vehicles: low boxes on the road
    for _ in range(rng.integers(4, 10)):
        cx, cy = rng.uniform(-40, 40), rng.uniform(-6, 6)
        near = (np.abs(x - cx) < 2.2) & (np.abs(y - cy) < 1.0)
        claim(near, -1.6 + np.mod(r * 5.1, 1.0) * 1.5, 4)

    # fences: thin long boxes
    for _ in range(rng.integers(2, 6)):
        cy = rng.choice([-1, 1]) * rng.uniform(5, 20)
        x0, x1 = sorted(rng.uniform(-45, 45, 2))
        near = (x > x0) & (x < x1) & (np.abs(y - cy) < 0.15)
        claim(near, -1.6 + np.mod(r * 9.1, 1.0) * 1.2, 5)

    # range-dependent measurement noise
    sigma_noise = 0.01 + 0.0006 * r
    V = np.stack([x, y, z], axis=1) + rng.normal(0, sigma_noise[:, None], (n_points, 3))
    intensity = (0.2 + 0.8 * rng.random(n_points))[:, None]

    return dict(
        V=V.astype(np.float32),
        C=np.zeros((n_points, 3), np.float32),
        I=intensity.astype(np.float32),
        L=label.astype(np.int32),
    )


def make_indoor_scene(n: int, seed: int = 0):
    """Synthetic room-scale cloud: floor + 4 walls + ceiling + furniture
    blobs, ~8 x 6 x 3 m, RGB by surface type (the JAX package's generator,
    the same draws: ``(V, C, L)`` arrays equal to its)."""
    rng = np.random.default_rng(seed)
    W, D, H = 8.0, 6.0, 3.0
    parts = []
    labels = []
    colors = []

    def plane(count, extent_a, extent_b, fixed_axis, fixed_val, lab, col):
        a = rng.uniform(0, extent_a, count)
        b = rng.uniform(0, extent_b, count)
        f = np.full(count, fixed_val) + rng.normal(0, 0.005, count)
        xyz = np.empty((count, 3), np.float32)
        axes = [i for i in range(3) if i != fixed_axis]
        xyz[:, axes[0]] = a
        xyz[:, axes[1]] = b
        xyz[:, fixed_axis] = f
        parts.append(xyz)
        labels.append(np.full(count, lab, np.int32))
        colors.append(np.tile(np.asarray(col, np.float32), (count, 1)))

    n_floor = n // 4
    n_wall = n // 8
    n_ceil = n // 8
    plane(n_floor, W, D, 2, 0.0, 2, (0.5, 0.4, 0.3))  # floor
    plane(n_ceil, W, D, 2, H, 0, (0.9, 0.9, 0.9))  # ceiling -> unannotated-ish
    plane(n_wall, W, H, 1, 0.0, 1, (0.8, 0.8, 0.7))
    plane(n_wall, W, H, 1, D, 1, (0.8, 0.8, 0.7))
    plane(n_wall, D, H, 0, 0.0, 1, (0.7, 0.8, 0.8))
    plane(n_wall, D, H, 0, W, 1, (0.7, 0.8, 0.8))

    used = sum(len(p) for p in parts)
    n_furn = n - used
    centers = rng.uniform([0.5, 0.5, 0.0], [W - 0.5, D - 0.5, 1.2], (24, 3))
    sizes = rng.uniform(0.2, 0.9, (24, 3))
    per = max(1, n_furn // 24)
    for i, (c, s) in enumerate(zip(centers, sizes)):
        cnt = per if i < 23 else n_furn - 23 * per
        xyz = c + rng.uniform(-0.5, 0.5, (cnt, 3)) * s
        parts.append(xyz.astype(np.float32))
        labels.append(np.full(cnt, 3 + i % 17, np.int32))
        colors.append(np.tile(rng.uniform(0.1, 0.9, 3).astype(np.float32), (cnt, 1)))

    V = np.concatenate(parts)[:n]
    L = np.concatenate(labels)[:n]
    C = np.concatenate(colors)[:n]
    sh = rng.permutation(n)
    return dict(V=V[sh], C=C[sh], I=np.zeros((n, 1), np.float32), L=L[sh])


GENERATORS = {"lidar_sweep": make_scene, "indoor_room": make_indoor_scene}
