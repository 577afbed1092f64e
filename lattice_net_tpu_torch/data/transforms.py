"""Point-cloud augmentation driven by the loaders' ``transformer`` blocks.

A copy of ``lattice_net_tpu/data/transforms.py``: random translation
(full-xyz or ground-plane xz), per-axis mirroring, 90-degree rotations,
axis-angle rotations, stretch, (adaptive) subsampling, xyz noise and HSV
colour jitter over numpy arrays, with the same config keys.  The numpy
generator is drawn in the JAX module's order and count, so one generator
state gives the same augmented cloud bit for bit in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TransformParams:
    random_translation_xyz_magnitude: tuple = (0.0, 0.0, 0.0)
    # ground-plane translation: x/z only, y (up) untouched — the KITTI recipe
    # uses this at magnitude 20 (`lnn_train_semantic_kitti.cfg:112`), ScanNet
    # at 3 (`lnn_train_scannet.cfg:86`)
    random_translation_xz_magnitude: float = 0.0
    rotation_x_max_angle: float = 0.0
    rotation_y_max_angle: float = 0.0
    rotation_z_max_angle: float = 0.0
    random_stretch_xyz_magnitude: tuple = (0.0, 0.0, 0.0)
    random_subsample_percentage: float = 0.0
    # distance-adaptive subsampling (reference key pair, 0/0 = off in every
    # published config): the subsample percentage applies in full at
    # distance <= falloff_start and decays linearly to zero at falloff_end,
    # equalizing the 1/r^2 LiDAR density gradient
    adaptive_subsampling_falloff_start: float = 0.0
    adaptive_subsampling_falloff_end: float = 0.0
    random_mirror_x: bool = False
    random_mirror_y: bool = False
    random_mirror_z: bool = False
    random_rotation_90_degrees_y: bool = False
    # z-up twin of the above (not a reference key; produced by
    # ``for_up_axis("z")`` when translating y-up recipe blocks)
    random_rotation_90_degrees_z: bool = False
    # per-cloud uniform jitter in HSV space: [-h,h] degrees, [-s,s], [-v,v]
    # (`lnn_train_scannet.cfg:97`); applies to the color channels only
    hsv_jitter: tuple = (0.0, 0.0, 0.0)
    chance_of_xyz_noise: float = 0.0
    xyz_noise_stddev: tuple = (0.0, 0.0, 0.0)

    @classmethod
    def from_config(cls, t: dict) -> "TransformParams":
        def tup(key, default=(0.0, 0.0, 0.0)):
            v = t.get(key, list(default))
            if isinstance(v, (int, float)):
                v = [v] * 3
            return tuple(float(x) for x in v)

        return cls(
            random_translation_xyz_magnitude=tup("random_translation_xyz_magnitude"),
            random_translation_xz_magnitude=float(t.get("random_translation_xz_magnitude", 0.0)),
            rotation_x_max_angle=float(t.get("rotation_x_max_angle", 0.0)),
            rotation_y_max_angle=float(t.get("rotation_y_max_angle", 0.0)),
            rotation_z_max_angle=float(t.get("rotation_z_max_angle", 0.0)),
            random_stretch_xyz_magnitude=tup("random_stretch_xyz_magnitude"),
            random_subsample_percentage=float(t.get("random_subsample_percentage", 0.0)),
            adaptive_subsampling_falloff_start=float(
                t.get("adaptive_subsampling_falloff_start", 0.0)
            ),
            adaptive_subsampling_falloff_end=float(
                t.get("adaptive_subsampling_falloff_end", 0.0)
            ),
            random_mirror_x=bool(t.get("random_mirror_x", False)),
            random_mirror_y=bool(t.get("random_mirror_y", False)),
            random_mirror_z=bool(t.get("random_mirror_z", False)),
            random_rotation_90_degrees_y=bool(t.get("random_rotation_90_degrees_y", False)),
            hsv_jitter=tup("hsv_jitter"),
            chance_of_xyz_noise=float(t.get("chance_of_xyz_noise", 0.0)),
            xyz_noise_stddev=tup("xyz_noise_stddev"),
        )

    def is_noop(self) -> bool:
        return self == TransformParams()

    def for_up_axis(self, up: str) -> "TransformParams":
        """Remap a reference recipe block (written for easypbr's y-up clouds)
        onto this repo's z-up loaders (raw KITTI velodyne / ScanNet PLY /
        procedural scenes keep their native frames; the reference's external
        loader rotates everything y-up before its transformer runs).
        ``up="y"`` is the identity; ``up="z"`` swaps the y/z roles so e.g.
        "rotate about y, mirror x/z, translate in the xz ground plane"
        becomes the physically-equivalent "rotate about z, mirror x/y,
        translate in the xy ground plane"."""
        if up == "y":
            return self
        assert up == "z", up

        def swap(t):
            return (t[0], t[2], t[1])

        xz = self.random_translation_xz_magnitude
        trans = list(swap(self.random_translation_xyz_magnitude))
        if xz > 0:  # ground plane for z-up is x/y
            trans[0] = max(trans[0], xz)
            trans[1] = max(trans[1], xz)
        return dataclasses.replace(
            self,
            random_translation_xyz_magnitude=tuple(trans),
            random_translation_xz_magnitude=0.0,
            rotation_y_max_angle=self.rotation_z_max_angle,
            rotation_z_max_angle=self.rotation_y_max_angle,
            random_stretch_xyz_magnitude=swap(self.random_stretch_xyz_magnitude),
            random_mirror_y=self.random_mirror_z,
            random_mirror_z=self.random_mirror_y,
            random_rotation_90_degrees_y=self.random_rotation_90_degrees_z,
            random_rotation_90_degrees_z=self.random_rotation_90_degrees_y,
            xyz_noise_stddev=swap(self.xyz_noise_stddev),
        )


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    r = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB[0,1] -> HSV with H in degrees [0,360)."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    mx = rgb.max(axis=1)
    mn = rgb.min(axis=1)
    d = mx - mn
    safe = np.where(d > 0, d, 1.0)
    h = np.where(
        mx == r, (g - b) / safe % 6.0,
        np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(d > 0, h * 60.0, 0.0)
    s = np.where(mx > 0, d / np.where(mx > 0, mx, 1.0), 0.0)
    return np.stack([h, s, mx], axis=1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[:, 0] / 60.0, hsv[:, 1], hsv[:, 2]
    i = np.floor(h).astype(np.int64) % 6
    f = h - np.floor(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    choices = np.stack(
        [
            np.stack([v, t, p], 1), np.stack([q, v, p], 1), np.stack([p, v, t], 1),
            np.stack([p, q, v], 1), np.stack([t, p, v], 1), np.stack([v, p, q], 1),
        ],
        axis=0,
    )
    return choices[i, np.arange(len(h))]


def _subsample_keep(p: np.ndarray, tp: TransformParams, rng) -> np.ndarray | None:
    """Row-keep indices for (adaptive) random subsampling, or None."""
    pct = tp.random_subsample_percentage
    if pct <= 0.0:
        return None
    start, end = tp.adaptive_subsampling_falloff_start, tp.adaptive_subsampling_falloff_end
    if end > start:
        # drop probability = pct in full inside falloff_start, linear to 0 at
        # falloff_end (near/dense points thinned hardest)
        d = np.linalg.norm(p, axis=1)
        drop_p = pct * np.clip((end - d) / (end - start), 0.0, 1.0)
        keep = rng.random(len(p)) >= drop_p
        if not keep.any():
            keep[rng.integers(0, len(p))] = True
        return np.flatnonzero(keep)
    frac = 1.0 - rng.uniform(0, pct)
    n_keep = max(1, int(len(p) * frac))
    return rng.choice(len(p), n_keep, replace=False)


def apply_transform(positions: np.ndarray, labels: np.ndarray, tp: TransformParams, rng):
    """Augment one cloud; returns (positions, labels) with rows possibly subsampled."""
    p, labels, _, _ = apply_transform_full(positions, labels, tp, rng)
    return p, labels


def apply_transform_full(
    positions: np.ndarray,
    labels: np.ndarray,
    tp: TransformParams,
    rng,
    colors: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
):
    """Augment one cloud incl. color/intensity rows; returns (p, labels, colors, intensity)."""
    p = positions.copy()

    keep = _subsample_keep(p, tp, rng)
    if keep is not None:
        p = p[keep]
        labels = labels[keep]
        colors = colors[keep] if colors is not None else None
        intensity = intensity[keep] if intensity is not None else None

    rot = np.eye(3)
    for axis, max_angle in enumerate(
        (tp.rotation_x_max_angle, tp.rotation_y_max_angle, tp.rotation_z_max_angle)
    ):
        if max_angle > 0:
            rot = rot @ _rot(axis, rng.uniform(-max_angle, max_angle) * np.pi / 180.0)
    if tp.random_rotation_90_degrees_y:
        rot = rot @ _rot(1, rng.integers(0, 4) * np.pi / 2.0)
    if tp.random_rotation_90_degrees_z:
        rot = rot @ _rot(2, rng.integers(0, 4) * np.pi / 2.0)
    if not np.allclose(rot, np.eye(3)):
        p = p @ rot.T

    for axis, on in enumerate((tp.random_mirror_x, tp.random_mirror_y, tp.random_mirror_z)):
        if on and rng.random() < 0.5:
            p[:, axis] = -p[:, axis]

    stretch = np.asarray(tp.random_stretch_xyz_magnitude)
    if (stretch > 0).any():
        p = p * (1.0 + rng.uniform(-stretch, stretch))

    trans = np.asarray(tp.random_translation_xyz_magnitude, np.float64).copy()
    if tp.random_translation_xz_magnitude > 0:
        m = tp.random_translation_xz_magnitude
        trans[0], trans[2] = max(trans[0], m), max(trans[2], m)
    if (trans > 0).any():
        p = p + rng.uniform(-trans, trans)

    if tp.chance_of_xyz_noise > 0 and rng.random() < tp.chance_of_xyz_noise:
        p = p + rng.normal(0.0, np.asarray(tp.xyz_noise_stddev), size=p.shape)

    hj = np.asarray(tp.hsv_jitter)
    if colors is not None and (hj > 0).any():
        hsv = _rgb_to_hsv(np.clip(colors.astype(np.float64), 0.0, 1.0))
        hsv[:, 0] = (hsv[:, 0] + rng.uniform(-hj[0], hj[0])) % 360.0
        hsv[:, 1] = np.clip(hsv[:, 1] + rng.uniform(-hj[1], hj[1]), 0.0, 1.0)
        hsv[:, 2] = np.clip(hsv[:, 2] + rng.uniform(-hj[2], hj[2]), 0.0, 1.0)
        colors = _hsv_to_rgb(hsv).astype(np.float32)

    return p.astype(np.float32), labels, colors, intensity


def apply_transform_cloud(cloud, tp: TransformParams, rng):
    """``apply_transform_full`` over a ``ToyCloud`` (V/C/I/L_gt rows together)."""
    V, L, C, I = apply_transform_full(
        cloud.V, cloud.L_gt, tp, rng, colors=cloud.C, intensity=cloud.I
    )
    return dataclasses.replace(cloud, V=V, L_gt=L, C=C, I=I)
