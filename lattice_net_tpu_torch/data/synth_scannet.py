"""Procedural ScanNet-v2 stand-in written in the real on-disk formats, a copy
of ``lattice_net_tpu/data/synth_scannet.py`` (byte-equal files).

Procedural rooms (:func:`make_indoor_scene`, also the room of the
ScanNet-scale probe and of the profiling tools) are written in the ScanNet
layout: ``scans/<scene>/<scene>.npz`` for the train split and
``scans_test/<scene>/<scene>_vh_clean_2.labels.ply`` (binary little-endian,
a ``label`` ushort vertex property) for the test split, so
both of ``data/scannet.py``'s readers, the NYU40 remap, the trainer and the
eval run with no download.  Unlike the real ``scans_test``, the synthetic
test meshes keep their labels, so held-out metrics exist.

    python -m lattice_net_tpu_torch.data.synth_scannet <out_dir> [--nr-train 6]
        [--nr-test 3] [--n-points 32768] [--seed 0]
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.scannet import VALID_CLASS_IDS

# synthetic part label (make_indoor_scene) -> raw NYU40 id: the ceiling maps
# to NYU 22 ("ceiling", not a benchmark class: unannotated after the remap,
# as in the real dataset); furniture blobs cycle through valid ids
_FURNITURE_NYU = VALID_CLASS_IDS[2:12]  # cabinet..picture


def _synth_to_nyu40(lab: np.ndarray) -> np.ndarray:
    nyu = np.empty_like(lab)
    nyu[lab == 0] = 22  # ceiling -> unannotated after the remap
    nyu[lab == 1] = 1  # wall
    nyu[lab == 2] = 2  # floor
    furn = lab >= 3
    nyu[furn] = np.asarray(_FURNITURE_NYU, lab.dtype)[(lab[furn] - 3) % len(_FURNITURE_NYU)]
    return nyu


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
    return V[sh], C[sh], L[sh]


def write_labels_ply(path, V, C, L) -> None:
    """Binary little-endian PLY with x/y/z f4, red/green/blue/alpha u1 and
    label u2: the ``_vh_clean_2.labels.ply`` vertex layout."""
    n = len(V)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property uchar alpha\nproperty ushort label\n"
        "element face 0\nproperty list uchar int vertex_indices\n"
        "end_header\n"
    )
    dtype = np.dtype(
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
         ("blue", "u1"), ("alpha", "u1"), ("label", "<u2")]
    )  # fmt: skip
    rows = np.empty(n, dtype)
    rows["x"], rows["y"], rows["z"] = V[:, 0], V[:, 1], V[:, 2]
    rgb = np.clip(C * 255.0, 0, 255).astype(np.uint8)
    rows["red"], rows["green"], rows["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    rows["alpha"] = 255
    rows["label"] = L.astype(np.uint16)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rows.tobytes())


def write_scannet_dir(root, nr_train: int = 6, nr_test: int = 3, n_points: int = 32768, seed: int = 0) -> Path:
    """Write procedural rooms in the ScanNet layout, one ``scene{i:04d}_00``
    directory each: train scenes as ``.npz`` (points, colors, labels), test
    scenes as labelled binary PLY meshes; scene i is drawn with seed
    ``seed + i``."""
    root = Path(root)
    for i in range(nr_train + nr_test):
        V, C, L = make_indoor_scene(n_points, seed=seed + i)
        nyu = _synth_to_nyu40(L.astype(np.int64))
        name = f"scene{i:04d}_00"
        if i < nr_train:
            d = root / "scans" / name
            d.mkdir(parents=True, exist_ok=True)
            np.savez(d / f"{name}.npz", points=V, colors=C, labels=nyu)
        else:
            d = root / "scans_test" / name
            write_labels_ply(d / f"{name}_vh_clean_2.labels.ply", V, C, nyu)
    return root


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_dir")
    ap.add_argument("--nr-train", type=int, default=6)
    ap.add_argument("--nr-test", type=int, default=3)
    ap.add_argument("--n-points", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = write_scannet_dir(args.out_dir, args.nr_train, args.nr_test, args.n_points, args.seed)
    print(f"wrote {args.nr_train} npz + {args.nr_test} labels.ply scenes under {root}")


if __name__ == "__main__":
    main()
