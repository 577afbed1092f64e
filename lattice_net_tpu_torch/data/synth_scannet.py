"""Procedural ScanNet-v2 stand-in written in the real on-disk formats, a copy
of ``lattice_net_tpu/data/synth_scannet.py`` (byte-equal files).

Procedural rooms (``misc/scannet_scale_probe.make_indoor_scene``) are
written in the ScanNet layout: ``scans/<scene>/<scene>.npz`` for the train
split and ``scans_test/<scene>/<scene>_vh_clean_2.labels.ply`` (binary
little-endian, a ``label`` ushort vertex property) for the test split, so
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
    from lattice_net_tpu_torch.misc.scannet_scale_probe import make_indoor_scene

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
