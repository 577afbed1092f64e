"""Procedural ShapeNet-part-seg stand-in written in the benchmark's on-disk
format, a copy of ``lattice_net_tpu/data/synth_shapenet.py`` (byte-equal
files for the same arguments).

Procedural motorbikes, six labelled parts as the benchmark's motorbike has
(``data/shapenet.NR_PARTS``), are written as
``<root>/03790512/points/*.pts``, ``points_label/*.seg`` and
``train_test_split/shuffled_{train,test,val}_file_list.json``, so
``ln_train config/ln_train_shapenet_example.cfg`` runs unmodified on a
generated directory, through the native ``.pts``/``.seg`` reader, with no
download.

    python -m lattice_net_tpu_torch.data.synth_shapenet <out_dir> [--nr-train 16]
        [--nr-test 8] [--n-points 2500] [--seed 0]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MOTORBIKE_SYNSET = "03790512"

# part labels (1-indexed, 0 = unlabeled like the benchmark .seg files)
WHEEL, FRAME, HANDLE, SEAT, TANK, EXHAUST = 1, 2, 3, 4, 5, 6


def _ring(rng, n, center, radius, tube, axis_jitter=0.05):
    """Points on a torus ring in the x-y plane (a wheel)."""
    t = rng.uniform(0, 2 * np.pi, n)
    r = radius + rng.normal(0, tube, n)
    x = center[0] + r * np.cos(t)
    y = center[1] + r * np.sin(t)
    z = center[2] + rng.normal(0, axis_jitter, n)
    return np.stack([x, y, z], 1)


def _tube(rng, n, a, b, thickness):
    """Points along the segment a->b with gaussian cross-section."""
    t = rng.uniform(0, 1, n)[:, None]
    p = np.asarray(a)[None] * (1 - t) + np.asarray(b)[None] * t
    return p + rng.normal(0, thickness, (n, 3))


def _blob(rng, n, center, scales):
    return np.asarray(center)[None] + rng.normal(0, 1, (n, 3)) * np.asarray(scales)[None]


def make_motorbike(n_points: int = 2500, seed: int = 0):
    """One procedural motorbike: (V (n,3) float32 in ~[-1,1], L (n,1) int32).

    Geometry is randomized per seed (wheel radius, wheelbase, seat/tank
    placement) so a dataset of these has real shape variety; part proportions
    roughly follow the benchmark's motorbikes (wheels + frame dominate).
    """
    if n_points < 64:
        raise ValueError(
            f"n_points={n_points} too small: the six part floors (8 points "
            "each, plus tube splits) need >= 64 points"
        )
    rng = np.random.default_rng(seed)
    wheel_r = rng.uniform(0.24, 0.32)
    base = rng.uniform(0.55, 0.7)  # half wheelbase
    ground = -0.45
    frac = {WHEEL: 0.34, FRAME: 0.3, HANDLE: 0.1, SEAT: 0.1, TANK: 0.09, EXHAUST: 0.07}
    counts = {k: max(8, int(v * n_points)) for k, v in frac.items()}
    counts[WHEEL] += n_points - sum(counts.values())  # exact total

    front = np.array([base, ground + wheel_r, 0.0])
    rear = np.array([-base, ground + wheel_r, 0.0])
    head = np.array([base * 0.7, 0.3, 0.0])
    seat_c = np.array([-base * 0.45, 0.18, 0.0])
    tank_c = np.array([base * 0.1, 0.16, 0.0])

    nw = counts[WHEEL]
    wheels = np.concatenate(
        [_ring(rng, nw // 2, front, wheel_r, 0.02), _ring(rng, nw - nw // 2, rear, wheel_r, 0.02)]
    )
    nf = counts[FRAME]
    frame = np.concatenate(
        [
            _tube(rng, nf // 3, rear, tank_c, 0.02),
            _tube(rng, nf // 3, front, head, 0.02),
            _tube(rng, nf - 2 * (nf // 3), tank_c, head, 0.02),
        ]
    )
    handle = _tube(
        rng, counts[HANDLE], head + [0, 0.05, -0.22], head + [0, 0.05, 0.22], 0.015
    )
    seat = _blob(rng, counts[SEAT], seat_c, [0.14, 0.03, 0.05])
    tank = _blob(rng, counts[TANK], tank_c, [0.1, 0.05, 0.05])
    exhaust = _tube(
        rng, counts[EXHAUST], rear + [0.05, -0.05, 0.08], rear + [0.45, 0.0, 0.1], 0.015
    )

    V = np.concatenate([wheels, frame, handle, seat, tank, exhaust]).astype(np.float32)
    L = np.concatenate(
        [
            np.full(len(wheels), WHEEL),
            np.full(len(frame), FRAME),
            np.full(len(handle), HANDLE),
            np.full(len(seat), SEAT),
            np.full(len(tank), TANK),
            np.full(len(exhaust), EXHAUST),
        ]
    ).astype(np.int32)[:, None]
    perm = rng.permutation(len(V))
    return V[perm], L[perm]


def write_benchmark_dir(
    root, nr_train: int = 16, nr_test: int = 8, n_points: int = 2500, seed: int = 0
) -> Path:
    """Write a benchmark-layout directory of procedural motorbikes.

    Produces ``<root>/03790512/points/*.pts``, ``points_label/*.seg`` and
    ``train_test_split/shuffled_{train,test,val}_file_list.json`` exactly as
    ``shapenetcore_partanno_segmentation_benchmark_v0`` lays them out."""
    root = Path(root)
    cat = root / MOTORBIKE_SYNSET
    (cat / "points").mkdir(parents=True, exist_ok=True)
    (cat / "points_label").mkdir(parents=True, exist_ok=True)
    (root / "train_test_split").mkdir(parents=True, exist_ok=True)

    splits = {"train": [], "test": [], "val": []}
    for i in range(nr_train + nr_test):
        name = f"synth{i:04d}"
        V, L = make_motorbike(n_points, seed=seed + i)
        np.savetxt(cat / "points" / f"{name}.pts", V, fmt="%.6f")
        np.savetxt(cat / "points_label" / f"{name}.seg", L, fmt="%d")
        splits["train" if i < nr_train else "test"].append(
            f"shape_data/{MOTORBIKE_SYNSET}/{name}"
        )
    splits["val"] = splits["test"][: max(1, nr_test // 2)]
    for mode, entries in splits.items():
        (root / "train_test_split" / f"shuffled_{mode}_file_list.json").write_text(
            json.dumps(entries)
        )
    return root


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--nr-train", type=int, default=16)
    ap.add_argument("--nr-test", type=int, default=8)
    ap.add_argument("--n-points", type=int, default=2500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = write_benchmark_dir(
        args.out_dir, args.nr_train, args.nr_test, args.n_points, args.seed
    )
    print(f"wrote {args.nr_train}+{args.nr_test} procedural motorbikes under {root}")


if __name__ == "__main__":
    main()
