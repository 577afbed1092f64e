"""ScanNet v2 semantic-segmentation reader, a copy of
``lattice_net_tpu/data/scannet.py``.

Each scene is read from the preprocessed ``<scene>.npz`` (keys points,
colors, labels) or from its ``_vh_clean_2.labels.ply`` mesh (binary
little-endian, a ``label`` vertex property); raw NYU40 ids map to the 20
benchmark classes plus 0 = unannotated.  A cloud over
``max_nr_points_per_cloud`` points is subsampled (a draw of ``self.rng``),
then augmented in train mode (positions and colours), with the same
generator draws as the JAX package.

The split directory is ``scans_test`` for ``mode == "test"`` and ``scans``
for every other mode, as in the JAX package: the trainer's held-out phase,
which asks for ``"val"``, reads the train scenes (ROADMAP §3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.toy import ToyCloud

# the 20 benchmark classes (NYU40 ids) + 0 = unannotated
VALID_CLASS_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
CLASS_NAMES = [
    "unannotated", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub", "otherfurniture",
]  # fmt: skip
NR_CLASSES = 21


def _nyu40_lut() -> np.ndarray:
    lut = np.zeros(41, np.int32)
    for train_id, nyu in enumerate(VALID_CLASS_IDS, start=1):
        lut[nyu] = train_id
    return lut


_LUT = _nyu40_lut()


def read_ply_xyz_rgb_label(path):
    """(V, C, L) of a binary little-endian PLY's vertices: f32 positions,
    colours in [0, 1] (zeros without colour properties), int64 labels
    (zeros without a ``label`` property)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        n_verts = 0
        props = []
        fmt = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n_verts = int(line.split()[-1])
            elif line.startswith(b"property") and n_verts and not props_done(props, line):
                props.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        if fmt != b"binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt}")
        type_map = {"x": "f4", "y": "f4", "z": "f4", "red": "u1", "green": "u1",
                    "blue": "u1", "alpha": "u1", "label": "u2"}  # fmt: skip
        dtype = np.dtype([(p, type_map.get(p, "f4")) for p in props])
        data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype, count=n_verts)
    V = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    C = (
        np.stack([data["red"], data["green"], data["blue"]], 1).astype(np.float32) / 255.0
        if "red" in props
        else np.zeros_like(V)
    )
    L = data["label"].astype(np.int64) if "label" in props else np.zeros(len(V), np.int64)
    return V, C, L


def props_done(props, line):
    """Whether ``line`` is a face property (``property list``): vertex
    properties come first, and reading stops after the vertices."""
    return b"list" in line


class ScanNet:
    nr_classes = NR_CLASSES
    ignore_index = 0

    def __init__(
        self,
        dataset_path: str,
        mode: str = "train",
        max_nr_points_per_cloud: int = 400000,
        shuffle: bool = True,
        do_overfit: bool = False,
        seed: int = 0,
        transform=None,
    ):
        self.root = Path(dataset_path)
        self.mode = mode
        self.transform = transform  # train only
        self.max_points = max_nr_points_per_cloud
        self.shuffle = shuffle
        self.do_overfit = do_overfit
        self.rng = np.random.default_rng(seed)
        scan_dir = self.root / ("scans_test" if mode == "test" else "scans")
        self.scenes = []
        if scan_dir.exists():
            for scene in sorted(scan_dir.iterdir()):
                npz = scene / f"{scene.name}.npz"
                ply = scene / f"{scene.name}_vh_clean_2.labels.ply"
                raw_ply = scene / f"{scene.name}_vh_clean_2.ply"
                if npz.exists():
                    self.scenes.append(npz)
                elif ply.exists():
                    self.scenes.append(ply)
                elif raw_ply.exists():
                    self.scenes.append(raw_ply)
        if not self.scenes:
            raise FileNotFoundError(f"no ScanNet scenes under {scan_dir}")

    def __len__(self):
        return 1 if self.do_overfit else len(self.scenes)

    def get_cloud(self, idx: int) -> ToyCloud:
        if self.do_overfit:
            idx = 0
        path = self.scenes[idx]
        if path.suffix == ".npz":
            z = np.load(path)
            V = z["points"].astype(np.float32)
            C = z.get("colors", np.zeros_like(V)).astype(np.float32)
            raw = z.get("labels", np.zeros(len(V), np.int64))
        else:
            V, C, raw = read_ply_xyz_rgb_label(path)
        L = _LUT[np.clip(raw, 0, 40)].reshape(-1, 1)
        # max_points <= 0 means uncapped: the eval config sets -1 so that a
        # submission labels every raw point
        if self.max_points > 0 and len(V) > self.max_points:
            sel = self.rng.choice(len(V), self.max_points, replace=False)
            V, C, L = V[sel], C[sel], L[sel]
        if self.transform is not None and self.mode == "train":
            from lattice_net_tpu_torch.data.transforms import apply_transform_full

            V, L, C, _ = apply_transform_full(V, L, self.transform, self.rng, colors=C)
        scene_name = path.stem.split("_vh_clean")[0]
        return ToyCloud(V=V, C=C, I=np.zeros((len(V), 1), np.float32), L_gt=L, name=scene_name)

    def __iter__(self):
        order = np.arange(len(self))
        if self.shuffle and not self.do_overfit:
            self.rng.shuffle(order)
        for i in order:
            yield self.get_cloud(int(i))


def write_scannet_prediction(path, nyu40_ids: np.ndarray) -> None:
    """The benchmark server's format: one NYU40 id per line, from train ids
    (0 = unannotated writes 0)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    inv = np.zeros(NR_CLASSES, np.int32)
    for train_id, nyu in enumerate(VALID_CLASS_IDS, start=1):
        inv[train_id] = nyu
    np.savetxt(path, inv[np.clip(nyu40_ids, 0, NR_CLASSES - 1)], fmt="%d")
