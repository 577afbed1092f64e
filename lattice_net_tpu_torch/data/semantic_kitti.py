"""SemanticKITTI reader (velodyne ``.bin`` scans and ``.label`` files), a copy
of ``lattice_net_tpu/data/semantic_kitti.py``.

The dataset layout is ``<root>/sequences/<seq>/velodyne/*.bin`` (float32
x, y, z, intensity) with labels in ``.../labels/*.label`` (uint32, the lower
16 bits the semantic id).  Raw ids map to the 19 train classes plus
unlabeled through the learning map; clouds are capped by distance
(``cap_distance``), then by point count (a draw of ``self.rng``), then
augmented in train mode, with the same generator draws as the JAX package.

``__iter__`` reads through the native threaded reader
(``data/native_loader.py``) when it builds, as the JAX package does; those
clouds come in the order the reader's threads finish them and carry no
``name``.  ``get_cloud`` reads one scan by index and names it
``"<seq>/<scan>"``: the eval CLI reads by index, so each submission file
keeps its scan's identity.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.toy import ToyCloud

TRAIN_SEQUENCES = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VAL_SEQUENCES = ["08"]
TEST_SEQUENCES = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]

# semantic-kitti-api learning map: raw id -> train id (0 = unlabeled/ignored)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6, 31: 7,
    32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0, 60: 9, 70: 15,
    71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7, 254: 6, 255: 8,
    256: 5, 257: 5, 258: 4, 259: 5,
}  # fmt: skip
# train id -> a representative raw id (for submission files)
LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80, 19: 81,
}  # fmt: skip
NR_CLASSES = 20  # 19 + unlabeled
CLASS_NAMES = [
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]  # fmt: skip


def _lut(mapping: dict) -> np.ndarray:
    lut = np.zeros(max(mapping) + 1, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


_LEARNING_LUT = _lut(LEARNING_MAP)


def remap_labels(raw: np.ndarray) -> np.ndarray:
    """Train ids (int32) of raw ``.label`` values (instance bits dropped)."""
    sem = raw & 0xFFFF
    sem = np.clip(sem, 0, len(_LEARNING_LUT) - 1)
    return _LEARNING_LUT[sem].astype(np.int32)


def label_path(scan: Path) -> Path:
    """The ``.label`` file beside a velodyne ``.bin`` scan."""
    return scan.parent.parent / "labels" / (scan.stem + ".label")


class SemanticKitti:
    nr_classes = NR_CLASSES
    ignore_index = 0  # 'unlabeled'

    def __init__(
        self,
        dataset_path: str,
        mode: str = "train",
        cap_distance: float = 60.0,
        max_nr_points_per_cloud: int = 400000,
        shuffle: bool = True,
        do_overfit: bool = False,
        seed: int = 0,
        sequences=None,
        transform=None,
    ):
        self.root = Path(dataset_path)
        self.mode = mode
        # the config's ``transformer`` block: train mode only, after the caps
        self.transform = transform
        self.cap_distance = cap_distance
        self.max_points = max_nr_points_per_cloud
        self.shuffle = shuffle
        self.do_overfit = do_overfit
        self.rng = np.random.default_rng(seed)
        seqs = sequences or {"train": TRAIN_SEQUENCES, "val": VAL_SEQUENCES, "test": TEST_SEQUENCES}[mode]
        self.scans = []
        for seq in seqs:
            for f in sorted((self.root / "sequences" / seq / "velodyne").glob("*.bin")):
                self.scans.append((seq, f))
        if not self.scans:
            raise FileNotFoundError(f"no scans under {dataset_path} for {mode}")

    def __len__(self):
        return 1 if self.do_overfit else len(self.scans)

    def get_cloud(self, idx: int) -> ToyCloud:
        if self.do_overfit:
            idx = 0
        seq, f = self.scans[idx]
        raw = np.fromfile(f, dtype=np.float32).reshape(-1, 4)
        V, I = raw[:, :3], raw[:, 3:4]
        label_f = label_path(f)
        if label_f.exists():
            L = remap_labels(np.fromfile(label_f, dtype=np.uint32)).reshape(-1, 1)
        else:
            L = np.zeros((len(V), 1), np.int32)
        V, I, L = self._postprocess(V, I, L)
        return ToyCloud(
            V=V.astype(np.float32), C=np.zeros_like(V), I=I.astype(np.float32), L_gt=L,
            name=f"{seq}/{f.stem}",
        )  # fmt: skip

    def _postprocess(self, V, I, L):
        if self.cap_distance > 0:
            keep = np.linalg.norm(V, axis=1) < self.cap_distance
            V, I, L = V[keep], I[keep], L[keep]
        if self.max_points > 0 and len(V) > self.max_points:
            sel = self.rng.choice(len(V), self.max_points, replace=False)
            V, I, L = V[sel], I[sel], L[sel]
        if self.transform is not None and self.mode == "train":
            from lattice_net_tpu_torch.data.transforms import apply_transform_full

            V, L, _, I = apply_transform_full(V, L, self.transform, self.rng, intensity=I)
        return V, I, L

    def __iter__(self):
        """The clouds of an epoch: through the native reader when it builds
        (its threads decode scans ahead of the consumer, in the order they
        finish, and the clouds carry no name), else ``get_cloud`` in index
        order, shuffled with ``self.rng`` when ``shuffle``.  Prints which
        reader runs."""
        from lattice_net_tpu_torch.data import native_loader as nl

        if not self.do_overfit and nl.native_available():
            print(f"semantickitti reader: native ({nl.library_path().name})")
            yield from self._iter_native(nl)
            return
        why = "do_overfit" if self.do_overfit else f"native reader unavailable: {nl.build_error()}"
        print(f"semantickitti reader: python ({why})")
        order = np.arange(len(self))
        if self.shuffle and not self.do_overfit:
            self.rng.shuffle(order)
        for i in order:
            yield self.get_cloud(int(i))

    def _iter_native(self, nl):
        files = [f for _, f in self.scans]
        labels = [str(label_path(f)) for f in files]
        if not Path(labels[0]).exists():
            labels = None
        loader = nl.NativeCloudLoader(
            files, labels, fmt=nl.FORMAT_KITTI_BIN, shuffle=self.shuffle,
            seed=int(self.rng.integers(1 << 31)),
        )  # fmt: skip
        try:
            for xyz, intensity, lab in loader:
                # the reader keeps the semantic bits; the learning map applies here
                lab = _LEARNING_LUT[np.clip(lab, 0, len(_LEARNING_LUT) - 1)]
                V, I, L = self._postprocess(
                    xyz, intensity.reshape(-1, 1), lab.reshape(-1, 1).astype(np.int32)
                )
                yield ToyCloud(V=V.astype(np.float32), C=np.zeros_like(V), I=I.astype(np.float32), L_gt=L)
        finally:
            loader.close()


def write_kitti_label_file(path, train_ids: np.ndarray) -> None:
    """A benchmark-server submission file: one uint32 raw label per point."""
    inv = _lut(LEARNING_MAP_INV)
    raw = inv[np.clip(train_ids, 0, len(inv) - 1)].astype(np.uint32)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    raw.tofile(path)
