"""ShapeNet part-segmentation reader (shapenetcore_partanno_segmentation_benchmark_v0),
a copy of ``lattice_net_tpu/data/shapenet.py``.

Dataset layout: ``<root>/<synset>/points/*.pts`` + ``points_label/*.seg``
with per-category train/val/test splits in
``train_test_split/shuffled_<mode>_file_list.json`` (a sorted glob of the
category's ``.pts`` files where the split file is missing).  Part labels
are 1-indexed; 0 is unlabeled.

The generator draws are the JAX package's, call for call: the native
reader's seed (``int(self.rng.integers(1 << 31))``), the shuffle of the
Python path, and the train-mode transform of each cloud, so both packages
hand the trainer the same clouds from the same seed.  Clouds read by index
(``get_cloud``) carry their file stem as ``name``; the native reader's do
not (ROADMAP §3).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.toy import ToyCloud
from lattice_net_tpu_torch.data.transforms import TransformParams, apply_transform

# category name -> synset id (the benchmark's synsetoffset2category.txt)
CATEGORIES = {
    "airplane": "02691156",
    "bag": "02773838",
    "cap": "02954340",
    "car": "02958343",
    "chair": "03001627",
    "earphone": "03261776",
    "guitar": "03467517",
    "knife": "03624134",
    "lamp": "03636649",
    "laptop": "03642806",
    "motorbike": "03790512",
    "mug": "03797390",
    "pistol": "03948459",
    "rocket": "04099429",
    "skateboard": "04225987",
    "table": "04379243",
}
NR_PARTS = {
    "airplane": 4, "bag": 2, "cap": 2, "car": 4, "chair": 4, "earphone": 3,
    "guitar": 3, "knife": 2, "lamp": 4, "laptop": 2, "motorbike": 6, "mug": 2,
    "pistol": 3, "rocket": 3, "skateboard": 3, "table": 3,
}  # fmt: skip


class ShapeNetPartSeg:
    """Clouds of one category (``ToyCloud`` records with part labels)."""

    def __init__(
        self,
        dataset_path: str,
        mode: str = "train",
        restrict_to_object: str = "motorbike",
        shuffle: bool = True,
        do_overfit: bool = False,
        normalize: bool = False,
        transform: TransformParams | None = None,
        seed: int = 0,
    ):
        self.root = Path(dataset_path)
        self.mode = mode
        self.category = restrict_to_object
        self.shuffle = shuffle
        self.do_overfit = do_overfit
        self.normalize = normalize
        self.transform = transform  # train only
        self.rng = np.random.default_rng(seed)
        self.files = self._index()
        if not self.files:
            raise FileNotFoundError(f"no ShapeNet samples for {restrict_to_object}/{mode} under {dataset_path}")

    @property
    def nr_classes(self) -> int:
        return NR_PARTS[self.category] + 1  # parts 1..K and 0 = unlabeled

    def label_names(self):
        return ["unlabeled"] + [f"part_{i}" for i in range(1, self.nr_classes)]

    def _index(self):
        synset = CATEGORIES[self.category]
        split_file = self.root / "train_test_split" / f"shuffled_{self.mode}_file_list.json"
        cat_dir = self.root / synset
        out = []
        if split_file.exists():
            for entry in json.loads(split_file.read_text()):  # "shape_data/<synset>/<stem>"
                parts = entry.split("/")
                if parts[-2] != synset:
                    continue
                pts = cat_dir / "points" / f"{parts[-1]}.pts"
                seg = cat_dir / "points_label" / f"{parts[-1]}.seg"
                if pts.exists() and seg.exists():
                    out.append((pts, seg))
        elif cat_dir.exists():
            for pts in sorted((cat_dir / "points").glob("*.pts")):
                seg = cat_dir / "points_label" / (pts.stem + ".seg")
                if seg.exists():
                    out.append((pts, seg))
        return out

    def __len__(self):
        return 1 if self.do_overfit else len(self.files)

    def _postprocess(self, V, L):
        if self.normalize:
            V = V - V.mean(0, keepdims=True)
            V = V / (np.abs(V).max() + 1e-9)
        if self.transform is not None and self.mode == "train":
            V, L = apply_transform(V, L, self.transform, self.rng)
        return V, L

    def get_cloud(self, idx: int) -> ToyCloud:
        if self.do_overfit:
            idx = 0
        pts_f, seg_f = self.files[idx]
        V = np.loadtxt(pts_f, dtype=np.float32).reshape(-1, 3)
        L = np.loadtxt(seg_f, dtype=np.int32).reshape(-1, 1)
        V, L = self._postprocess(V, L)
        return ToyCloud(V=V, C=np.zeros_like(V), I=np.zeros((len(V), 1), np.float32), L_gt=L, name=pts_f.stem)

    def __iter__(self):
        """The clouds of an epoch: through the native reader when it builds
        (threads parse the text files ahead of the consumer, in the order
        they finish, and the clouds carry no name), else ``get_cloud`` in
        index order, shuffled with ``self.rng`` when ``shuffle``.  Prints
        which reader runs."""
        from lattice_net_tpu_torch.data import native_loader as nl

        if not self.do_overfit and nl.native_available():
            print(f"shapenet reader: native ({nl.library_path().name})")
            yield from self._iter_native(nl)
            return
        why = "do_overfit" if self.do_overfit else f"native reader unavailable: {nl.build_error()}"
        print(f"shapenet reader: python ({why})")
        order = np.arange(len(self))
        if self.shuffle and not self.do_overfit:
            self.rng.shuffle(order)
        for i in order:
            yield self.get_cloud(int(i))

    def _iter_native(self, nl):
        loader = nl.NativeCloudLoader(
            [p for p, _ in self.files], [str(s) for _, s in self.files], fmt=nl.FORMAT_SHAPENET_PTS,
            shuffle=self.shuffle, seed=int(self.rng.integers(1 << 31)),
        )  # fmt: skip
        try:
            for xyz, _extra, lab in loader:
                V, L = self._postprocess(xyz.astype(np.float32), lab.reshape(-1, 1).astype(np.int32))
                yield ToyCloud(V=V, C=np.zeros_like(V), I=np.zeros((len(V), 1), np.float32), L_gt=L)
        finally:
            loader.close()
