"""Procedural LiDAR-like street scenes (SemanticKITTI stand-in).

A copy of ``make_scene``, ``make_scene20`` and ``SynthKitti`` of
``lattice_net_tpu/data/synth_kitti.py``: a rotating-scanner sampling pattern
(rings, 1/r^2 density falloff, range-dependent noise) over a ground plane,
buildings, poles, vegetation, vehicles and fences, labelled into 6 classes,
or into the 19+1 SemanticKITTI train ids with the benchmark's imbalance.
A 131k-point scan at sigma 0.6 splats some 20-30k level-0 lattice vertices.
Deterministic per seed.  ``write_kitti_dir`` writes such scans in the
real SemanticKITTI layout, for ``data/semantic_kitti.py`` to read.
"""

from __future__ import annotations

import os

import numpy as np

from lattice_net_tpu_torch.data.toy import ToyCloud

CLASS_NAMES = ["ground", "building", "pole", "vegetation", "vehicle", "fence"]
NR_CLASSES = len(CLASS_NAMES)


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


def make_scene(n_points: int = 131072, seed: int = 0, max_range: float = 50.0) -> ToyCloud:
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

    return ToyCloud(
        V=V.astype(np.float32),
        C=np.zeros((n_points, 3), np.float32),
        I=intensity.astype(np.float32),
        L_gt=label.reshape(-1, 1).astype(np.int32),
        name=f"{seed:06d}",
    )


# ---------------------------------------------------------------------------
# full 19+1-class scenes (benchmark label cardinality, realistic imbalance)
# ---------------------------------------------------------------------------

# SemanticKITTI train-id order (data/semantic_kitti.py CLASS_NAMES)
KITTI20_CLASS_NAMES = [
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]


def make_scene20(n_points: int = 131072, seed: int = 0, max_range: float = 50.0) -> ToyCloud:
    """Procedural scene labelled with all 19+1 SemanticKITTI train ids.

    Same scanner model as ``make_scene`` but with the real benchmark's label
    cardinality and imbalance shape: dominant surfaces (road/terrain/
    sidewalk/vegetation/building) in the tens of percent, thing classes at
    ~0.1-5%, and the rare movers (person/bicyclist/motorcyclist/traffic-
    sign) well below 0.1%.  Class 0 ("unlabeled") is sparse outlier noise
    and is the loss/IoU ignore index, as in the real dataset.
    """
    rng = np.random.default_rng(seed ^ 0x5EED20)
    az, r = _scanner_sample(rng, n_points, max_range)
    x, y = r * np.cos(az), r * np.sin(az)
    z = np.full(n_points, -1.6)
    z += 0.3 * np.sin(x * 0.05) * np.cos(y * 0.04) + rng.normal(0, 0.02, n_points)
    label = np.full(n_points, 17, np.int64)  # default ground = terrain

    def claim(mask, new_z, cls):
        z[mask] = new_z[mask] if isinstance(new_z, np.ndarray) else new_z
        label[mask] = cls

    # --- flat ground carving (no z change) --------------------------------
    road_half = rng.uniform(3.5, 5.0)
    label[np.abs(y) < road_half] = 9  # road
    side = (np.abs(y) >= road_half) & (np.abs(y) < road_half + 2.2)
    label[side] = 11  # sidewalk
    for _ in range(rng.integers(1, 4)):  # parking bays beside the road
        cx = rng.uniform(-35, 35)
        sgn = rng.choice([-1, 1])
        pk = (np.abs(x - cx) < rng.uniform(5, 12)) & (
            (y * sgn > road_half) & (y * sgn < road_half + rng.uniform(3, 5))
        )
        label[pk] = 10  # parking
    for _ in range(rng.integers(1, 3)):  # other-ground: rare patches
        cx, cy = rng.uniform(-30, 30), rng.choice([-1, 1]) * rng.uniform(8, 14)
        og = (x - cx) ** 2 + (y - cy) ** 2 < rng.uniform(1.5, 2.5) ** 2
        label[og & (label == 17)] = 12

    # --- structures --------------------------------------------------------
    for _ in range(rng.integers(6, 12)):  # buildings
        cx = rng.uniform(-45, 45)
        cy = rng.choice([-1, 1]) * rng.uniform(10, 40)
        w, d, h = rng.uniform(6, 18), rng.uniform(6, 18), rng.uniform(4, 14)
        near = (np.abs(x - cx) < w / 2) & (np.abs(y - cy) < d / 2)
        claim(near & (rng.random(n_points) < 0.85), -1.6 + np.mod(r * 7.3, 1.0) * h, 13)

    for _ in range(rng.integers(2, 6)):  # fences
        cy = rng.choice([-1, 1]) * rng.uniform(6.5, 20)
        x0, x1 = sorted(rng.uniform(-45, 45, 2))
        near = (x > x0) & (x < x1) & (np.abs(y - cy) < 0.15)
        claim(near, -1.6 + np.mod(r * 9.1, 1.0) * 1.2, 14)

    for _ in range(rng.integers(25, 45)):  # vegetation canopies + trunks
        cx, cy = rng.uniform(-45, 45), rng.choice([-1, 1]) * rng.uniform(7, 35)
        rad = rng.uniform(2.0, 6.0)
        cz = rng.uniform(1.2, 3.0)
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        near = d2 < rad**2
        lift = cz + np.sqrt(np.maximum(rad**2 - d2, 0)) * rng.uniform(0.4, 1.0)
        claim(near & (rng.random(n_points) < 0.65), -1.6 + lift + rng.normal(0, 0.15, n_points), 15)
        trunk = d2 < rng.uniform(0.22, 0.35) ** 2
        claim(trunk, -1.6 + np.mod(r * 13.1, 1.0) * cz, 16)  # trunk below canopy

    sign_poles = []
    for _ in range(rng.integers(14, 24)):  # poles, some carrying signs
        cx, cy = rng.uniform(-35, 35), rng.choice([-1, 1]) * rng.uniform(5.5, 8.5)
        h = rng.uniform(3, 7)
        near = (x - cx) ** 2 + (y - cy) ** 2 < rng.uniform(0.22, 0.35) ** 2
        claim(near, -1.6 + np.mod(r * 11.7, 1.0) * h, 18)
        if rng.random() < 0.4:
            sign_poles.append((cx, cy, h))
    for cx, cy, h in sign_poles:  # traffic signs: small plates at pole top
        near = (np.abs(x - cx) < 0.45) & (np.abs(y - cy) < 0.45)
        pick = near & (rng.random(n_points) < 0.35)
        claim(pick, -1.6 + h + rng.uniform(-0.3, 0.3), 19)

    # --- vehicles (on road / parking) --------------------------------------
    for _ in range(rng.integers(4, 9)):  # cars
        cx, cy = rng.uniform(-40, 40), rng.uniform(-road_half + 1, road_half + 3)
        near = (np.abs(x - cx) < 2.2) & (np.abs(y - cy) < 1.0)
        claim(near, -1.6 + np.mod(r * 5.1, 1.0) * 1.5, 1)
    for _ in range(rng.integers(0, 3)):  # trucks: longer, taller, rarer
        cx, cy = rng.uniform(-40, 40), rng.choice([-1, 1]) * rng.uniform(0, road_half - 1)
        near = (np.abs(x - cx) < 4.5) & (np.abs(y - cy) < 1.3)
        claim(near, -1.6 + np.mod(r * 4.3, 1.0) * 3.0, 4)
    for _ in range(rng.integers(0, 3)):  # other-vehicle
        cx, cy = rng.uniform(-40, 40), rng.choice([-1, 1]) * rng.uniform(0, road_half + 2)
        near = (np.abs(x - cx) < 2.8) & (np.abs(y - cy) < 1.2)
        claim(near, -1.6 + np.mod(r * 6.7, 1.0) * 2.2, 5)

    # --- rare movers & small things (each well under 0.1%) -----------------
    def small_box(cls, n_lo, n_hi, hw, hd, hh, y_lo, y_hi, r_max=22.0):
        for _ in range(rng.integers(n_lo, n_hi)):
            ang = rng.uniform(0, 2 * np.pi)
            rr = rng.uniform(4, r_max)  # near the sensor: rare but present
            cx, cy = rr * np.cos(ang), np.clip(rr * np.sin(ang), -y_hi, y_hi)
            if abs(cy) < y_lo:
                cy = np.sign(cy or 1) * y_lo
            near = (np.abs(x - cx) < hw) & (np.abs(y - cy) < hd)
            claim(near, -1.6 + np.mod(r * 8.9, 1.0) * hh, cls)

    small_box(2, 1, 4, 0.45, 0.2, 1.1, road_half, road_half + 2)   # bicycle (parked)
    small_box(3, 1, 3, 0.6, 0.25, 1.2, road_half, road_half + 2)   # motorcycle
    small_box(6, 2, 6, 0.28, 0.28, 1.8, road_half, road_half + 2)  # person
    small_box(7, 1, 3, 0.5, 0.25, 1.7, 1.0, road_half)             # bicyclist (on road)
    small_box(8, 0, 2, 0.6, 0.3, 1.6, 1.0, road_half)              # motorcyclist

    # --- unlabeled: sparse outlier returns (ignore index) -------------------
    out = rng.random(n_points) < 0.004
    z[out] = rng.uniform(-1.6, 6.0, n_points)[out]
    label[out] = 0

    sigma_noise = 0.01 + 0.0006 * r
    V = np.stack([x, y, z], axis=1) + rng.normal(0, sigma_noise[:, None], (n_points, 3))
    intensity = (0.2 + 0.8 * rng.random(n_points))[:, None]
    return ToyCloud(
        V=V.astype(np.float32),
        C=np.zeros((n_points, 3), np.float32),
        I=intensity.astype(np.float32),
        L_gt=label.reshape(-1, 1).astype(np.int32),
        name=f"{seed:06d}",
    )


class SynthKitti:
    """Loader-shaped dataset of procedural scenes (train/val by seed range)."""

    nr_classes = NR_CLASSES
    ignore_index = -1

    def __init__(
        self,
        mode: str = "train",
        nr_samples: int = 40,
        n_points: int = 131072,
        max_range: float = 50.0,
        do_overfit: bool = False,
        seed: int = 0,
        classes: int = 6,
        transform=None,
    ):
        if classes not in (6, 20):
            raise ValueError(f"classes must be 6 or 20, got {classes}")
        # geometric augmentation (the config's ``transformer`` block)
        self.transform = transform
        self.mode = mode
        self.nr_samples = 1 if do_overfit else nr_samples
        self.n_points = n_points
        self.max_range = max_range
        self.do_overfit = do_overfit
        self.base_seed = seed + (0 if mode == "train" else 100_000)
        self.rng = np.random.default_rng(seed + 7)
        self.classes = classes
        # procedural generation takes about 1.5 s a scene on one core, far
        # above a train step, so base scenes are cached in RAM after the
        # first epoch (~4 MB/scene); augmentation still re-rolls per access
        # (apply_transform_full copies, never mutates, its inputs)
        self._cache: dict[int, ToyCloud] = {}
        self.nr_classes = classes
        # 20-class scenes use the real dataset's ignore semantics (train id 0)
        self.ignore_index = 0 if classes == 20 else -1
        # every scene is EXACTLY n_points: batches built at this budget carry
        # all-true point masks, so the trainer may build mask-free
        # (make_loss_fn's full_mask)
        self.fixed_n_points = (
            None
            if transform is not None and transform.random_subsample_percentage > 0
            else n_points
        )

    def __len__(self):
        return self.nr_samples

    def _disk_cache_path(self, idx: int):
        root = os.environ.get("LNT_SCENE_CACHE", "")
        if not root:
            return None
        return os.path.join(
            root,
            f"synthkitti_c{self.classes}_n{self.n_points}_"
            f"r{self.max_range:g}_s{self.base_seed + idx}.npz",
        )

    def get_cloud(self, idx: int) -> ToyCloud:
        if self.do_overfit:
            idx = 0
        cloud = self._cache.get(idx)
        if cloud is None:
            # cross-process disk cache (LNT_SCENE_CACHE=dir): a later run,
            # or a pre-warm pass on the host, skips the synthesis
            path = self._disk_cache_path(idx)
            if path is not None and os.path.exists(path):
                with np.load(path) as z:
                    cloud = ToyCloud(z["V"], z["C"], z["I"], z["L_gt"])
            else:
                gen = make_scene20 if self.classes == 20 else make_scene
                cloud = gen(
                    self.n_points, seed=self.base_seed + idx, max_range=self.max_range
                )
                if path is not None:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    tmp = f"{path}.tmp{os.getpid()}.npz"
                    np.savez(tmp, V=cloud.V, C=cloud.C, I=cloud.I, L_gt=cloud.L_gt)
                    os.replace(tmp, path)
            self._cache[idx] = cloud
        if self.transform is not None and self.mode == "train":
            from lattice_net_tpu_torch.data.transforms import apply_transform_cloud

            cloud = apply_transform_cloud(cloud, self.transform, self.rng)
        return cloud

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_cloud(i)

    def label_names(self):
        return KITTI20_CLASS_NAMES if self.classes == 20 else CLASS_NAMES


# synth class -> SemanticKITTI train id (data/semantic_kitti.py CLASS_NAMES):
# ground->road, building->building, pole->pole, vegetation->vegetation,
# vehicle->car, fence->fence
_SYNTH_TO_KITTI_TRAIN = {0: 9, 1: 13, 2: 18, 3: 15, 4: 1, 5: 14}


def write_kitti_dir(
    root,
    nr_train: int = 10,
    nr_test: int = 4,
    n_points: int = 131072,
    seed: int = 0,
    classes: int = 6,
):
    """Write procedural scans in the real SemanticKITTI layout
    (``sequences/<seq>/velodyne/*.bin`` float32 xyzi and ``labels/*.label``
    uint32 raw ids), byte for byte the JAX package's files for the same
    arguments.  Train scans go to sequence 00, test scans to sequence 11
    (with labels, which the real test split withholds).  Returns ``root``."""
    from pathlib import Path

    from lattice_net_tpu_torch.data.semantic_kitti import LEARNING_MAP_INV

    root = Path(root)
    rng = np.random.default_rng(seed + 777)
    for i in range(nr_train + nr_test):
        seq = "00" if i < nr_train else "11"
        scan = f"{i:06d}"
        gen = make_scene20 if classes == 20 else make_scene
        cloud = gen(n_points, seed=seed + i)
        xyzi = np.concatenate(
            [cloud.V.astype(np.float32), rng.uniform(0, 1, (len(cloud.V), 1)).astype(np.float32)],
            axis=1,
        )
        if classes == 20:  # the labels are train ids already
            train_ids = cloud.L_gt.reshape(-1)
        else:
            train_ids = np.vectorize(_SYNTH_TO_KITTI_TRAIN.get)(cloud.L_gt.reshape(-1))
        raw = np.vectorize(LEARNING_MAP_INV.get)(train_ids).astype(np.uint32)
        d = root / "sequences" / seq
        (d / "velodyne").mkdir(parents=True, exist_ok=True)
        (d / "labels").mkdir(parents=True, exist_ok=True)
        xyzi.tofile(d / "velodyne" / f"{scan}.bin")
        raw.tofile(d / "labels" / f"{scan}.label")
    return root
