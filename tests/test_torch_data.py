"""The port's data layer vs the JAX package's, on the CPU.

* ``make_scene20``, ``make_scene`` and ``make_toy_cloud`` bit-equal for 3
  seeds at 4096 points.
* ``TransformParams.from_config(...).for_up_axis(...)`` equal on the
  ``transformer`` block of every config under ``config/`` that has one.
* ``apply_transform_full`` bit-equal from equal generators, with each option
  switched on in turn and all together, and the generators left in the same
  state (the same number of draws).
* ``SynthKitti`` on the synthkitti20 recipe at 4096 points: five successive
  train-mode ``get_cloud`` calls (one generator advancing through them)
  bit-equal, and ``fixed_n_points``, ``ignore_index``, ``nr_classes`` and
  the held-out split; the ``LNT_SCENE_CACHE`` disk cache gives the same
  scene.
* ``compute_class_weights`` within 1e-6 relative, with and without a
  background index; the trainer's ``"auto"`` weights on the synthkitti20
  scout scenes at full size (numpy only) likewise, with the JAX trainer's
  printed line.  The JAX package's printed weights on this host against
  those of the JAX run's log (``docs/runs/synthkitti20_r5.log:43``): the
  per-entry gaps are pinned, and every logged weight is that of a label
  count within a few points of this host's, so the log's scout scenes
  carried a few differently labelled points and its weight arithmetic is
  the same.
* ``check_positions`` raises where JAX raises.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data import synth_kitti as jsk
from lattice_net_tpu.data import toy as jtoy
from lattice_net_tpu.data import transforms as jtr
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import synth_kitti as tsk
from lattice_net_tpu_torch.data import toy as ttoy
from lattice_net_tpu_torch.data import transforms as ttr
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(ROOT.glob("config/*.cfg"))
SYNTH20 = ROOT / "config" / "lnn_train_synthkitti20.cfg"
FIELDS = ("V", "C", "I", "L_gt", "name")


def _assert_clouds_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("gen", ["make_scene20", "make_scene"])
def test_scenes_bit_equal(gen, seed):
    _assert_clouds_equal(getattr(tsk, gen)(4096, seed=seed), getattr(jsk, gen)(4096, seed=seed))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_toy_cloud_bit_equal(seed):
    _assert_clouds_equal(ttoy.make_toy_cloud(4096, 4, seed), jtoy.make_toy_cloud(4096, 4, seed))


def test_toy_dataset_matches():
    for mode in ("train", "val"):
        j, t = jtoy.ToyDataset(mode, 3, 500), ttoy.ToyDataset(mode, 3, 500)
        assert len(j) == len(t) and (j.nr_classes, j.ignore_index) == (t.nr_classes, t.ignore_index)
        for a, b in zip(t, j):
            _assert_clouds_equal(a, b)


def _transformer_blocks():
    out = []
    for path in CONFIGS:
        cfg = jconfig.load_config(path)
        for section, val in cfg.items():
            if isinstance(val, dict) and "transformer" in val:
                out.append(pytest.param(val["transformer"], id=f"{path.stem}:{section}"))
    return out


@pytest.mark.parametrize("block", _transformer_blocks())
@pytest.mark.parametrize("up", ["y", "z"])
def test_transform_params_match(block, up):
    j = jtr.TransformParams.from_config(block).for_up_axis(up)
    t = ttr.TransformParams.from_config(block).for_up_axis(up)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.is_noop() == j.is_noop()


OPTIONS = {
    "translation_xyz": dict(random_translation_xyz_magnitude=(1.0, 2.0, 0.5)),
    "translation_xz": dict(random_translation_xz_magnitude=20.0),
    "rotation_x": dict(rotation_x_max_angle=10.0),
    "rotation_y": dict(rotation_y_max_angle=10.0),
    "rotation_z": dict(rotation_z_max_angle=30.0),
    "stretch": dict(random_stretch_xyz_magnitude=(0.1, 0.2, 0.0)),
    "subsample": dict(random_subsample_percentage=0.3),
    "adaptive_subsample": dict(random_subsample_percentage=0.5, adaptive_subsampling_falloff_start=0.2,
                               adaptive_subsampling_falloff_end=1.5),  # fmt: skip
    "mirror_x": dict(random_mirror_x=True),
    "mirror_y": dict(random_mirror_y=True),
    "mirror_z": dict(random_mirror_z=True),
    "rotation_90_y": dict(random_rotation_90_degrees_y=True),
    "rotation_90_z": dict(random_rotation_90_degrees_z=True),
    "hsv_jitter": dict(hsv_jitter=(10.0, 0.1, 0.1)),
    "xyz_noise": dict(chance_of_xyz_noise=1.0, xyz_noise_stddev=(0.01, 0.02, 0.03)),
}
OPTIONS["all"] = {k: v for opt in OPTIONS.values() for k, v in opt.items()}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_apply_transform_full_bit_equal(option):
    cloud = jtoy.make_toy_cloud(2000, 4, seed=3)
    jp, tp = jtr.TransformParams(**OPTIONS[option]), ttr.TransformParams(**OPTIONS[option])
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):  # successive draws from one generator
        want = jtr.apply_transform_full(cloud.V, cloud.L_gt, jp, rj, colors=cloud.C, intensity=cloud.I)
        got = ttr.apply_transform_full(cloud.V, cloud.L_gt, tp, rt, colors=cloud.C, intensity=cloud.I)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert rt.bit_generator.state == rj.bit_generator.state  # same number of draws


def _synth20_loaders(mode):
    cfg = jconfig.load_config(SYNTH20)
    over = ["loader_synth_kitti.n_points=4096", "loader_synth_kitti.nr_samples=6",
            "loader_synth_kitti.nr_samples_test=3"]  # fmt: skip
    jconfig.apply_overrides(cfg, over)
    return tln.create_loader("synthkitti", cfg, mode), jln.create_loader("synthkitti", cfg, mode)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_synth_kitti_loader_matches(mode):
    t, j = _synth20_loaders(mode)
    for attr in ("nr_classes", "ignore_index", "fixed_n_points", "base_seed", "nr_samples"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.nr_classes, t.ignore_index, t.fixed_n_points) == (20, 0, 4096)
    assert t.label_names() == j.label_names() == tsk.KITTI20_CLASS_NAMES
    # five successive accesses: the augmentation generator advances through them
    for idx in (0, 1, 0, 2, 0):
        _assert_clouds_equal(t.get_cloud(idx), j.get_cloud(idx))
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_synth_kitti_disk_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LNT_SCENE_CACHE", str(tmp_path))
    t = tsk.SynthKitti("val", 2, 4096, classes=20)
    first = t.get_cloud(1)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = tsk.SynthKitti("val", 2, 4096, classes=20).get_cloud(1)  # read from the disk
    want = jsk.make_scene20(4096, seed=100_001)
    for f in ("V", "C", "I", "L_gt"):
        np.testing.assert_array_equal(getattr(first, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f))


@pytest.mark.parametrize("background", [None, 0, 3])
def test_compute_class_weights_matches(background):
    freqs = np.random.default_rng(5).dirichlet(np.ones(20))
    want = np.asarray(jlnn.compute_class_weights(freqs, background))
    got = tlnn.compute_class_weights(freqs, background)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def jax_scout_counts():
    """The JAX trainer's "auto" scout: label counts of the recipe's first
    four full-size train clouds (numpy only)."""
    jloader = jln.create_loader("synthkitti", jconfig.load_config(SYNTH20), "train")
    counts = np.zeros(20, np.int64)
    for i in range(4):
        counts += np.bincount(jloader.get_cloud(i).L_gt.reshape(-1), minlength=20)[:20]
    return counts


def test_auto_class_weights_of_the_synthkitti20_scout(capsys, jax_scout_counts):
    # the trainer's "auto" estimate on the recipe's four full-size scout
    # scenes (numpy only): the printed line is the JAX trainer's, bit for bit
    cfg = tconfig.load_config(SYNTH20)
    loader = tln.create_loader("synthkitti", cfg, "train")
    got = tln._class_weights(cfg, loader, 20, loader.ignore_index)
    line = capsys.readouterr().out.strip()
    counts = jax_scout_counts
    want = np.asarray(jlnn.compute_class_weights(counts / counts.sum(), 0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert line == f"class weights: {np.round(want, 3).tolist()}"


# this host's JAX-package weights less the JAX run's logged ones, rounded to
# 3 decimals (each printed weight is rounded to 3 decimals)
R5_LOG_GAPS = [0.0, -0.001, 0.0, 0.0, 0.003, 0.002, -0.001, 0.0, 0.0, 0.0,
               -0.001, 0.001, 0.0, -0.001, 0.0, -0.001, 0.0, 0.0, 0.0, 0.0]  # fmt: skip
R5_LOG_MAX_RELABELLED = 8  # points of one class, of the scout's 4 * 2^17


def test_jax_scout_class_weights_against_the_r5_log(jax_scout_counts):
    line = (ROOT / "docs" / "runs" / "synthkitti20_r5.log").read_text().splitlines()[42]
    assert line.startswith("class weights: ")
    logged = np.asarray(json.loads(line[len("class weights: "):]), np.float64)
    counts = jax_scout_counts
    assert counts.sum() == 4 << 17  # fixed-size scenes
    here = np.round(np.asarray(jlnn.compute_class_weights(counts / counts.sum(), 0)), 3)
    np.testing.assert_array_equal(np.round(here - logged, 3), R5_LOG_GAPS)
    # w = 1 / log(1.05 + n / N): the counts n whose weight rounds to each
    # logged entry lie in an interval; every interval is a whole number of
    # points away from this host's count, and only a few points
    n_total = counts.sum()
    lo = (np.exp(1.0 / (logged[1:] + 5e-4)) - 1.05) * n_total
    hi = (np.exp(1.0 / (logged[1:] - 5e-4)) - 1.05) * n_total
    moved = np.maximum(np.maximum(lo - counts[1:], counts[1:] - hi), 0)
    assert moved.max() <= R5_LOG_MAX_RELABELLED, moved
    # the arithmetic is the same: a relative error in the log large enough
    # to move class 4's weight by 0.003 would move the largest weight
    # (class 8's) by more than its rounding, and that one agrees
    assert moved[8 - 1] == 0 and logged[8] == here[8] == here.max()


def test_check_positions_raises_where_jax_raises():
    good = np.zeros((10, 3), np.float32)
    cases = [
        (np.zeros((10,), np.float32), None, None),  # rank
        (np.zeros((10, 7), np.float32), None, None),  # d
        (np.zeros((0, 3), np.float32), None, None),  # empty
        (np.zeros((10, 3), np.int32), None, None),  # not float
        (np.full((10, 3), np.nan, np.float32), None, None),  # NaN
        (np.full((10, 3), np.inf, np.float32), None, None),  # Inf
        (np.full((10, 3), 5000.0, np.float32), None, 0.6),  # too large for PACK_BOUND
        (good, np.zeros((9, 2), np.float32), None),  # mismatched values
        (good, np.zeros((10,), np.float32), None),  # values rank
        (good, np.full((10, 2), np.nan, np.float32), None),  # values NaN
    ]
    for p, v, sigma in cases:
        with pytest.raises((ValueError, TypeError)) as want:
            jops.check_positions(p, v, sigma)
        with pytest.raises(want.type) as got:
            tops.check_positions(p, v, sigma)
        assert str(got.value) == str(want.value)
    for p, v, sigma in [(good, None, None), (good, np.ones((10, 2), np.float32), 0.6),
                        (np.full((10, 3), 100.0, np.float32), None, 0.6)]:  # fmt: skip
        jops.check_positions(p, v, sigma)
        tops.check_positions(p, v, sigma)
