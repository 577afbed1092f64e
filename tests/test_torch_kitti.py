"""The port's SemanticKITTI data layer vs the JAX package's, on the CPU.

* ``write_kitti_dir`` writes files byte-equal to JAX's, for 6 and 20 classes.
* ``SemanticKitti.get_cloud`` equal to JAX's in ``V``, ``I``, ``L_gt`` and
  ``name``, without caps, with the distance and point caps (the point cap
  draws from the loader's generator), and in train mode with the transform
  of ``config/lnn_train_semantic_kitti.cfg``; both generators end in the
  same state.
* ``remap_labels`` and ``write_kitti_label_file`` byte-equal, with instance
  bits and out-of-range ids.
* The native reader built from the port's own copy of the C++ source decodes
  the same set of scans as the JAX package's native reader (a set: the
  reader threads finish in any order), and ``__iter__`` through it yields
  the same set of clouds as JAX's; without it, ``__iter__`` reads by index,
  as JAX's does.  Each prints which reader ran.
* The trainer's ``create_loader("semantickitti", ...)`` equals JAX's; a
  directory without a ``val`` split has no val loader, and the trainer
  tests on the ``test`` split instead.
* One epoch of the port's ``ln_train.run(device="cpu")`` on
  ``lnn_train_semantic_kitti.cfg`` (TensorBoard on, as written) over two
  2048-point scans at capacity 4096 ends with finite losses and a
  ``last.ckpt``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data import native_loader as jnl
from lattice_net_tpu.data import semantic_kitti as jskt
from lattice_net_tpu.data import synth_kitti as jsk
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import native_loader as tnl
from lattice_net_tpu_torch.data import semantic_kitti as tskt
from lattice_net_tpu_torch.data import synth_kitti as tsk
from lattice_net_tpu_torch.train import callbacks as tcb
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRAIN_CFG = ROOT / "config" / "lnn_train_semantic_kitti.cfg"
N_POINTS = 2048


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """Two train scans (sequence 00) and two test scans (11) of 2048 points."""
    return tsk.write_kitti_dir(tmp_path_factory.mktemp("kitti"), nr_train=2, nr_test=2, n_points=N_POINTS,
                               seed=1, classes=20)  # fmt: skip


@pytest.mark.parametrize("classes", [6, 20])
def test_write_kitti_dir_byte_equal_to_jax(tmp_path, classes):
    kw = dict(nr_train=2, nr_test=1, n_points=1500, seed=4, classes=classes)
    got = _files(tsk.write_kitti_dir(tmp_path / "port", **kw))
    want = _files(jsk.write_kitti_dir(tmp_path / "jax", **kw))
    assert sorted(got) == sorted(want) == sorted(
        [f"sequences/{s}/{k}/{i:06d}.{e}" for i, s in ((0, "00"), (1, "00"), (2, "11"))
         for k, e in (("velodyne", "bin"), ("labels", "label"))]
    )  # fmt: skip
    assert got == want


def _assert_clouds_equal(a, b):
    for f in ("V", "I", "L_gt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


def _transform(mod_config, mod_transforms):
    cfg = mod_config.load_config(TRAIN_CFG)
    block = cfg["loader_semantic_kitti"]["transformer"]
    return mod_transforms.TransformParams.from_config(block).for_up_axis("z")


@pytest.mark.parametrize(
    "mode, cap_distance, max_points, transform",
    [("test", -1, 100000000, False), ("test", 30.0, 1000, False), ("train", 60.0, 1500, True),
     ("train", 60.0, 400000, True)],
)  # fmt: skip
def test_get_cloud_matches_jax(kitti_dir, mode, cap_distance, max_points, transform):
    from lattice_net_tpu.data import transforms as jtr
    from lattice_net_tpu_torch.data import transforms as ttr

    kw = dict(mode=mode, cap_distance=cap_distance, max_nr_points_per_cloud=max_points, seed=3)
    port = tskt.SemanticKitti(kitti_dir, transform=_transform(tconfig, ttr) if transform else None, **kw)
    ref = jskt.SemanticKitti(kitti_dir, transform=_transform(jconfig, jtr) if transform else None, **kw)
    assert len(port) == len(ref) == 2
    for i in (0, 1, 0):  # the generators advance through the calls
        got, want = port.get_cloud(i), ref.get_cloud(i)
        _assert_clouds_equal(got, want)
        assert got.name == f"{'00' if mode == 'train' else '11'}/{i + (0 if mode == 'train' else 2):06d}"
        if cap_distance > 0:
            assert (np.linalg.norm(got.V, axis=1) < cap_distance).all() or transform
        assert len(got.V) <= max_points
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_remap_and_label_file_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    ids = np.array(sorted(tskt.LEARNING_MAP) + [1000, 65535, 7], np.uint32)
    raw = rng.choice(ids, 5000) | (rng.integers(0, 1 << 16, 5000, dtype=np.uint32) << 16)
    got = tskt.remap_labels(raw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jskt.remap_labels(raw))
    assert tskt.LEARNING_MAP == jskt.LEARNING_MAP and tskt.LEARNING_MAP_INV == jskt.LEARNING_MAP_INV
    assert tskt.CLASS_NAMES == jskt.CLASS_NAMES and tskt.NR_CLASSES == jskt.NR_CLASSES
    assert (tskt.TRAIN_SEQUENCES, tskt.VAL_SEQUENCES, tskt.TEST_SEQUENCES) == (
        jskt.TRAIN_SEQUENCES, jskt.VAL_SEQUENCES, jskt.TEST_SEQUENCES)  # fmt: skip
    train_ids = rng.integers(-3, 23, 5000).astype(np.int32)
    tskt.write_kitti_label_file(tmp_path / "port" / "a.label", train_ids)
    jskt.write_kitti_label_file(tmp_path / "jax" / "a.label", train_ids)
    assert (tmp_path / "port" / "a.label").read_bytes() == (tmp_path / "jax" / "a.label").read_bytes()


@pytest.fixture(scope="module")
def native():
    if not tnl.native_available():
        pytest.fail(f"the port's native reader does not build: {tnl.build_error()}")
    if not jnl.build_native():
        pytest.skip("the JAX package's native reader does not build here")
    return tnl


def _key(sample):
    return tuple(np.ascontiguousarray(a).tobytes() for a in sample)


def test_native_reader_decodes_what_jax_decodes(native, kitti_dir):
    files = sorted(Path(kitti_dir).rglob("*.bin"))
    labels = [tskt.label_path(f) for f in files]
    assert tnl.library_path().parent == ROOT / "lattice_net_tpu_torch" / "build"
    for shuffle in (False, True):
        kw = dict(n_threads=3, shuffle=shuffle, seed=9)
        port = tnl.NativeCloudLoader(files, labels, tnl.FORMAT_KITTI_BIN, **kw)
        ref = jnl.NativeCloudLoader(files, labels, jnl.FORMAT_KITTI_BIN, **kw)
        got, want = [_key(s) for s in port], [_key(s) for s in ref]
        port.close()
        ref.close()
        assert len(got) == len(want) == len(files)
        assert set(got) == set(want)
    # one scan decoded against the file: xyz, intensity, semantic bits
    xyz, intensity, lab = tnl.NativeCloudLoader(files[:1], labels[:1], n_threads=1).next()
    raw = np.fromfile(files[0], np.float32).reshape(-1, 4)
    np.testing.assert_array_equal(xyz, raw[:, :3])
    np.testing.assert_array_equal(intensity, raw[:, 3])
    np.testing.assert_array_equal(lab, (np.fromfile(labels[0], np.uint32) & 0xFFFF).astype(np.int32))


def test_iter_native_matches_jax_as_a_set(native, kitti_dir, capsys):
    kw = dict(mode="test", cap_distance=30.0, max_nr_points_per_cloud=1200, seed=2)
    port, ref = tskt.SemanticKitti(kitti_dir, **kw), jskt.SemanticKitti(kitti_dir, **kw)
    got, want = list(port), list(ref)
    assert f"semantickitti reader: native ({tnl.library_path().name})" in capsys.readouterr().out
    assert len(got) == len(want) == 2
    # the seed draw of the native reader comes first in both streams; the
    # point caps draw in the order the threads finish, so compare the scans
    # by their point sets
    assert {c.name for c in got} == {c.name for c in want} == {""}
    assert {np.sort(c.L_gt, 0).tobytes() for c in got} == {np.sort(c.L_gt, 0).tobytes() for c in want}
    assert sorted(len(c.V) for c in got) == sorted(len(c.V) for c in want) == [1200, 1200]


def test_iter_without_native_reads_by_index_like_jax(kitti_dir, monkeypatch, capsys):
    monkeypatch.setattr(tnl, "native_available", lambda: False)
    monkeypatch.setattr(tnl, "build_error", lambda: "switched off")
    monkeypatch.setattr(jnl, "native_available", lambda: False)
    for shuffle in (False, True):
        kw = dict(mode="test", cap_distance=-1, max_nr_points_per_cloud=1000, seed=6, shuffle=shuffle)
        got = list(tskt.SemanticKitti(kitti_dir, **kw))
        want = list(jskt.SemanticKitti(kitti_dir, **kw))
        out = capsys.readouterr().out
        assert "semantickitti reader: python (native reader unavailable: switched off)" in out
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_clouds_equal(a, b)


def test_create_loader_matches_jax(kitti_dir):
    overrides = [f"loader_semantic_kitti.dataset_path={kitti_dir}"]
    cfg_t = tconfig.apply_overrides(tconfig.load_config(TRAIN_CFG), overrides)
    cfg_j = jconfig.apply_overrides(jconfig.load_config(TRAIN_CFG), overrides)
    for mode in ("train", "test"):
        port = tln.create_loader("semantickitti", cfg_t, mode)
        ref = jln.create_loader("semantickitti", cfg_j, mode)
        assert [(s, f.name) for s, f in port.scans] == [(s, f.name) for s, f in ref.scans]
        assert (port.cap_distance, port.max_points, port.shuffle, port.mode) == (
            ref.cap_distance, ref.max_points, ref.shuffle, ref.mode)  # fmt: skip
        assert vars(port.transform) == vars(ref.transform)
        _assert_clouds_equal(port.get_cloud(1), ref.get_cloud(1))
    # write_kitti_dir writes no val split (sequence 08)
    with pytest.raises(FileNotFoundError):
        tln.create_loader("semantickitti", cfg_t, "val")


def test_trainer_epoch_on_kitti_dir(kitti_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the TensorBoard logs go to ./tensorboard_logs, as in JAX
    losses = []
    orig = tcb.StateCallback.after_forward_pass

    def after_forward_pass(self, phase=None, loss=0.0, **kw):
        losses.append((phase.name, float(loss)))
        orig(self, phase=phase, loss=loss, **kw)

    monkeypatch.setattr(tcb.StateCallback, "after_forward_pass", after_forward_pass)
    state = tln.run(TRAIN_CFG, max_epochs=1, device="cpu", overrides=[
        f"loader_semantic_kitti.dataset_path={kitti_dir}", "lattice_gpu.hash_table_capacity=4096",
        f"train.checkpoint_path={tmp_path / 'ckpt'}"])  # fmt: skip
    out = capsys.readouterr().out
    assert [name for name, _ in losses] == ["train", "train", "test", "test"]
    assert all(np.isfinite(l) for _, l in losses)
    assert state.step == 2
    assert (tmp_path / "ckpt" / "last.ckpt").exists()
    assert "semantickitti reader:" in out
    assert "[test] epoch 0:" in out
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        assert "tensorboard: not logging" in out
    else:
        assert list((tmp_path / "tensorboard_logs" / "semantickitti").glob("events.out.tfevents.*"))
