"""The port's ShapeNet part-segmentation data layer, trainer path, ablation
distribute and PLY/HTML dumps vs the JAX package's, on the CPU.

* ``make_motorbike`` and ``write_benchmark_dir`` give arrays and files
  byte-equal to JAX's.
* ``ShapeNetPartSeg`` equals JAX's on that directory: the split lists of
  each mode (and the glob fallback without split files), ``get_cloud`` in
  test and train mode (the y-up transform of
  ``config/ln_train_shapenet_example.cfg``, normalised or not), and the
  ``__iter__`` stream from one seed through the native reader (one decoding
  thread, so both sides see one arrival order) and without it; both
  generators end in the same state.
* JAX's native stream yields clouds without a name (ROADMAP §3), so JAX's
  eval would name its files by arrival order; the port's eval reads by
  index (``tests/test_torch_shapenet_model.py`` holds its files).
* The trainer's ``create_loader("shapenet", ...)`` equals JAX's, with the
  recipe's y-up axes.
* ``distribute_sorted`` with ``subtract_local_mean=False`` (the ablation
  modes') equals JAX's rows, and differs from the default.
* ``PlyDumpCallback`` and ``write_html_viewer`` write files byte-equal to
  JAX's from the same arrays.
* One epoch of ``ln_train.run(device="cpu")`` on the ShapeNet config with a
  narrow model of its block plan: batch 4 over five train clouds (a full
  batch, then one real cloud and three padded slots), the test phase on the
  ``val`` split; finite losses, the reader printed, a ``last.ckpt``.
"""

import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data import native_loader as jnl
from lattice_net_tpu.data import shapenet as jsn
from lattice_net_tpu.data import synth_shapenet as jss
from lattice_net_tpu.data import transforms as jtr
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.misc import viz_html as jvh
from lattice_net_tpu.train import callbacks as jcb
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import native_loader as tnl
from lattice_net_tpu_torch.data import shapenet as tsn
from lattice_net_tpu_torch.data import synth_shapenet as tss
from lattice_net_tpu_torch.data import transforms as ttr
from lattice_net_tpu_torch.interop import hierarchy_from_numpy
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.misc import viz_html as tvh
from lattice_net_tpu_torch.train import callbacks as tcb
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRAIN_CFG = ROOT / "config" / "ln_train_shapenet_example.cfg"
N_POINTS = 500
SPLIT = dict(nr_train=5, nr_test=3)  # val = the first test cloud
# the config's block plan (3 downsamples, a bottleneck up stage) at narrow width
NARROW = [
    "model.pointnet_channels_per_layer=[8, 16]", "model.pointnet_start_nr_channels=16",
    "model.nr_blocks_down_stage=[1, 1, 1]", "model.nr_blocks_bottleneck=1",
    "model.nr_blocks_up_stage=[1, 1, 1]", "lattice_gpu.hash_table_capacity=2048",
]  # fmt: skip


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def sn_dir(tmp_path_factory):
    return tss.write_benchmark_dir(tmp_path_factory.mktemp("shapenet"), n_points=N_POINTS, seed=2, **SPLIT)


def _transform(mod_config, mod_transforms):
    block = mod_config.load_config(TRAIN_CFG)["loader_shapenet_partseg"]["transformer"]
    return mod_transforms.TransformParams.from_config(block)


def _assert_clouds_equal(a, b):
    for f in ("V", "C", "I", "L_gt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize("n, seed", [(64, 0), (300, 1), (2500, 7)])
def test_make_motorbike_equals_jax(n, seed):
    (v, l), (jv, jl) = tss.make_motorbike(n, seed), jss.make_motorbike(n, seed)
    assert v.dtype == jv.dtype and l.dtype == jl.dtype and v.shape == (n, 3) and l.shape == (n, 1)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(l, jl)
    assert set(np.unique(l).tolist()) == set(range(1, tsn.NR_PARTS["motorbike"] + 1))
    with pytest.raises(ValueError):
        tss.make_motorbike(63)


def test_write_benchmark_dir_byte_equal_to_jax(tmp_path):
    kw = dict(nr_train=3, nr_test=2, n_points=300, seed=5)
    got = _files(tss.write_benchmark_dir(tmp_path / "port", **kw))
    want = _files(jss.write_benchmark_dir(tmp_path / "jax", **kw))
    names = [f"synth{i:04d}" for i in range(5)]
    assert sorted(got) == sorted(want) == sorted(
        [f"03790512/points/{n}.pts" for n in names] + [f"03790512/points_label/{n}.seg" for n in names]
        + [f"train_test_split/shuffled_{m}_file_list.json" for m in ("train", "test", "val")]
    )  # fmt: skip
    assert got == want


def test_tables_match_jax():
    assert tsn.CATEGORIES == jsn.CATEGORIES and tsn.NR_PARTS == jsn.NR_PARTS
    assert tss.MOTORBIKE_SYNSET == jss.MOTORBIKE_SYNSET == tsn.CATEGORIES["motorbike"]


@pytest.mark.parametrize("mode", ["train", "test", "val"])
def test_split_lists_match_jax(sn_dir, mode):
    port, ref = tsn.ShapeNetPartSeg(sn_dir, mode=mode), jsn.ShapeNetPartSeg(sn_dir, mode=mode)
    assert port.files == ref.files
    assert len(port) == len(ref) == dict(train=5, test=3, val=1)[mode]
    assert port.nr_classes == ref.nr_classes == 7
    assert port.label_names() == ref.label_names()


def test_split_glob_fallback_and_refusals_match_jax(sn_dir, tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(sn_dir, bare, ignore=shutil.ignore_patterns("train_test_split"))
    port, ref = tsn.ShapeNetPartSeg(bare, mode="test"), jsn.ShapeNetPartSeg(bare, mode="test")
    assert port.files == ref.files and len(port.files) == 8
    for kw in (dict(restrict_to_object="chair"), dict(dataset_path=tmp_path / "none")):
        args = {"dataset_path": sn_dir, **kw}
        with pytest.raises(FileNotFoundError):
            tsn.ShapeNetPartSeg(**args)
        with pytest.raises(FileNotFoundError):
            jsn.ShapeNetPartSeg(**args)


@pytest.mark.parametrize(
    "mode, normalize, transform, overfit",
    [("test", False, False, False), ("test", True, True, False), ("train", False, True, False),
     ("train", True, True, True)],
)  # fmt: skip
def test_get_cloud_matches_jax(sn_dir, mode, normalize, transform, overfit):
    kw = dict(mode=mode, normalize=normalize, do_overfit=overfit, seed=3)
    port = tsn.ShapeNetPartSeg(sn_dir, transform=_transform(tconfig, ttr) if transform else None, **kw)
    ref = jsn.ShapeNetPartSeg(sn_dir, transform=_transform(jconfig, jtr) if transform else None, **kw)
    for i in (0, 1, 0):  # the generators advance through the calls
        got, want = port.get_cloud(i), ref.get_cloud(i)
        _assert_clouds_equal(got, want)
        assert got.name == ("synth0000" if overfit else port.files[i][0].stem)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


@pytest.fixture(scope="module")
def native():
    if not tnl.native_available():
        pytest.fail(f"the port's native reader does not build: {tnl.build_error()}")
    if not jnl.build_native():
        pytest.skip("the JAX package's native reader does not build here")
    return tnl


def _one_thread(cls):
    """The reader class with one decoding thread: the clouds then arrive in
    one order on both sides, so the transform's draws meet the same clouds."""

    class OneThread(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **dict(kw, n_threads=1))

    return OneThread


@pytest.mark.parametrize("mode, shuffle", [("train", True), ("test", False)])
def test_iter_native_matches_jax(native, sn_dir, monkeypatch, capsys, mode, shuffle):
    monkeypatch.setattr(tnl, "NativeCloudLoader", _one_thread(tnl.NativeCloudLoader))
    monkeypatch.setattr(jnl, "NativeCloudLoader", _one_thread(jnl.NativeCloudLoader))
    kw = dict(mode=mode, shuffle=shuffle, seed=11)
    port = tsn.ShapeNetPartSeg(sn_dir, transform=_transform(tconfig, ttr), **kw)
    ref = jsn.ShapeNetPartSeg(sn_dir, transform=_transform(jconfig, jtr), **kw)
    got, want = list(port), list(ref)
    assert f"shapenet reader: native ({tnl.library_path().name})" in capsys.readouterr().out
    assert len(got) == len(want) == len(port.files)
    for a, b in zip(got, want):
        _assert_clouds_equal(a, b)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state
    if mode == "test":  # no transform, in file order: the files' own points
        for c, (pts, _) in zip(got, port.files):
            np.testing.assert_array_equal(c.V, np.loadtxt(pts, dtype=np.float32))


def test_iter_without_native_matches_jax(sn_dir, monkeypatch, capsys):
    monkeypatch.setattr(tnl, "native_available", lambda: False)
    monkeypatch.setattr(tnl, "build_error", lambda: "switched off")
    monkeypatch.setattr(jnl, "native_available", lambda: False)
    kw = dict(mode="train", shuffle=True, seed=4)
    port = tsn.ShapeNetPartSeg(sn_dir, transform=_transform(tconfig, ttr), **kw)
    ref = jsn.ShapeNetPartSeg(sn_dir, transform=_transform(jconfig, jtr), **kw)
    got, want = list(port), list(ref)
    assert "shapenet reader: python (native reader unavailable: switched off)" in capsys.readouterr().out
    assert [c.name for c in got] == [c.name for c in want] and sorted(c.name for c in got) == [
        f"synth{i:04d}" for i in range(5)]  # fmt: skip
    for a, b in zip(got, want):
        _assert_clouds_equal(a, b)


def test_jax_shapenet_native_reader_loses_names(native, sn_dir):
    """JAX's eval iterates the loader (``ln_eval.py:228``) and names each
    file ``pred_<cloud.name or index>.txt`` (``:240``, ``:259``); its native
    stream's clouds have no name, so the files would be ``pred_000000.txt``,
    ... in arrival order.  Clouds read by index keep their stems."""
    ref = jsn.ShapeNetPartSeg(sn_dir, mode="test", shuffle=False)
    assert [c.name for c in ref] == ["", "", ""]
    assert [ref.get_cloud(i).name for i in range(3)] == ["synth0005", "synth0006", "synth0007"]
    port = tsn.ShapeNetPartSeg(sn_dir, mode="test", shuffle=False)
    assert [port.get_cloud(i).name for i in range(3)] == ["synth0005", "synth0006", "synth0007"]


def test_create_loader_matches_jax(sn_dir):
    overrides = [f"loader_shapenet_partseg.dataset_path={sn_dir}"]
    cfg_t = tconfig.apply_overrides(tconfig.load_config(TRAIN_CFG), overrides)
    cfg_j = jconfig.apply_overrides(jconfig.load_config(TRAIN_CFG), overrides)
    for mode in ("train", "val", "test"):
        port = tln.create_loader("shapenet", cfg_t, mode)
        ref = jln.create_loader("shapenet", cfg_j, mode)
        assert port.files == ref.files
        assert (port.category, port.shuffle, port.normalize, port.do_overfit, port.mode) == (
            ref.category, ref.shuffle, ref.normalize, ref.do_overfit, ref.mode)  # fmt: skip
        assert vars(port.transform) == vars(ref.transform)
        _assert_clouds_equal(port.get_cloud(0), ref.get_cloud(0))
    # y-up: the recipe's translation and mirror stay on the axes it names
    assert port.transform.random_translation_xyz_magnitude == (0.2, 0.0, 0.2)
    assert port.transform.random_mirror_z and not port.transform.random_mirror_y


@pytest.fixture(scope="module")
def hierarchies(sn_dir):
    """One cloud's JAX build (jitted) with its feature rows, and the port's copy."""
    cloud = tsn.ShapeNetPartSeg(sn_dir, mode="test").get_cloud(0)
    pos = cloud.V
    vals = np.random.default_rng(0).normal(size=(len(pos), 1)).astype(np.float32)
    build = jax.jit(functools.partial(jbuild, sigma=0.05, nr_levels=1, capacities=(2048, 1024)))
    hj = build(jnp.asarray(pos), point_feats=jnp.asarray(vals))
    return pos, vals, hj, hierarchy_from_numpy(hj, device="cpu")


@pytest.mark.parametrize("subtract", [False, True])
def test_distribute_sorted_matches_jax(hierarchies, subtract):
    pos, vals, hj, ht = hierarchies
    cap = hj.structures[0].capacity
    want, wids = jops.distribute_sorted(jnp.asarray(pos), jnp.asarray(vals), hj.edges, cap,
                                        subtract_local_mean=subtract, splat_weights=hj.splat_weights)  # fmt: skip
    got, ids = tops.distribute_sorted(torch.from_numpy(pos), torch.from_numpy(vals), ht.edges, cap,
                                      subtract_local_mean=subtract)  # fmt: skip
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if not subtract:  # the rows carry the raw positions
        default, _ = tops.distribute_sorted(torch.from_numpy(pos), torch.from_numpy(vals), ht.edges, cap)
        valid = ids.numpy() < cap
        assert not np.allclose(got.numpy()[valid, :3], default.numpy()[valid, :3])
        np.testing.assert_array_equal(got.numpy()[:, 3:], default.numpy()[:, 3:])


class _Phase:
    def __init__(self, grad, epoch_nr):
        self.grad, self.epoch_nr = grad, epoch_nr


@pytest.mark.parametrize("html, every", [(False, 1), (True, 2)])
def test_ply_dump_callback_files_byte_equal_to_jax(tmp_path, html, every):
    rng = np.random.default_rng(6)
    n, classes = 700, 7
    positions = rng.normal(size=(n, 4)).astype(np.float32)  # columns past xyz are dropped
    pred, target = rng.integers(0, classes, n), rng.integers(-1, classes, n)
    outs = {}
    for side, mod in (("port", tcb), ("jax", jcb)):
        cb = mod.PlyDumpCallback(tmp_path / side, classes, ignore_index=-1, every_n_epochs=every, html=html)
        cb.after_forward_pass(phase=_Phase(False, 0), positions=positions * 2, pred=pred, target=target)
        cb.after_forward_pass(phase=_Phase(False, 0), loss=1.0)  # no sample: skipped
        cb.epoch_ended(phase=_Phase(True, 1))  # a train phase: nothing written
        for epoch in (1, 2):
            cb.after_forward_pass(phase=_Phase(False, epoch), positions=positions + epoch, pred=pred,
                                  target=None if epoch == 2 else target)  # fmt: skip
            cb.epoch_ended(phase=_Phase(False, epoch))
        outs[side] = _files(tmp_path / side)
    want_names = set()
    for e in range(1, 3):
        if e % every == 0:
            files = ["prediction.ply"] + ["diff.ply"] * (e == 1) + ["prediction.html"] * html
            want_names |= {f"epoch_{e}/{f}" for f in files}
    assert set(outs["port"]) == set(outs["jax"]) == want_names
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("max_points", [400_000, 300])
def test_write_html_viewer_byte_equal_to_jax(tmp_path, max_points):
    rng = np.random.default_rng(7)
    xyz, rgb = rng.normal(size=(1000, 3)), rng.integers(-20, 280, (1000, 3))
    got = tvh.write_html_viewer(tmp_path / "port.html", xyz, rgb, title="t", max_points=max_points)
    want = jvh.write_html_viewer(tmp_path / "jax.html", xyz, rgb, title="t", max_points=max_points)
    assert got.read_bytes() == want.read_bytes()
    assert f"t — {min(1000, max_points)} pts" in got.read_text()
    with pytest.raises(ValueError):
        tvh.write_html_viewer(tmp_path / "bad.html", xyz, rgb[:5])


def test_trainer_epoch_on_shapenet_dir(sn_dir, tmp_path, monkeypatch, capsys):
    slots = []
    orig = tcb.StateCallback.after_forward_pass

    def after_forward_pass(self, phase=None, loss=0.0, **kw):
        slots.append((phase.name, float(loss)))
        orig(self, phase=phase, loss=loss, **kw)

    monkeypatch.setattr(tcb.StateCallback, "after_forward_pass", after_forward_pass)
    state = tln.run(TRAIN_CFG, max_epochs=1, device="cpu", overrides=[
        f"loader_shapenet_partseg.dataset_path={sn_dir}", f"train.checkpoint_path={tmp_path / 'ckpt'}",
        *NARROW])  # fmt: skip
    out = capsys.readouterr().out
    # five train clouds at batch 4: a full batch and a padded one; val holds one cloud
    assert [name for name, _ in slots] == ["train", "train", "test"]
    assert all(np.isfinite(l) for _, l in slots)
    assert state.step == 2
    assert "n_points=512 batch=4 caps=(2048, 1024, 512, 256) sigma=0.05 classes=7" in out
    # a "sample" is a forward, as in JAX's StateCallback
    assert "shapenet reader:" in out and "[train] 2 samples" in out and "[test] 1 samples" in out
    assert "[train] lattice occupancy" in out and "overflow 0.0" in out
    assert (tmp_path / "ckpt" / "last.ckpt").exists()
