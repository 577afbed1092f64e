"""The port's ScanNet slice vs the JAX package, on the CPU.

* Data: ``make_indoor_scene`` arrays equal to JAX's; ``write_scannet_dir``
  writes byte-equal PLY files and ``.npz`` files whose members are
  byte-equal (the zip headers carry the write time); ``ScanNet.get_cloud``
  equal to JAX's for npz and PLY scenes, the point cap's subsampling and the
  train transform with its HSV jitter (the same generator draws, call after
  call); ``__iter__`` in the same order; ``write_scannet_prediction``
  byte-equal through the NYU40 remap; the PLY reader on a mesh without
  colours or labels.
* The JAX package's split fault: its trainer's held-out phase asks ScanNet
  for ``"val"``, which reads ``scans``, the train scenes; the port keeps it.
* The ScanNet model at small depth (``rgb+height``, 3 downsamples, blocks
  (1, 1, 1) / 1 / (1, 1, 1), 21 classes, sigma 0.08, the config's widths)
  on a 3500-point indoor scene padded to 4096 points, weights from
  ``params_from_flax``.  The reference is JAX's f64 forward and step (under
  ``jax.enable_x64``; the hierarchy and the init are built in f32): in f32
  the JAX package's own log-probabilities are 9.7e-3 from its f64 ones on
  this scene (its logits reach +-500) and its gradients up to 2.1e-3
  (relative L2), so an f32-to-f32 comparison would measure the reference's
  rounding.  The port in f64: log-probabilities to 1e-4 with equal labels,
  the loss to 1e-5, every gradient to a relative L2 of 1e-4.  The port in
  f32, the path that runs: equal labels, log-probabilities to 1e-3, the
  loss to 1e-5, every gradient to a relative L2 of 1e-3 (the repo's
  cross-precision level; measured 5.7e-4 and 4.6e-4).
  At full width the port's ``LNN`` has 8,975,297 parameters, with JAX's
  names and shapes (JAX's init traced with ``jax.eval_shape``).
* ``ln_eval`` of both packages on a ScanNet-format directory (two
  2048-point test scenes) from one checkpoint that JAX wrote: byte-equal
  ``<scene>.txt`` files, whole and at a 1024-point budget (2 chunks a scene).

The JAX init of the small model is built once (jitted) and serves the
forward, the step and the eval, whose ``build_and_init`` returns it.
"""

import dataclasses
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data import scannet as jsn
from lattice_net_tpu.data import synth_scannet as jsyn
from lattice_net_tpu.data.transforms import TransformParams as JTransformParams
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.misc import scannet_scale_probe as jprobe
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import ln_eval as jev
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu.train import setup_worker as jsw
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import scannet as tsn
from lattice_net_tpu_torch.data import synth_scannet as tsyn
from lattice_net_tpu_torch.data.transforms import TransformParams as TTransformParams
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.misc import scannet_scale_probe as tprobe
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.train import ln_eval as tev
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRAIN_CFG = ROOT / "config" / "lnn_train_scannet.cfg"
EVAL_CFG = ROOT / "config" / "lnn_eval_scannet.cfg"
LOGP_ATOL, LOSS_ATOL, GRAD_REL_L2 = 1e-4, 1e-5, 1e-4  # port f64 vs JAX f64
F32_LOGP_ATOL, F32_GRAD_REL_L2 = 1e-3, 1e-3  # port f32 vs JAX f64
N_POINTS, N_REAL, SIGMA = 4096, 3500, 0.08
CAPS = (16384, 16384, 4096, 2048)
SMALL_DEPTH = ["model.nr_blocks_down_stage=[1,1,1]", "model.nr_blocks_bottleneck=1",
               "model.nr_blocks_up_stage=[1,1,1]"]  # fmt: skip
SCANNET_PARAMS = 8_975_297  # docs/runs/scannet_probe_full.log


def _model_params(pkg, cfg_overrides=SMALL_DEPTH):
    return pkg.model_params_from_config(pkg.apply_overrides(pkg.load_config(TRAIN_CFG), cfg_overrides), 21)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, seed", [(4096, 0), (20001, 7)])
def test_make_indoor_scene_equals_jax(n, seed):
    for a, b in zip(tprobe.make_indoor_scene(n, seed), jprobe.make_indoor_scene(n, seed), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("scannet")
    kw = dict(nr_train=3, nr_test=2, n_points=2048, seed=4)
    return tsyn.write_scannet_dir(d / "port", **kw), jsyn.write_scannet_dir(d / "jax", **kw)


def test_write_scannet_dir_matches_jax(dirs):
    port, jax_dir = dirs
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert [str(f) for f in files] == [f"scans/scene{i:04d}_00/scene{i:04d}_00.npz" for i in range(3)] + [
        f"scans_test/scene{i:04d}_00/scene{i:04d}_00_vh_clean_2.labels.ply" for i in (3, 4)]  # fmt: skip
    for rel in files:
        if rel.suffix == ".ply":
            assert (port / rel).read_bytes() == (jax_dir / rel).read_bytes()
        else:
            with zipfile.ZipFile(port / rel) as a, zipfile.ZipFile(jax_dir / rel) as b:
                assert a.namelist() == b.namelist() == ["points.npy", "colors.npy", "labels.npy"]
                for name in a.namelist():
                    assert a.read(name) == b.read(name)
    np.testing.assert_array_equal(tsyn._synth_to_nyu40(np.arange(25)), jsyn._synth_to_nyu40(np.arange(25)))


def _transform(pkg_params):
    cfg = tconfig.load_config(TRAIN_CFG)
    return pkg_params.from_config(cfg["loader_scannet"]["transformer"]).for_up_axis("z")


def _clouds_equal(a, b):
    for f in ("V", "C", "I", "L_gt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize(
    "mode, cap, transform",
    [("train", -1, False), ("test", -1, False), ("train", 1500, False), ("test", 1000, False),
     ("train", 1500, True), ("train", -1, True)],
)  # fmt: skip
def test_get_cloud_matches_jax(dirs, mode, cap, transform):
    port, jax_dir = dirs
    kw = dict(mode=mode, max_nr_points_per_cloud=cap, seed=5)
    t = tsn.ScanNet(port, transform=_transform(TTransformParams) if transform else None, **kw)
    j = jsn.ScanNet(jax_dir, transform=_transform(JTransformParams) if transform else None, **kw)
    assert len(t) == len(j) == (3 if mode == "train" else 2)
    for i in (0, 1, 0):  # the draws go on from call to call
        a, b = t.get_cloud(i), j.get_cloud(i)
        _clouds_equal(a, b)
        assert len(a.V) == (min(cap, 2048) if cap > 0 else 2048)
    assert set(np.unique(a.L_gt).tolist()) <= set(range(21))


def test_iter_order_matches_jax(dirs):
    port, jax_dir = dirs
    for shuffle, seed in ((True, 0), (True, 3), (False, 0)):
        t = tsn.ScanNet(port, max_nr_points_per_cloud=1000, shuffle=shuffle, seed=seed)
        j = jsn.ScanNet(jax_dir, max_nr_points_per_cloud=1000, shuffle=shuffle, seed=seed)
        got, want = list(t), list(j)
        assert [c.name for c in got] == [c.name for c in want]
        for a, b in zip(got, want, strict=True):
            _clouds_equal(a, b)


def test_write_scannet_prediction_matches_jax(tmp_path):
    ids = np.random.default_rng(0).integers(-2, 24, 500)
    tsn.write_scannet_prediction(tmp_path / "port" / "a.txt", ids)
    jsn.write_scannet_prediction(tmp_path / "jax" / "a.txt", ids)
    assert (tmp_path / "port" / "a.txt").read_bytes() == (tmp_path / "jax" / "a.txt").read_bytes()
    # the remap round-trips: NYU40 id -> train id -> NYU40 id
    nyu = np.loadtxt(tmp_path / "port" / "a.txt", dtype=np.int64)
    back = tsn._LUT[nyu]
    np.testing.assert_array_equal(back, np.clip(ids, 0, 20))
    assert tsn.VALID_CLASS_IDS == jsn.VALID_CLASS_IDS and tsn.CLASS_NAMES == jsn.CLASS_NAMES
    np.testing.assert_array_equal(tsn._LUT, jsn._LUT)


def test_ply_reader_without_colour_or_label(tmp_path):
    v = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    path = tmp_path / "raw.ply"
    header = "ply\nformat binary_little_endian 1.0\nelement vertex 7\nproperty float x\n" \
             "property float y\nproperty float z\nelement face 0\nproperty list uchar int vertex_indices\n" \
             "end_header\n"  # fmt: skip
    path.write_bytes(header.encode() + v.tobytes())
    for a, b in zip(tsn.read_ply_xyz_rgb_label(path), jsn.read_ply_xyz_rgb_label(path), strict=True):
        np.testing.assert_array_equal(a, b)
    assert not tsn.read_ply_xyz_rgb_label(path)[1].any()
    (tmp_path / "ascii.ply").write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(ValueError, match="format"):
        tsn.read_ply_xyz_rgb_label(tmp_path / "ascii.ply")
    with pytest.raises(FileNotFoundError):
        tsn.ScanNet(tmp_path / "none")


def test_jax_scannet_val_split_reads_the_train_scenes(dirs):
    """The JAX trainer tests on ``create_loader(..., "val")``
    (``lattice_net_tpu/train/ln_train.py:304``) and ScanNet reads ``scans``
    for every mode but "test" (``lattice_net_tpu/data/scannet.py:100``): its
    held-out ScanNet phase scores the train scenes.  The port keeps that, so
    the two trainers stay comparable (ROADMAP §3)."""
    port, jax_dir = dirs
    train_names = [f"scene{i:04d}_00" for i in range(3)]
    for pkg_ln, root in ((jln, jax_dir), (tln, port)):
        cfg = tconfig.apply_overrides(tconfig.load_config(TRAIN_CFG), [f"loader_scannet.dataset_path={root}"])
        held_out = pkg_ln.create_loader("scannet", cfg, "val")
        train = pkg_ln.create_loader("scannet", cfg, "train")
        assert [p.parent.name for p in held_out.scenes] == train_names
        assert held_out.scenes == train.scenes
        assert [p.parent.name for p in pkg_ln.create_loader("scannet", cfg, "test").scenes] == [
            "scene0003_00", "scene0004_00"]  # fmt: skip


# ---------------------------------------------------------------------------
# the model at small depth, and its parameters at full width
# ---------------------------------------------------------------------------


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, tree)


@pytest.fixture(scope="module")
def ref():
    """The JAX init of the small-depth ScanNet model (f32), and in f64 its
    log-probabilities on one padded indoor scene and its loss and gradients
    there."""
    mp = _model_params(jconfig)
    V, C, L = jprobe.make_indoor_scene(N_POINTS, seed=1)
    cloud = jsn.ToyCloud(V=V[:N_REAL], C=C[:N_REAL], I=np.zeros((N_REAL, 1), np.float32),
                         L_gt=jsn._LUT[jsyn._synth_to_nyu40(L[:N_REAL].astype(np.int64))].reshape(-1, 1))  # fmt: skip
    prepared = jlnn.prepare_cloud(cloud, mp)
    batch = jax.tree.map(np.asarray, jdp.make_batch([prepared], mp, N_POINTS, rng=np.random.default_rng(3)))
    b0 = {k: v[0] for k, v in batch.items()}
    model = jlnn.LNN(mp)

    def build(b):
        return jbuild(b["positions"], SIGMA, 3, CAPS, point_mask=b["point_mask"], point_feats=b["values"])

    hj = jax.jit(build)(b0)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), hj, b0["positions"], b0["values"]))
    loss_fn = jdp.make_loss_fn(model, SIGMA, 3, CAPS, ignore_index=0)
    with jax.enable_x64(True):
        p64, b64 = _f64(jax.tree.map(jnp.asarray, params)), _f64(jax.tree.map(jnp.asarray, batch))
        logp = jax.jit(model.apply)(p64, _f64(hj), b64["positions"][0], b64["values"][0])[0]
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64, b64, jax.random.PRNGKey(1))
        logp, loss, grads = np.asarray(logp), float(loss), jax.tree.map(np.asarray, grads)
    assert logp.dtype == np.float64
    return dict(prepared=prepared, batch=batch, params=params, logp=logp, loss=loss, hj=hj,
                grads=params_from_flax(grads), occupancy=[int(s.nr_verts) for s in hj.structures])  # fmt: skip


def _port_model(ref, dtype=torch.float32):
    m = tlnn.LNN(_model_params(tconfig), torch.Generator().manual_seed(0), device="cpu", conv_dtype=dtype)
    m = m.to(dtype)
    m.load_state_dict(params_from_flax(ref["params"]))
    return m


def _as(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_small_scannet_model_matches_jax(ref, dtype):
    """On JAX's hierarchy: its jitted build rounds the barycentric weights up
    to 2.3e-5 away from its eager build (XLA fuses the arithmetic), which the
    port's build equals bit for bit (``tests/test_torch_structure.py``), and
    this model moves a log-probability by 1e-2 for that."""
    from lattice_net_tpu_torch.interop import hierarchy_from_numpy
    from lattice_net_tpu_torch.lattice.structure import EdgeSort, build_hierarchy

    assert all(o < c for o, c in zip(ref["occupancy"], CAPS))
    model = _port_model(ref, dtype).eval()
    b = {k: torch.from_numpy(np.array(v[0])) for k, v in ref["batch"].items()}
    own = build_hierarchy(b["positions"], SIGMA, 3, CAPS, point_mask=b["point_mask"], point_feats=b["values"])
    assert [int(s.nr_verts) for s in own.structures] == ref["occupancy"]
    h = hierarchy_from_numpy(ref["hj"], device="cpu")
    np.testing.assert_array_equal(own.splat_idx.numpy(), h.splat_idx.numpy())
    np.testing.assert_allclose(own.splat_weights.numpy(), h.splat_weights.numpy(), rtol=0, atol=3e-5)
    # JAX's f32 build, its float tables in the model's dtype (as the reference)
    e = h.edges
    h = dataclasses.replace(h, splat_weights=h.splat_weights.to(dtype),
                            edges=EdgeSort(perm=e.perm, vertex=e.vertex, ends=e.ends, rows=e.rows.to(dtype)))  # fmt: skip
    with torch.inference_mode():
        logp, _ = model(h, _as(b["positions"], dtype), _as(b["values"], dtype))
    assert logp.dtype == dtype
    np.testing.assert_array_equal(logp.numpy().argmax(-1), ref["logp"].argmax(-1))
    atol = LOGP_ATOL if dtype == torch.float64 else F32_LOGP_ATOL
    np.testing.assert_allclose(logp.numpy(), ref["logp"], rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_small_scannet_train_step_matches_jax(ref, dtype):
    model = _port_model(ref, dtype)
    batch = tdp.make_batch([ref["prepared"]], N_POINTS, rng=np.random.default_rng(3), device="cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), ref["batch"][k])
    batch = {k: _as(v, dtype) for k, v in batch.items()}
    loss_fn = tdp.make_loss_fn(model, SIGMA, 3, CAPS, ignore_index=0)
    leaves, loss, _ = tdp.forward_loss(loss_fn, model.state_dict(), batch)
    grads = tdp.gradients(loss, leaves)
    assert abs(loss.item() - ref["loss"]) <= LOSS_ATOL
    assert set(grads) == set(ref["grads"])
    tol = GRAD_REL_L2 if dtype == torch.float64 else F32_GRAD_REL_L2
    for name, g in grads.items():
        want = ref["grads"][name].to(torch.float64)
        rel = float(torch.linalg.vector_norm(g.double() - want) / max(float(torch.linalg.vector_norm(want)), 1e-30))
        assert rel <= tol, (name, rel)


def test_full_width_parameters_match_jax():
    mp_t, mp_j = _model_params(tconfig, ()), _model_params(jconfig, ())
    model = tlnn.LNN(mp_t, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == SCANNET_PARAMS
    n = 256
    pos = jnp.asarray(jprobe.make_indoor_scene(n, seed=2)[0])
    vals = jnp.zeros((n, 4), jnp.float32)

    def init(p, v):
        h = jbuild(p, SIGMA, 3, (2048, 1024, 512, 256), point_feats=v)
        return jlnn.LNN(mp_j).init(jax.random.PRNGKey(0), h, p, v)

    shapes = jax.eval_shape(init, pos, vals)
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    want = {".".join(k.key for k in path): tuple(v.shape) for path, v in flat}
    assert sum(int(np.prod(s)) for s in want.values()) == SCANNET_PARAMS
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert dataclasses.asdict(mp_t) == {f.name: getattr(mp_j, f.name) for f in dataclasses.fields(mp_t)}


# ---------------------------------------------------------------------------
# ln_eval on a ScanNet-format directory from one JAX checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_runs(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    root = tsyn.write_scannet_dir(d / "scannet", nr_train=1, nr_test=2, n_points=2048, seed=6)
    ckpt = d / "jax.ckpt"
    jck.save_checkpoint(ckpt, jdp.TrainState.create(ref["params"], jo.make_optimizer(1e-3, 0.0, "none")))
    overrides = [f"loader_scannet.dataset_path={root}", "lattice_gpu.hash_table_capacity=16384", *SMALL_DEPTH]
    out = {}
    for budget in (0, 1024):
        for side in ("jax", "port"):
            o = d / f"{side}_{budget}"
            ov = overrides + [f"eval.output_predictions_path={o}"]
            if side == "jax":
                with pytest.MonkeyPatch.context() as m:
                    m.setattr(jsw, "build_and_init", lambda *a, **k: (ref["params"], 0))
                    miou = jev.run(str(EVAL_CFG), str(ckpt), True, ov, budget)
            else:
                miou = tev.run(EVAL_CFG, str(ckpt), True, ov, budget, device="cpu")
            out[side, budget] = (miou, o)
    return out


@pytest.mark.parametrize("budget", [0, 1024], ids=["whole", "two_chunks"])
def test_ln_eval_scannet_files_match_jax(eval_runs, budget):
    (jmiou, jdir), (tmiou, tdir) = eval_runs["jax", budget], eval_runs["port", budget]
    names = sorted(p.name for p in tdir.glob("*.txt"))
    assert names == sorted(p.name for p in jdir.glob("*.txt")) == ["scene0001_00.txt", "scene0002_00.txt"]
    for name in names:
        text = (tdir / name).read_bytes()
        assert text == (jdir / name).read_bytes()
        ids = np.loadtxt(tdir / name, dtype=np.int64)
        assert len(ids) == 2048 and set(ids.tolist()) <= {0, *tsn.VALID_CLASS_IDS}
    assert abs(tmiou - jmiou) <= 1e-4


def test_chunked_eval_differs_from_whole(eval_runs):
    whole, chunked = eval_runs["port", 0][1], eval_runs["port", 1024][1]
    assert (whole / "scene0001_00.txt").read_bytes() != (chunked / "scene0001_00.txt").read_bytes()
