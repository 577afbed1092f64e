"""The port's eval tools vs the JAX package's, on the CPU.

* ``predict_cloud_chunked``: a fake predictor sees chunks of 256, 256 and
  188 points of a 700-point cloud, stitched in order; with the real model
  of ``config/lnn_eval_semantic_kitti.cfg`` (capacity 4096) and the weights
  of one checkpoint that JAX wrote, the labels equal JAX's and each chunk's
  log-probabilities agree to 1e-4.
* ``ln_eval.run`` of both packages on one KITTI-format directory (two
  2048-point test scans) from that checkpoint, whole and with a 1024-point
  budget (2 chunks a scan): byte-equal ``.label`` files at
  ``sequences/11/predictions/<scan>.label``, mIoU within 1e-4.  The JAX
  side runs with its native reader off, so that it reads the scans in
  order with their names.
* The JAX native reader's fault: its clouds carry no name, so JAX's eval
  would name its outputs by arrival order; the port's eval reads by index.
* ``unstripe_predictions``, ``prepare_submission`` (the zip and both
  refusals), the PLY writers and the comparison tool against JAX's.
* ``ln_eval_stream``: ``_encode`` byte-equal to JAX's for the three wires,
  the decode within JAX's own tolerances
  (``tests/test_train_tools.py::test_stream_wire_formats_roundtrip``), and
  ``run(device="cpu")`` on ``config/ln_eval_stream.cfg`` with 4 scans of
  2048 points: 4 finite latencies, the three measurements printed, and the
  f32 wire's labels equal to ``Predictor.predict``'s.

The JAX package's init is built once (its ``build_and_init`` is cached for
the JAX eval runs, which load the checkpoint over it): three JAX forward
compiles in all.
"""

import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lattice_net_tpu.data import native_loader as jnl
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.misc import lnn_compare_semantic_kitti as jcmp
from lattice_net_tpu.misc import prepare_submission_semantickitti as jsub
from lattice_net_tpu.misc import viz as jviz
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import ln_eval as jev
from lattice_net_tpu.train import ln_eval_stream as jes
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu.train import setup_worker as jsw
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import semantic_kitti as tskt
from lattice_net_tpu_torch.data.synth_kitti import write_kitti_dir
from lattice_net_tpu_torch.misc import lnn_compare_semantic_kitti as tcmp
from lattice_net_tpu_torch.misc import lnn_eval_single_cloud as tsingle
from lattice_net_tpu_torch.misc import prepare_submission_semantickitti as tsub
from lattice_net_tpu_torch.misc import viz as tviz
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.serve import Predictor
from lattice_net_tpu_torch.train import ln_eval as tev
from lattice_net_tpu_torch.train import ln_eval_stream as tes

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EVAL_CFG = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
STREAM_CFG = ROOT / "config" / "ln_eval_stream.cfg"
N_POINTS, CHUNK, CAPACITY = 2048, 1024, 4096
LOGP_ATOL, MIOU_ATOL = 1e-4, 1e-4


def test_predict_cloud_chunked_covers_all_points():
    n, n_points = 700, 256  # 3 chunks: 256 + 256 + 188
    rng = np.random.default_rng(0)
    positions = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    values = np.zeros((n, 1), np.float32)
    calls = []

    def fake_predict(p, v):
        calls.append(len(p))
        return (p[:, 0] > 0).astype(np.int64)  # a function of the position: the order shows

    pred = tev.predict_cloud_chunked(fake_predict, (positions, values, None), n_points)
    assert pred.shape == (n,) and pred.dtype == np.int32
    assert calls == [256, 256, n - 512]
    np.testing.assert_array_equal(pred, (positions[:, 0] > 0).astype(np.int32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A KITTI-format directory, the JAX init of the eval config's model
    saved by JAX as a checkpoint, and the JAX predictor's pieces."""
    d = tmp_path_factory.mktemp("eval")
    kitti = write_kitti_dir(d / "kitti", nr_train=1, nr_test=2, n_points=N_POINTS, seed=3, classes=20)
    overrides = [f"loader_semantic_kitti.dataset_path={kitti}", f"lattice_gpu.hash_table_capacity={CAPACITY}"]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnl, "native_available", lambda: False)
        js = jev.setup_predictor(str(EVAL_CFG), "", overrides + ["eval.checkpoint_path="])
    ckpt = d / "jax.ckpt"
    jck.save_checkpoint(ckpt, jdp.TrainState.create(js.params, jo.make_optimizer(1e-3, 0.0, "none")))

    def logp_impl(params, batch):
        b = {k: v[0] for k, v in batch.items()}
        h = jbuild(b["positions"], js.sigma, js.mp.nr_downsamples, js.caps, point_mask=b["point_mask"],
                   point_feats=b["values"])  # fmt: skip
        return js.model.apply(params, h, b["positions"], b["values"])[0]

    return dict(dir=d, kitti=kitti, ckpt=ckpt, overrides=overrides, js=js, jlogp=jax.jit(logp_impl))


def test_predict_cloud_chunked_matches_jax(setup):
    js = setup["js"]
    cfg = tconfig.apply_overrides(tconfig.load_config(EVAL_CFG), setup["overrides"])
    pred = Predictor.from_config(cfg, 20, "cpu", torch.float32, n_points=CHUNK, checkpoint=setup["ckpt"])
    cloud = tskt.SemanticKitti(setup["kitti"], mode="test", cap_distance=-1).get_cloud(0)
    prepared = tlnn.prepare_cloud(cloud, pred.params)
    got = tev.predict_cloud_chunked(pred.predict, prepared, CHUNK)

    def jpredict(batch):
        return np.argmax(np.asarray(setup["jlogp"](js.params, batch)), -1)

    want = jev.predict_cloud_chunked(jpredict, prepared, CHUNK, js.mp)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3  # the random weights still label several classes
    for start in (0, CHUNK):
        chunk = tuple(a[start:start + CHUNK] for a in prepared)
        logp, _ = pred.forward(chunk[0], chunk[1])
        jl = np.asarray(setup["jlogp"](js.params, jdp.make_batch([chunk], js.mp, CHUNK)))
        np.testing.assert_allclose(logp.numpy(), jl, atol=LOGP_ATOL, rtol=0)


def _cached_build_and_init(js):
    def build_and_init(*args, **kwargs):
        return js.params, 0

    return build_and_init


@pytest.fixture(scope="module")
def eval_runs(setup):
    """``ln_eval.run`` of both packages, whole and at a 1024-point budget."""
    out = {}
    for budget in (0, CHUNK):
        for side in ("jax", "port"):
            d = setup["dir"] / f"{side}_{budget}"
            overrides = setup["overrides"] + [f"eval.output_predictions_path={d}"]
            if side == "jax":
                with pytest.MonkeyPatch.context() as m:
                    m.setattr(jnl, "native_available", lambda: False)
                    m.setattr(jsw, "build_and_init", _cached_build_and_init(setup["js"]))
                    miou = jev.run(str(EVAL_CFG), str(setup["ckpt"]), True, overrides, budget)
            else:
                miou = tev.run(EVAL_CFG, str(setup["ckpt"]), True, overrides, budget, device="cpu")
            out[side, budget] = (miou, d)
    return out


@pytest.mark.parametrize("budget", [0, CHUNK])
def test_ln_eval_run_matches_jax(setup, eval_runs, budget):
    (jmiou, jdir), (tmiou, tdir) = eval_runs["jax", budget], eval_runs["port", budget]
    assert abs(tmiou - jmiou) <= MIOU_ATOL
    got, want = sorted(p.relative_to(tdir) for p in tdir.rglob("*.label")), sorted(
        p.relative_to(jdir) for p in jdir.rglob("*.label"))  # fmt: skip
    assert [str(p) for p in got] == [f"sequences/11/predictions/{i:06d}.label" for i in (1, 2)]
    assert got == want
    for rel in got:
        labels = np.fromfile(tdir / rel, np.uint32)
        assert len(labels) == N_POINTS
        assert set(labels.tolist()) <= set(tskt.LEARNING_MAP_INV.values())
        assert (tdir / rel).read_bytes() == (jdir / rel).read_bytes()


def test_chunked_eval_differs_from_whole(eval_runs):
    """The two budgets label the scans differently (each chunk's receptive
    field ends at its bound), so the byte-equality above holds each."""
    whole, chunked = eval_runs["port", 0][1], eval_runs["port", CHUNK][1]
    rel = Path("sequences/11/predictions/000001.label")
    assert (whole / rel).read_bytes() != (chunked / rel).read_bytes()


def test_jax_native_reader_loses_scan_names(setup, eval_runs):
    if not jnl.native_available():
        pytest.skip("the JAX package's native reader does not build here")
    from lattice_net_tpu.data.semantic_kitti import SemanticKitti

    ds = SemanticKitti(setup["kitti"], mode="test", cap_distance=-1, max_nr_points_per_cloud=100000000)
    names = [c.name for c in ds]
    assert names == ["", ""]  # JAX's eval would write <out>/000000.label, <out>/000001.label
    assert [ds.get_cloud(i).name for i in range(2)] == ["11/000001", "11/000002"]
    tdir = eval_runs["port", 0][1]
    assert sorted(p.name for p in (tdir / "sequences" / "11" / "predictions").iterdir()) == [
        "000001.label", "000002.label"]  # fmt: skip
    assert not list(tdir.glob("*.label"))


def test_sp_raises(setup):
    # --sp is ported (tests/test_torch_dp.py); on the CPU only gloo runs
    with pytest.raises(ValueError, match="only gloo runs there"):
        tev.run(EVAL_CFG, str(setup["ckpt"]), False, setup["overrides"], sp=2, device="cpu", backend="nccl")


def test_unstripe_predictions_matches_jax():
    rng = np.random.default_rng(1)
    n, shards, per = 50, 3, 20
    ids = np.full(shards * per, -1)
    ids[rng.permutation(shards * per)[:n]] = np.arange(n)
    lab = rng.integers(0, 20, shards * per)
    got = tev.unstripe_predictions(lab.reshape(shards, per), ids.reshape(shards, per), n)
    want = jev.unstripe_predictions(lab.reshape(shards, per), ids.reshape(shards, per), n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_prepare_submission_matches_jax(setup, eval_runs, tmp_path, monkeypatch, capsys):
    preds = eval_runs["port", 0][1]
    monkeypatch.setattr(sys, "argv", ["prep", "--predictions", str(preds), "--dataset", str(setup["kitti"]),
                                      "--out", str(tmp_path / "jax.zip")])  # fmt: skip
    jsub.main()
    want = capsys.readouterr().out
    assert tsub.prepare_submission(preds, setup["kitti"], tmp_path / "port.zip") == (2, 2)
    assert capsys.readouterr().out == want.replace("jax.zip", "port.zip")
    with zipfile.ZipFile(tmp_path / "jax.zip") as j, zipfile.ZipFile(tmp_path / "port.zip") as t:
        assert t.namelist() == j.namelist() == [f"sequences/11/predictions/{i:06d}.label" for i in (1, 2)]
        assert all(t.read(n) == j.read(n) for n in t.namelist())
    # a label count that is not the scan's, and an id the server does not take
    bad = tmp_path / "bad" / "sequences" / "11" / "predictions"
    bad.mkdir(parents=True)
    np.full(N_POINTS - 1, 40, np.uint32).tofile(bad / "000001.label")
    with pytest.raises(ValueError, match="labels but scan has"):
        tsub.prepare_submission(tmp_path / "bad", setup["kitti"], tmp_path / "b.zip")
    np.full(N_POINTS, 41, np.uint32).tofile(bad / "000001.label")
    with pytest.raises(ValueError, match="non-submittable"):
        tsub.prepare_submission(tmp_path / "bad", "", tmp_path / "b.zip")


def test_viz_and_compare_match_jax(setup, eval_runs, tmp_path, capsys):
    rng = np.random.default_rng(2)
    xyz, pred = rng.normal(size=(300, 3)).astype(np.float32), rng.integers(0, 20, 300)
    target, logp = rng.integers(-1, 20, 300), np.log(rng.dirichlet(np.ones(20), 300))
    for mod, side in ((tviz, "port"), (jviz, "jax")):
        mod.prediction_cloud(tmp_path / side / "p.ply", xyz, pred, 20)
        mod.diff_cloud(tmp_path / side / "d.ply", xyz, pred, target, -1)
        mod.confidence_cloud(tmp_path / side / "c.ply", xyz, logp)
        mod.pca_feature_cloud(tmp_path / side / "f.ply", xyz, logp)
    for name in ("p", "d", "c", "f"):
        got, want = (tmp_path / side / f"{name}.ply" for side in ("port", "jax"))
        assert got.read_bytes() == want.read_bytes(), name
    with pytest.raises(ValueError, match="write_ply"):
        tviz.write_ply(tmp_path / "x.ply", xyz, np.zeros((299, 3)))
    # the comparison tool on the two budgets' predictions of one scan
    scan = Path(setup["kitti"]) / "sequences" / "11" / "velodyne" / "000001.bin"
    rel = Path("sequences/11/predictions/000001.label")
    a, b = eval_runs["port", 0][1] / rel, eval_runs["port", CHUNK][1] / rel
    args = [str(scan), str(tskt.label_path(scan)), str(a), str(b)]
    got = tcmp.compare(*args, out=tmp_path / "cmp_port")
    text = capsys.readouterr().out
    sys_argv = ["cmp", "--scan", args[0], "--gt", args[1], "--pred-a", args[2], "--pred-b", args[3], "-o",
                str(tmp_path / "cmp_jax")]  # fmt: skip
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", sys_argv)
        jcmp.main()
    assert capsys.readouterr().out == text.replace("cmp_port", "cmp_jax")
    assert 0 < got["agreement"] < 1
    for f in ("pred_a", "pred_b", "diff_a", "diff_b", "disagreement"):
        got, want = (tmp_path / side / f"{f}.ply" for side in ("cmp_port", "cmp_jax"))
        assert got.read_bytes() == want.read_bytes(), f


def test_eval_single_cloud(setup, tmp_path, capsys):
    scan = Path(setup["kitti"]) / "sequences" / "11" / "velodyne" / "000002.bin"
    cfg = tconfig.apply_overrides(tconfig.load_config(EVAL_CFG), setup["overrides"])
    pred = tsingle.evaluate(cfg, scan, str(setup["ckpt"]), out=tmp_path, device="cpu")
    assert pred.shape == (N_POINTS,)
    # the whole cloud fits one 2048-point budget: the labels are ln_eval's whole-scan labels
    p = Predictor.from_config(cfg, 20, "cpu", torch.float32, n_points=N_POINTS, checkpoint=setup["ckpt"])
    raw = np.fromfile(scan, np.float32).reshape(-1, 4)
    np.testing.assert_array_equal(pred, p.predict(raw[:, :3], np.zeros((N_POINTS, 1), np.float32)))
    assert {f.name for f in tmp_path.iterdir()} == {"prediction.ply", "confidence.ply"}
    assert f"restored {setup['ckpt']}" in capsys.readouterr().out


@pytest.mark.parametrize("wire", ["f32", "f16", "i16"])
def test_stream_encode_byte_equal_and_decode(wire):
    rng = np.random.default_rng(0)
    n_points, d, n_valid = 256, 3, 200
    pos = np.zeros((n_points, d), np.float32)
    pos[:n_valid] = rng.uniform(-60, 60, (n_valid, d))
    val = np.zeros((n_points, 1), np.float32)
    val[:n_valid] = rng.uniform(0, 1, (n_valid, 1))
    npb = {"positions": pos, "values": val, "n_valid": np.int32(n_valid)}
    got, want = tes._encode(npb, wire), jes._encode(npb, wire)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    # JAX's own tolerances: exact for f32, half an f16 ulp, one i16 quantum
    ptol, vtol = {"f32": (0.0, 0.0), "f16": (0.05, 1e-3), "i16": (61.0 / 32767, 61.0 / 32767)}[wire]
    fused = torch.from_numpy(got["fused"])
    p, v, mask = tes._decode(fused, int(got["n_valid"]), float(got["scale"]), d, wire)
    np.testing.assert_allclose(p.numpy(), pos, atol=max(ptol, 1e-7))
    np.testing.assert_allclose(v.numpy(), val, atol=max(vtol, 1e-7))
    assert mask[:n_valid].all() and not mask[n_valid:].any()
    # the same values as JAX's decode
    fn = jes._make_decode_predict(lambda params, batch: batch, d, n_points, wire)
    jb = fn(None, {k: jax.numpy.asarray(x) for k, x in want.items()})
    np.testing.assert_array_equal(p.numpy(), np.asarray(jb["positions"][0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jb["point_mask"][0]))


def test_stream_run_on_cpu(capsys):
    overrides = ["loader_synth_kitti.nr_samples=2", f"loader_synth_kitti.n_points={N_POINTS}",
                 f"lattice_gpu.hash_table_capacity={CAPACITY}", "eval.checkpoint_path="]  # fmt: skip
    res = tes.run(STREAM_CFG, rate_hz=1000.0, nr_scans=4, overrides=overrides, wire="f32", device="cpu")
    assert len(res.latency_ms) == 4 and np.isfinite(res.latency_ms).all()
    out = capsys.readouterr().out
    assert "no checkpoint: seeded random weights" in out
    for row in ("compute-only latency", "H2D per scan", "end-to-end latency"):
        assert row in out
    s = tev.setup_predictor(STREAM_CFG, "", overrides, device="cpu")
    mp = s.predictor.params
    for k, labels in enumerate(res.labels):
        b = tes._prep_np(s.loader.get_cloud(k % 2), mp, s.n_points)
        n = int(b["n_valid"])
        np.testing.assert_array_equal(labels, s.predictor.predict(b["positions"][:n], b["values"][:n]))


def test_jax_stream_times_a_scan_when_the_next_arrives():
    """The JAX harness reads a scan's latency one scan behind, after the
    next arrival, so at 0.5 Hz the first of two scans shows about a whole
    period (less the next arrival's lateness); the port stamps each scan
    when its labels are ready, a forward of well under a second here."""
    overrides = ["loader_synth_kitti.nr_samples=2", f"loader_synth_kitti.n_points={N_POINTS}",
                 f"lattice_gpu.hash_table_capacity={CAPACITY}", "eval.checkpoint_path="]  # fmt: skip
    period_ms = 2000.0
    jlat = jes.run(str(STREAM_CFG), rate_hz=1e3 / period_ms, nr_scans=2, overrides=overrides, wire="f32")
    tlat = tes.run(STREAM_CFG, rate_hz=1e3 / period_ms, nr_scans=2, overrides=overrides, wire="f32",
                   device="cpu").latency_ms  # fmt: skip
    assert jlat[0] >= 0.9 * period_ms and jlat[1] < 0.9 * period_ms
    assert (tlat < 0.9 * period_ms).all()


def test_stream_failure_stops_the_transfer_thread(monkeypatch):
    """A forward that raises mid-stream ends the run with that error, and
    the transfer thread ends too instead of blocking on its full queue."""
    import threading

    overrides = ["loader_synth_kitti.nr_samples=1", "loader_synth_kitti.n_points=512",
                 f"lattice_gpu.hash_table_capacity={CAPACITY}", "eval.checkpoint_path="]  # fmt: skip
    calls, orig = [0], Predictor.forward_padded

    def failing(self, *args, **kw):
        calls[0] += 1
        if calls[0] == 1 + tes.COMPUTE_ITERS + 2:  # warm-up, timing, then the stream's second scan
            raise RuntimeError("planted forward failure")
        return orig(self, *args, **kw)

    monkeypatch.setattr(Predictor, "forward_padded", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="planted forward failure"):
        tes.run(STREAM_CFG, rate_hz=100.0, nr_scans=8, overrides=overrides, wire="f16", device="cpu")
    assert threading.active_count() == before
