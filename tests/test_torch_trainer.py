"""The port's training CLI (``train/ln_train.py``) and its callbacks vs the
JAX package's, on the CPU.

* ``apply_overrides``, ``batched_clouds`` (tail padding, ``chunk_oversized``,
  ``drop_last``), ``sanity_check``'s messages, ``Scores`` and
  ``StateCallback``'s mIoU, printed lines and CSV equal to JAX's;
  ``prefetch_batches`` keeps the order and raises its thread's exception.
* The options not ported raise ``NotImplementedError``: ``--dp``, ``--sp``,
  ``capacity_mode: "auto"``, the ScanNet and ShapeNet datasets.
* ``full_mask=True``: the loss and gradients of one 4096-point cloud with an
  all-true mask equal JAX's ``make_loss_fn(..., full_mask=True)`` (loss to
  1e-5, each gradient to a relative L2 of 1e-4, as ``test_torch_train.py``).
* The slice as a whole, on ``config/ln_train_toy.cfg`` (the toy dataset,
  which trains with ``reduce_on_plateau``): the JAX init saved by JAX as a
  step-0 checkpoint, then one epoch of JAX's ``ln_train.run`` and one of the
  port's ``run(device="cpu")``, each resumed from it.  The epoch's train
  and test losses agree to 1e-4 relative, the mIoUs to 1e-3, the two
  ``last.ckpt`` restore to parameters within 1e-4 relative L2 over all
  parameters (per tensor, Adam's normalisation of near-zero gradients moves
  a zero-initialised bias by up to ~1e-5 of its ~1e-2), with equal plateau
  counters, and both runs write the same checkpoint and CSV names.  The JAX
  run is one module-scoped fixture: one JAX trainer compile.
"""

import csv
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data.synth_kitti import make_scene20
from lattice_net_tpu.data.toy import ToyCloud as JToyCloud
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import callbacks as jcb
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import ln_train as jln
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu.train.setup_worker import build_and_init
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.train import callbacks as tcb
from lattice_net_tpu_torch.train import checkpoint as tck
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOY = ROOT / "config" / "ln_train_toy.cfg"
LOSS_RTOL, MIOU_ATOL, PARAM_REL_L2 = 1e-4, 1e-3, 1e-4
GRAD_REL_L2, LOSS_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize(
    "overrides",
    [["train.lr=0.003"], ["loader_toy.do_overfit=true", "model.pointnet_channels_per_layer=[4, 8]"],
     ["new.section.key=\"a b\"", "train.checkpoint_path=/tmp/x"], ["train.dataset_name="]],
)  # fmt: skip
def test_apply_overrides_matches(overrides):
    want = jconfig.apply_overrides(jconfig.load_config(TOY), overrides)
    assert tconfig.apply_overrides(tconfig.load_config(TOY), overrides) == want


@pytest.mark.parametrize("bad", ["train.lr", ".lr=1", "train.lr.x=1"])
def test_apply_overrides_refuses_like_jax(bad):
    with pytest.raises(jconfig.ConfigError) as want:
        jconfig.apply_overrides(jconfig.load_config(TOY), [bad])
    with pytest.raises(tconfig.ConfigError) as got:
        tconfig.apply_overrides(tconfig.load_config(TOY), [bad])
    assert str(got.value) == str(want.value)


class _Clouds:
    def __init__(self, sizes, seed=0):
        rng = np.random.default_rng(seed)
        self.clouds = [
            JToyCloud(V=rng.normal(size=(n, 3)).astype(np.float32), C=np.zeros((n, 3), np.float32),
                      I=rng.random((n, 1)).astype(np.float32),
                      L_gt=rng.integers(0, 4, (n, 1)).astype(np.int32))
            for n in sizes
        ]  # fmt: skip

    def __iter__(self):
        return iter(self.clouds)


@pytest.mark.parametrize("chunk", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batched_clouds_matches(chunk, drop_last):
    loader = _Clouds([50, 120, 32, 70, 10])
    jmp, tmp = jlnn.ModelParams(values_mode="intensity"), tlnn.ModelParams(values_mode="intensity")
    want = list(jln.batched_clouds(loader, jmp, 3, 32, drop_last, sigma=0.5, chunk_oversized=chunk))
    got = list(tln.batched_clouds(loader, tmp, 3, 32, drop_last, sigma=0.5, chunk_oversized=chunk))
    assert [r for _, r in got] == [r for _, r in want]
    for (gc, _), (wc, _) in zip(got, want):
        assert len(gc) == len(wc)
        for g, w in zip(gc, wc):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # the tail's padding clouds: masked by the trainer's host batch as by JAX's mask_dummy
    clouds, real = got[-1]
    host, _ = tln._host_batch((clouds, real), 256)
    jb = jdp.make_batch(clouds, jmp, 256, device=False)
    dummy = jb["target"][:, 0] == tln.DUMMY_TARGET
    np.testing.assert_array_equal(host["point_mask"], jb["point_mask"] & ~dummy[:, None])


def test_batched_clouds_checks_positions():
    loader = _Clouds([20])
    loader.clouds[0].V[3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        list(tln.batched_clouds(loader, tlnn.ModelParams(), 1, 32, False))


@pytest.mark.parametrize(
    "args", [(50, 1000, 2048), (5000, 1000, 8192), (1900, 4000, 2048), (99, 50, 100), (500, 600, 4096)]
)
def test_sanity_check_messages_match(args, capsys):
    for once_per_epoch in (False, True):
        seen = (set(), set()) if once_per_epoch else (None, None)
        for _ in range(2):
            jln.sanity_check(*args, seen=seen[0])
        want = capsys.readouterr().out
        for _ in range(2):
            tln.sanity_check(*args, seen=seen[1])
        assert capsys.readouterr().out == want


def test_prefetch_batches_keeps_order_and_raises():
    assert list(tln.prefetch_batches(iter(range(20)), lambda x: x * 2)) == list(range(0, 40, 2))

    def gen():
        yield 1
        raise KeyError("loader failed")

    with pytest.raises(KeyError, match="loader failed"):
        list(tln.prefetch_batches(gen(), lambda x: x))


def _feed(mod, nr_classes, counts, capsys, tmp_path):
    phase = mod.Phase("test", None, grad=False)
    cb = mod.StateCallback(nr_classes)
    cb.epoch_started(phase=phase)
    for loss, (inter, union) in counts:
        cb.after_forward_pass(phase=phase, loss=loss, inter=inter, union=union)
    miou = phase.scores.avg_class_iou(print_per_class=True)
    best = phase.scores.update_best(3)
    phase.scores.write_iou_to_csv(tmp_path / f"{mod.__name__}.csv")
    cb.epoch_ended(phase=phase)
    with open(tmp_path / f"{mod.__name__}.csv") as f:
        rows = list(csv.reader(f))
    return miou, best, phase.epoch_nr, capsys.readouterr().out, rows


def test_scores_and_state_callback_match(capsys, tmp_path):
    rng = np.random.default_rng(8)
    counts = []
    for _ in range(4):
        union = rng.integers(0, 50, 6)
        union[2] = 0  # a class absent from this sample
        counts.append((float(rng.random()), (rng.integers(0, 1 + union), union)))
    counts[1][1][1][4] = 0
    want = _feed(jcb, 6, counts, capsys, tmp_path)
    got = _feed(tcb, 6, counts, capsys, tmp_path)
    assert got == want
    p, t = rng.integers(0, 5, 300), rng.integers(-1, 5, 300)
    for a, b in zip(tcb.iou_counts(p, t, 5), jcb.iou_counts(p, t, 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "kw, override",
    [(dict(dp=True), None), (dict(sp=2), None), ({}, "lattice_gpu.capacity_mode=auto"),
     ({}, "train.dataset_name=scannet"), ({}, "train.dataset_name=shapenet")],
)  # fmt: skip
def test_unported_options_raise(kw, override, tmp_path):
    overrides = [f"train.checkpoint_path={tmp_path}"] + ([override] if override else [])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        tln.run(TOY, max_epochs=1, overrides=overrides, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown dataset"):
        tln.create_loader("kitti360", {}, "train")


def test_run_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError):
        tln.run(TOY, max_epochs=1, overrides=[f"train.checkpoint_path={tmp_path}"])


# ---------------------------------------------------------------------------
# full_mask: the mask-free build, against JAX's
# ---------------------------------------------------------------------------

MODEL = dict(
    nr_classes=20, values_mode="intensity", pointnet_channels_per_layer=(8, 16),
    pointnet_start_nr_channels=16, nr_downsamples=2, nr_blocks_down_stage=(1, 1),
    nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1), nr_levels_down_with_normal_resnet=3,
    nr_levels_up_with_normal_resnet=3,
)  # fmt: skip
N_POINTS, CAPS, SIGMA = 4096, (8192, 4096, 2048), 0.6


def test_full_mask_loss_and_gradients_match_jax():
    cloud = jlnn.prepare_cloud(make_scene20(N_POINTS, seed=2), jlnn.ModelParams(**MODEL))
    batch = jdp.make_batch([cloud], None, N_POINTS, rng=np.random.default_rng(0))
    assert bool(np.asarray(batch["point_mask"]).all())
    model = jlnn.LNN(jlnn.ModelParams(**MODEL))
    b0 = {k: v[0] for k, v in batch.items()}
    hj = jax.jit(lambda p, m, v: jbuild(p, SIGMA, 2, CAPS, point_mask=m, point_feats=v))(
        b0["positions"], b0["point_mask"], b0["values"])  # fmt: skip
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, b0["positions"], b0["values"])
    weights = jlnn.compute_class_weights(np.full(20, 0.05), 0)
    jloss_fn = jdp.make_loss_fn(model, SIGMA, 2, CAPS, 0, weights, full_mask=True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True), static_argnums=3)(
        params, batch, jax.random.PRNGKey(1), False)  # fmt: skip

    tmodel = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
                      conv_dtype=torch.float32)  # fmt: skip
    tparams = params_from_flax(params)
    tbatch = tdp.make_batch([cloud], N_POINTS, rng=np.random.default_rng(0), device="cpu")
    tweights = tlnn.compute_class_weights(np.full(20, 0.05), 0)
    tloss_fn = tdp.make_loss_fn(tmodel, SIGMA, 2, CAPS, 0, tweights, full_mask=True)
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, _ = tloss_fn(leaves, tbatch, None, train=False)
    grads = tdp.gradients(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= LOSS_ATOL
    for k, want in params_from_flax(jgrads).items():
        err = torch.linalg.norm(grads[k] - want) / max(float(torch.linalg.norm(want)), 1e-30)
        assert err <= GRAD_REL_L2, (k, float(err))
    # the mask still applies in the loss: masking half the points moves it
    tbatch["point_mask"][0, ::2] = False
    assert abs(tloss_fn(tparams, tbatch, None, train=False)[0].item() - loss.item()) > 1e-3


# ---------------------------------------------------------------------------
# the slice as a whole: one epoch of each trainer from one JAX checkpoint
# ---------------------------------------------------------------------------


def _recording(mod, records):
    """``mod.StateCallback.epoch_ended`` that also records (phase, loss, mIoU)."""
    orig = mod.StateCallback.epoch_ended

    def epoch_ended(self, phase=None, **kw):
        n = max(phase.samples_processed_this_epoch, 1)
        records.append((phase.name, phase.loss_acum_per_epoch / n, phase.scores.avg_class_iou()))
        orig(self, phase=phase, **kw)

    return epoch_ended


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy_runs")
    cfg = jconfig.load_config(TOY)
    tp, lp = jconfig.TrainParams.from_config(cfg), jconfig.LatticeParams.from_config(cfg)
    loader = jln.create_loader("toy", cfg, "train")
    mp = jconfig.model_params_from_config(cfg, loader.nr_classes)
    steps = len(loader)
    tx = jo.make_optimizer(tp.lr, tp.weight_decay, "reduce_on_plateau", t0_steps=3 * steps,
                           plateau_accumulation=steps)  # fmt: skip
    # the JAX trainer's own init, saved by JAX as a step-0 checkpoint
    b0 = jdp.make_batch([jlnn.prepare_cloud(loader.get_cloud(0), mp)], mp, 1024, device=False)
    caps = (lp.hash_table_capacity, lp.hash_table_capacity // 2, lp.hash_table_capacity // 4)
    params, _ = build_and_init(mp, lp.sigmas[0], caps, b0["positions"][0], b0["point_mask"][0],
                               b0["values"][0])  # fmt: skip
    jck.save_checkpoint(d / "init.ckpt", jdp.TrainState.create(params, tx))
    records = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jcb.StateCallback, "epoch_ended", _recording(jcb, records["jax"]))
        m.setattr(tcb.StateCallback, "epoch_ended", _recording(tcb, records["port"]))
        jstate = jln.run(TOY, max_epochs=1, resume=str(d / "init.ckpt"),
                         overrides=[f"train.checkpoint_path={d / 'jax'}"])  # fmt: skip
        tstate = tln.run(TOY, max_epochs=1, resume=str(d / "init.ckpt"),
                         overrides=[f"train.checkpoint_path={d / 'port'}"], device="cpu")  # fmt: skip
    return dict(dir=d, records=records, jstate=jstate, tstate=tstate, steps=steps)


def test_slice_epoch_losses_and_miou_match(toy_runs):
    jr, tr = toy_runs["records"]["jax"], toy_runs["records"]["port"]
    assert [r[0] for r in tr] == [r[0] for r in jr] == ["train", "test"]
    for (name, tloss, tmiou), (_, jloss, jmiou) in zip(tr, jr):
        assert np.isfinite(tloss)
        assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (name, tloss, jloss)
        assert abs(tmiou - jmiou) <= MIOU_ATOL, (name, tmiou, jmiou)


def test_slice_final_checkpoints_match(toy_runs):
    d, steps = toy_runs["dir"], toy_runs["steps"]
    jraw = serialization.msgpack_restore((d / "jax" / "last.ckpt").read_bytes())
    want = params_from_flax(jraw["params"])
    got = tck.load_params(d / "port" / "last.ckpt", want)
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    assert np.sqrt(num / den) <= PARAM_REL_L2
    # the port's in-memory final state is the one it saved
    assert toy_runs["tstate"].step == int(toy_runs["jstate"].step) == steps
    assert all(torch.equal(toy_runs["tstate"].params[k], got[k]) for k in got)
    # the plateau state: the epoch's mean loss became the best value
    tplat = tck._msgpack.unpackb((d / "port" / "last.ckpt").read_bytes())["opt_state"]["1"]
    jplat = jraw["opt_state"]["1"]
    for k in ("plateau_count", "cooldown_count", "count", "scale"):
        assert tplat[k].dtype == jplat[k].dtype and tplat[k] == jplat[k], k
    np.testing.assert_allclose(tplat["best_value"], jplat["best_value"], rtol=LOSS_RTOL)
    assert sorted(p.name for p in (d / "port").iterdir()) == sorted(p.name for p in (d / "jax").iterdir())


def test_slice_port_checkpoint_resumes_in_jax(toy_runs):
    d = toy_runs["dir"]
    restored = jck.load_checkpoint(d / "port" / "last.ckpt", toy_runs["jstate"])
    assert int(restored.step) == toy_runs["steps"]
    tparams = toy_runs["tstate"].params
    for k, v in params_from_flax(restored.params).items():
        torch.testing.assert_close(v, tparams[k], rtol=0, atol=0)
    assert jax.tree.structure(restored) == jax.tree.structure(toy_runs["jstate"])
    assert all(np.asarray(a).dtype == np.asarray(b).dtype
               for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(toy_runs["jstate"])))  # fmt: skip
