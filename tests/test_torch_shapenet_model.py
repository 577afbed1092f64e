"""The ShapeNet model's block plan, its batch-4 train loss and ``ln_eval``'s
ShapeNet files vs the JAX package, in f32 on the CPU.

The model is ``config/ln_train_shapenet_example.cfg``'s plan at narrow
width: 3 downsamples, one block a stage, and ``nr_levels_up_with_normal_resnet:
2``, so the first up stage holds a ``BottleneckBlock`` (the config's
``BottleneckBlock_k`` numbers run across the bottleneck stage and then that
up stage).  The JAX init comes from JAX's own ``ln_eval.setup_predictor`` on
``config/lnn_eval_shapenet.cfg`` with the same overrides, and JAX saves it
as the checkpoint both evals restore.

* ``params_from_flax`` maps the plan one to one (strict load), and the
  port's own init draws each tensor from flax's distribution.
* A batch of four slots (three procedural motorbikes, one over the 512-point
  budget and subsampled through the batch generator, and one tail-padding
  slot, the first cloud with every target ``DUMMY_TARGET`` and its point
  mask cleared, as the trainer pads): the host batch equals JAX's
  ``make_batch`` from the same generator; the loss (the mean over all four
  slots, the padded one included, as JAX's ``jnp.mean(losses)``) to 1e-5,
  the metrics' counts exactly and their means to 1e-6, and every gradient
  to a relative L2 of 1e-4, against JAX's vmapped ``loss_fn``; no ignore
  index, as the trainer runs ShapeNet (its loader has none).  The padded
  slot alone gives a finite loss and finite gradients.
* ``ln_eval.run`` of both packages over the test split, JAX's with its
  native reader off (its native clouds carry no name:
  ``tests/test_torch_shapenet.py::test_jax_shapenet_native_reader_loses_names``):
  the same ``pred_<stem>.txt`` files byte for byte and the same mIoU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data import native_loader as jnl
from lattice_net_tpu.data.synth_shapenet import make_motorbike
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import ln_eval as jev
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu.train import setup_worker as jsw
from lattice_net_tpu_torch.data.synth_shapenet import write_benchmark_dir
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.train import ln_eval as tev
from lattice_net_tpu_torch.train import ln_train as tln

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EVAL_CFG = ROOT / "config" / "lnn_eval_shapenet.cfg"
LOSS_ATOL, GRAD_REL_L2, MEAN_ATOL, MIOU_ATOL = 1e-5, 1e-4, 1e-6, 1e-4
N_POINTS = 512
NARROW = [
    "model.pointnet_channels_per_layer=[8, 16]", "model.pointnet_start_nr_channels=16",
    "model.nr_blocks_down_stage=[1, 1, 1]", "model.nr_blocks_bottleneck=1",
    "model.nr_blocks_up_stage=[1, 1, 1]", "lattice_gpu.hash_table_capacity=2048",
]  # fmt: skip


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A benchmark directory (3 train, 2 test motorbikes of 450 points), the
    JAX predictor setup of the narrow eval config and its init saved by JAX."""
    d = tmp_path_factory.mktemp("shapenet_model")
    root = write_benchmark_dir(d / "shapenet", nr_train=3, nr_test=2, n_points=450, seed=4)
    overrides = [f"loader_shapenet_partseg.dataset_path={root}", *NARROW]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnl, "native_available", lambda: False)
        js = jev.setup_predictor(str(EVAL_CFG), "", overrides + ["eval.checkpoint_path="])
    ckpt = d / "jax.ckpt"
    jck.save_checkpoint(ckpt, jdp.TrainState.create(js.params, jo.make_optimizer(1e-3, 0.0, "none")))
    return dict(dir=d, root=root, overrides=overrides, js=js, ckpt=ckpt)


def _port_model(js):
    mp = tlnn.ModelParams(**{f: getattr(js.mp, f) for f in tlnn.ModelParams.__dataclass_fields__})
    model = tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    model.load_state_dict(params_from_flax(js.params))  # strict: every name and shape
    return model


def test_params_from_flax_maps_the_shapenet_plan(ref):
    js = ref["js"]
    assert (js.mp.nr_downsamples, js.mp.nr_levels_up_with_normal_resnet, js.caps) == (3, 2, (2048, 1024, 512, 256))
    model = _port_model(js)
    tree = js.params["params"]
    blocks = sorted(k for k in tree if k.startswith(("ResnetBlock", "BottleneckBlock")))
    assert blocks == ["BottleneckBlock_0", "BottleneckBlock_1"] + [f"ResnetBlock_{i}" for i in range(5)]
    # down stages ResnetBlock_0-2, the bottleneck stage BottleneckBlock_0, then
    # the up stages: BottleneckBlock_1 (the coarsest), ResnetBlock_3 and _4
    assert model._bottleneck == ["BottleneckBlock_0"]
    assert model._up == [["BottleneckBlock_1"], ["ResnetBlock_3"], ["ResnetBlock_4"]]
    n_jax = sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(js.params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_port_init_follows_the_flax_init(ref):
    """The port draws its own weights (a torch seed): each tensor's
    distribution must be flax's, block by block, so that a run from either
    init learns alike (constants equal, spreads within 25%)."""
    js = ref["js"]
    want = params_from_flax(js.params)
    mp = tlnn.ModelParams(**{f: getattr(js.mp, f) for f in tlnn.ModelParams.__dataclass_fields__})
    got = tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32).state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        a, b = w.numpy(), got[k].numpy()
        if a.std() == 0:
            np.testing.assert_array_equal(b, a, err_msg=k)
        elif a.size >= 64:
            assert 0.8 < b.std() / a.std() < 1.25, (k, a.std(), b.std())
            assert abs(b.mean() - a.mean()) < 0.2 * a.std(), (k, a.mean(), b.mean())


def _clouds():
    out = []
    for n, seed in ((450, 0), (600, 1), (500, 2)):
        v, l = make_motorbike(n, seed=seed)
        out.append((v, np.zeros((n, 1), np.float32), l.reshape(-1)))
    p, v, t = out[0]
    out.append((p, v, np.full_like(t, tln.DUMMY_TARGET)))  # the trainer's tail padding
    return out


def _host_batch(make):
    batch = make(_clouds())
    dummy = batch["target"][:, 0] == tln.DUMMY_TARGET
    batch["point_mask"] = batch["point_mask"] & ~dummy[:, None]
    return batch


@pytest.fixture(scope="module")
def batch4(ref):
    js = ref["js"]
    jb = _host_batch(lambda c: jdp.make_batch(c, js.mp, N_POINTS, rng=np.random.default_rng(5), device=False))
    tb = _host_batch(lambda c: tdp.make_host_batch(c, N_POINTS, rng=np.random.default_rng(5)))
    loss_fn = jdp.make_loss_fn(js.model, js.sigma, js.mp.nr_downsamples, js.caps, ignore_index=-1)
    vg = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, jax.random.PRNGKey(0), True), has_aux=True))
    (jloss, jmetrics), jgrads = vg(js.params, {k: jnp.asarray(v) for k, v in jb.items()})
    model = _port_model(js)
    tloss_fn = tdp.make_loss_fn(model, js.sigma, js.mp.nr_downsamples, js.caps, ignore_index=-1)
    leaves, tloss, tmetrics = tdp.forward_loss(tloss_fn, model.state_dict(), tdp.to_device(tb, "cpu"))
    tgrads = tdp.gradients(tloss, leaves)
    return dict(jb=jb, tb=tb, jloss=jloss, jmetrics=jmetrics, jgrads=params_from_flax(jgrads),
                tloss=tloss, tmetrics=tmetrics, tgrads=tgrads, model=model, loss_fn=tloss_fn)  # fmt: skip


def test_batch_of_four_host_batch_matches_jax(batch4):
    jb, tb = batch4["jb"], batch4["tb"]
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    assert tb["point_mask"].sum(1).tolist() == [450, N_POINTS, 500, 0]


def test_batch_of_four_loss_and_metrics_match_jax(batch4):
    jm, tm = batch4["jmetrics"], batch4["tmetrics"]
    assert abs(float(batch4["tloss"].detach()) - float(batch4["jloss"])) <= LOSS_ATOL
    for k in ("iou_intersection", "iou_union"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    for k in ("loss", "acc", "nr_verts_mean", "nr_overflow_mean", "nr_points_mean"):
        tol = LOSS_ATOL if k == "loss" else MEAN_ATOL
        assert abs(float(tm[k]) - float(jm[k])) <= tol, k
    assert float(tm["nr_points_mean"]) == (450 + N_POINTS + 500) / 4  # the padded slot counts as a slot
    assert float(tm["nr_overflow_mean"]) == 0.0


def test_batch_of_four_gradients_match_jax(batch4):
    tg, jg = batch4["tgrads"], batch4["jgrads"]
    assert set(tg) == set(jg)
    for k in tg:
        want = jg[k].numpy()
        err = np.linalg.norm(tg[k].numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= GRAD_REL_L2, (k, err)


def test_padded_slot_alone_is_finite(batch4):
    tb = {k: v[3:] for k, v in batch4["tb"].items()}
    model = batch4["model"]
    leaves, loss, metrics = tdp.forward_loss(batch4["loss_fn"], model.state_dict(), tdp.to_device(tb, "cpu"))
    grads = tdp.gradients(loss, leaves)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    assert float(metrics["nr_verts_mean"]) == 0.0 and int(metrics["iou_union"].sum()) == 0


@pytest.fixture(scope="module")
def eval_runs(ref):
    out = {}
    for side in ("jax", "port"):
        d = ref["dir"] / f"pred_{side}"
        overrides = ref["overrides"] + [f"eval.output_predictions_path={d}"]
        if side == "jax":
            with pytest.MonkeyPatch.context() as m:
                m.setattr(jnl, "native_available", lambda: False)
                m.setattr(jsw, "build_and_init", lambda *a, **k: (ref["js"].params, 0))
                miou = jev.run(str(EVAL_CFG), str(ref["ckpt"]), True, overrides)
        else:
            miou = tev.run(EVAL_CFG, str(ref["ckpt"]), True, overrides, device="cpu")
        out[side] = (miou, d)
    return out


def test_ln_eval_shapenet_files_match_jax(eval_runs):
    (jmiou, jdir), (tmiou, tdir) = eval_runs["jax"], eval_runs["port"]
    assert abs(tmiou - jmiou) <= MIOU_ATOL
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == ["pred_synth0003.txt", "pred_synth0004.txt"]
    for name in names:
        labels = np.loadtxt(tdir / name, dtype=np.int64)
        assert labels.shape == (450,) and labels.min() >= 0 and labels.max() < 7
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
