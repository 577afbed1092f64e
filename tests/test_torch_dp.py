"""Data parallelism in the port against the JAX package's, and the parallel
options of the training and eval CLIs, on the CPU.

* The DP step on 2 gloo ranks (``mesh.launch``) against JAX's
  ``make_dp_train_step`` on 2 virtual devices and against the port's
  single-device step on the same 2-cloud batch: loss within 1e-5, the
  averaged gradients within 1e-4 (relative L2); two steps leave every rank
  with the same bits (``check_replicated``).  The model of
  ``tests/test_parallel.py``, without dropout: the port's ranks draw from
  generators of (seed, rank), JAX folds its rng with the axis index.
* ``ln_train.run`` on ``config/ln_train_toy.cfg`` for one epoch with
  ``dp=True`` over 2 ranks (the batch rounded to 2) against the
  single-device trainer at ``train.batch_size=2``: final parameters within
  1e-4 relative L2 (Adam's normalisation of near-zero gradients, as in
  ``tests/test_torch_trainer.py``); with ``sp=2``: runs, rank 0 writes the
  checkpoint.
* ``ln_eval.run(sp=2)`` from that checkpoint writes labels that agree with
  the unsharded eval's on more than 99.5% of points (a toy cloud spans less
  than the receptive band: each stripe's halo brings the whole cloud).
* ``parallel.dryrun`` over 4 ranks prints its three lines (DP against one
  device, the sharded forward and step, the hybrid dp2 x sp2 step).

The spawned ranks import this module, so JAX is imported inside the
reference fixtures only.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.data.toy import make_toy_cloud
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams, prepare_cloud
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.parallel import dryrun
from lattice_net_tpu_torch.parallel import mesh as tmesh
from lattice_net_tpu_torch.train import ln_eval as tev
from lattice_net_tpu_torch.train import ln_train as tln
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOY = ROOT / "config" / "ln_train_toy.cfg"
LOSS_ATOL, GRAD_REL_L2, PARAM_REL_L2 = 1e-5, 1e-4, 1e-4
MODEL = dict(
    nr_classes=4, pointnet_channels_per_layer=(8, 8), pointnet_start_nr_channels=8, nr_downsamples=1,
    nr_blocks_down_stage=(1,), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1,),
    nr_levels_down_with_normal_resnet=1, nr_levels_up_with_normal_resnet=1,
)  # fmt: skip
CAPS, SIGMA, N_POINTS, LR = (512, 256), 0.25, 256, 1e-3


def _clouds():
    mp = ModelParams(**MODEL)
    return [prepare_cloud(make_toy_cloud(n_points=200 + 10 * i, nr_classes=4, seed=i), mp) for i in range(2)]


def _host_batch():
    return tdp.make_host_batch(_clouds(), N_POINTS, rng=np.random.default_rng(0))


def _rank_dp(device, params_np):
    mesh = tmesh.Mesh(("dp",), (2,))
    model = LNN(ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params_np.items()})
    tx = to.CapturingOptimizer(to.make_optimizer(LR))
    state = tdp.replicate_state(tdp.TrainState.create(model.state_dict(), tx))
    step = tdp.make_dp_train_step(model, tx, mesh, SIGMA, 1, CAPS)
    batch = tdp.shard_batch(_host_batch(), mesh, "dp", "cpu")
    gen = tdp.rank_generator(0, mesh.rank, "cpu")
    state, metrics = step(state, batch, gen)
    state, _ = step(state, batch, gen)
    tmesh.check_replicated(state.params)
    return metrics, tx.grads[0], state.params, state.step


@pytest.fixture(scope="module")
def flax_params():
    import jax

    from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
    from lattice_net_tpu.models import LNN as JLNN, ModelParams as JModelParams

    b = {k: v[0] for k, v in _host_batch().items()}
    h = jax.jit(lambda p, m: jbuild(p, SIGMA, 1, CAPS, point_mask=m))(b["positions"], b["point_mask"])
    model = JLNN(JModelParams(**MODEL))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), h, b["positions"], b["values"])
    return model, params


@pytest.fixture(scope="module")
def port_dp(flax_params):
    params_np = {k: v.numpy() for k, v in params_from_flax(flax_params[1]).items()}
    return params_np, tmesh.launch(_rank_dp, params_np, ranks=tmesh.plan_ranks(2, "cpu"))


@pytest.fixture(scope="module")
def jax_dp(flax_params):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from lattice_net_tpu.parallel import data_parallel as jdp
    from lattice_net_tpu.train import make_optimizer

    model, params = flax_params
    capture = optax.GradientTransformation(lambda ps: jax.tree.map(jnp.zeros_like, ps), lambda g, s, ps=None: (g, g))
    tx = optax.chain(capture, make_optimizer(LR))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    step = jdp.make_dp_train_step(model, tx, mesh, SIGMA, 1, CAPS)
    state = jdp.replicate_state(jdp.TrainState.create(params, tx), mesh)
    new, metrics = step(state, jdp.shard_batch(_host_batch(), mesh), jax.random.PRNGKey(1))
    grads = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, new.opt_state[0])).items()}
    return jax.tree.map(np.asarray, metrics), grads


def _rel(got, want):
    return max(np.linalg.norm(np.asarray(got[k]) - w) / max(np.linalg.norm(w), 1e-30) for k, w in want.items())


def test_dp_step_matches_jax(port_dp, jax_dp):
    m_j, g_j = jax_dp
    for metrics, grads, _, _ in port_dp[1]:
        assert abs(float(metrics["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
        assert _rel(grads, g_j) <= GRAD_REL_L2
        for k in ("iou_intersection", "iou_union", "nr_verts_mean", "nr_points_mean"):
            np.testing.assert_allclose(metrics[k], m_j[k], rtol=1e-6, err_msg=k)


def test_dp_step_matches_the_single_device_step_and_stays_in_sync(port_dp):
    params_np, ranks = port_dp
    model = LNN(ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params_np.items()})
    loss_fn = tdp.make_loss_fn(model, SIGMA, 1, CAPS)
    leaves, loss, _ = tdp.forward_loss(loss_fn, dict(model.state_dict()), tdp.to_device(_host_batch(), "cpu"))
    single = {k: g.numpy() for k, g in tdp.gradients(loss, leaves).items()}
    for metrics, grads, params, step in ranks:
        assert abs(float(metrics["loss"]) - loss.item()) <= LOSS_ATOL
        assert _rel(grads, single) <= GRAD_REL_L2
        assert step == 2
    p0, p1 = ranks[0][2], ranks[1][2]
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)


def _rel_all(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    ckpt = lambda name: [f"train.checkpoint_path={d / name}"]  # noqa: E731
    out = {}
    out["single"] = tln.run(TOY, max_epochs=1, overrides=ckpt("single") + ["train.batch_size=2"], device="cpu")
    out["dp"] = tln.run(TOY, max_epochs=1, dp=True, overrides=ckpt("dp"), device="cpu", ranks=2)
    out["sp"] = tln.run(TOY, max_epochs=1, sp=2, overrides=ckpt("sp"), device="cpu")
    return d, out


def test_ln_train_dp_matches_the_single_device_trainer(toy_runs, capfd):
    d, out = toy_runs
    single, dp = out["single"], out["dp"]
    assert single.step == dp.step == 3  # 6 clouds, batches of 2
    assert _rel_all(dp.params, single.params) <= PARAM_REL_L2
    assert (d / "dp" / "last.ckpt").exists()


def test_ln_train_sp_runs_and_rank0_checkpoints(toy_runs):
    d, out = toy_runs
    assert out["sp"].step == 6
    assert all(torch.isfinite(p).all() for p in out["sp"].params.values())
    assert (d / "sp" / "last.ckpt").exists()


def test_ln_eval_sp_labels_agree_with_the_unsharded_eval(toy_runs):
    d, _ = toy_runs
    ckpt = str(d / "dp" / "last.ckpt")
    runs = {}
    for sp in (0, 2):
        out = d / f"pred_sp{sp}"
        runs[sp] = tev.run(TOY, ckpt, True, [f"eval.output_predictions_path={out}"], sp=sp, device="cpu")
    files = sorted((d / "pred_sp0").glob("pred_*.txt"))
    assert len(files) == 6
    want = np.concatenate([np.loadtxt(f, dtype=np.int64) for f in files])
    got = np.concatenate([np.loadtxt(d / "pred_sp2" / f.name, dtype=np.int64) for f in files])
    assert float((got == want).mean()) > 0.995
    assert abs(runs[2] - runs[0]) < 0.01


def test_dryrun_prints_the_dp_sharded_and_hybrid_lines(capsys):
    lines = dryrun.dryrun(4, "cpu")
    assert [line.split(":")[1].split(",")[0].strip() for line in lines] == [
        "2 DP steps", "sharded U-Net fwd + train step ok", "hybrid dp2 x sp2 train step ok"]  # fmt: skip
    assert "params match single-device to 1e-5" in lines[0]
    assert capsys.readouterr().out.splitlines()[-3:] == lines
