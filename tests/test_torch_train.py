"""One train step of the port vs one jitted JAX train step, in f32 on the CPU.

The small model of ``tests/test_torch_model.py`` (5 classes, (8, 16)
PointNet, two downsamples) on a 3500-point cloud padded to 4096 points,
with some ignore labels.  Both packages get the same batch (``make_batch``
with the same numpy generator), the same weights (``params_from_flax``)
and AdamW-amsgrad with cosine warm restarts.

* The loss agrees to 1e-5 and the metrics exactly (counts) or to 1e-6
  (means of counts).
* Every parameter's gradient agrees to a relative L2 error of 1e-4: f32
  sums in another order through a dozen layers and the conv adjoints.  The
  PointNet max-pool has no tie inside a run here (checked): on the CPU the
  JAX package differentiates the scatter-max by plain AD, which splits a
  tie evenly, where the port (like the TPU path) gives it all to the latest
  edge.
* Adam normalises each entry, so a gradient near zero can flip an update
  by a whole ``lr``: the new parameters are compared by feeding JAX's
  gradients to the port's optimizer, to 2e-7 absolute.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

LOSS_ATOL = 1e-5
GRAD_REL_L2 = 1e-4
PARAM_ATOL = 2e-7
N_POINTS, N_REAL, CAPS, SIGMA = 4096, 3500, (8192, 4096, 2048), 0.6
MODEL = dict(
    nr_classes=5,
    values_mode="intensity",
    pointnet_channels_per_layer=(8, 16),
    pointnet_start_nr_channels=16,
    nr_downsamples=2,
    nr_blocks_down_stage=(1, 1),
    nr_blocks_bottleneck=1,
    nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3,
    nr_levels_up_with_normal_resnet=3,
)
OPT = dict(lr=1e-3, weight_decay=1e-3, schedule="cosine_warm_restarts", t0_steps=3)


def _cloud():
    c = make_scene(N_REAL, seed=1)
    pos, vals, target = jlnn.prepare_cloud(c, jlnn.ModelParams(**MODEL))
    target = target % MODEL["nr_classes"]
    target[::11] = -1  # ignore label
    return pos, vals, target


def _capture_grads():
    """An optax stage that passes the gradients on and keeps them as its
    state, so the jitted JAX step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params), lambda g, state, params=None: (g, g)
    )


@pytest.fixture(scope="module")
def ref():
    cloud = _cloud()
    batch = jdp.make_batch([cloud], None, N_POINTS, rng=np.random.default_rng(3))
    model = jlnn.LNN(jlnn.ModelParams(**MODEL))
    b0 = {k: v[0] for k, v in batch.items()}
    hj = jbuild(b0["positions"], SIGMA, 2, CAPS, point_mask=b0["point_mask"],
                point_feats=b0["values"])  # fmt: skip
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, b0["positions"], b0["values"])
    tx = optax.chain(_capture_grads(), jo.make_optimizer(**OPT))
    state = jdp.TrainState.create(params, tx)
    # jitted once for the module
    step = jax.jit(jdp.make_train_step(model, tx, SIGMA, 2, CAPS))
    new_state, metrics = step(state, batch, jax.random.PRNGKey(1))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        cloud=cloud, batch=as_np(batch), params=as_np(params), grads=as_np(new_state.opt_state[0]),
        new_params=as_np(new_state.params), metrics=as_np(metrics),
    )  # fmt: skip


@pytest.fixture(scope="module")
def port(ref):
    model = tlnn.LNN(
        tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
        conv_dtype=torch.float32,
    )  # fmt: skip
    model.load_state_dict(params_from_flax(ref["params"]))
    batch = tdp.make_batch([ref["cloud"]], N_POINTS, rng=np.random.default_rng(3), device="cpu")
    tx = to.make_optimizer(**OPT)
    state = tdp.TrainState.create(model.state_dict(), tx)
    loss_fn = tdp.make_loss_fn(model, SIGMA, 2, CAPS)
    leaves, loss, metrics = tdp.forward_loss(loss_fn, state.params, batch)
    grads = tdp.gradients(loss, leaves)
    new_state, step_metrics = tdp.make_train_step(model, tx, SIGMA, 2, CAPS)(state, batch)
    return dict(
        model=model, batch=batch, tx=tx, state=state, loss=loss, metrics=metrics, grads=grads,
        new_state=new_state, step_metrics=step_metrics,
    )  # fmt: skip


def test_make_batch_picks_the_same_points():
    rng = np.random.default_rng(4)
    clouds = []
    for n in (5000, 3000):  # one subsampled, one padded
        clouds.append((rng.normal(size=(n, 3)).astype(np.float32),
                       rng.normal(size=(n, 1)).astype(np.float32),
                       rng.integers(0, 5, n).astype(np.int32)))  # fmt: skip
    want = jdp.make_batch(clouds, None, 4096, rng=np.random.default_rng(9), device=False)
    got = tdp.make_batch(clouds, 4096, rng=np.random.default_rng(9), device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_batches_agree(ref, port):
    for k, v in ref["batch"].items():
        np.testing.assert_array_equal(port["batch"][k].numpy(), v, err_msg=k)


def test_loss_and_metrics_match_jax(ref, port):
    m_j, m_t = ref["metrics"], port["step_metrics"]
    assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
    assert abs(port["loss"].item() - float(m_j["loss"])) <= LOSS_ATOL
    assert set(m_t) == set(m_j)
    for k in ("iou_intersection", "iou_union"):
        np.testing.assert_array_equal(m_t[k].numpy(), m_j[k], err_msg=k)
    for k in ("acc", "nr_verts_mean", "nr_overflow_mean", "nr_points_mean"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6, err_msg=k)


def test_every_gradient_matches_jax(ref, port):
    want = {k: v.numpy() for k, v in params_from_flax(ref["grads"]).items()}
    got = port["grads"]
    assert set(got) == set(want)
    errs = {}
    for k, w in want.items():
        errs[k] = np.linalg.norm(got[k].numpy() - w) / max(np.linalg.norm(w), 1e-30)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])
    assert all(np.linalg.norm(w) > 0 for w in want.values())


def test_no_tie_inside_a_maxpool_run(port, monkeypatch):
    # the premise of the gradient comparison (see the module docstring)
    calls = []
    seg_max = tops.seg_max_carry

    def recording(vals, carry, ids, run_end, plain=False):
        calls.append((vals.detach(), ids, run_end))
        return seg_max(vals, carry, ids, run_end, plain=plain)

    monkeypatch.setattr(tops, "seg_max_carry", recording)
    with torch.no_grad():
        tdp.make_loss_fn(port["model"], SIGMA, 2, CAPS)(port["state"].params, port["batch"])
    (vals, ids, run_end), = calls
    cap = run_end.shape[0]
    maxed, _ = seg_max(vals, torch.zeros(len(ids)), ids, run_end)
    idc = ids.long().clamp(max=cap - 1)
    win = ((vals == maxed[idc]) & (ids < cap)[:, None]).float()
    hits = torch.zeros(cap + 1, vals.shape[1]).index_add_(0, ids.long().clamp(max=cap), win)
    assert int(hits[:cap].max()) == 1


def test_update_from_jax_gradients_matches_jax(ref, port):
    grads = params_from_flax(ref["grads"])
    state = port["state"]
    updates, _ = port["tx"].update(grads, state.opt_state, state.params)
    want = params_from_flax(ref["new_params"])
    for k, p in state.params.items():
        np.testing.assert_allclose(
            (p + updates[k]).numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k
        )


def test_train_step_leaves_its_input_state(port):
    state, new = port["state"], port["new_state"]
    assert (state.step, new.step) == (0, 1)
    assert state.opt_state["count"] == 0 and new.opt_state["count"] == 1
    moved = [k for k in state.params if not torch.equal(state.params[k], new.params[k])]
    assert len(moved) == len(state.params)
    own = port["model"].state_dict()
    assert all(torch.equal(own[k], v) for k, v in state.params.items())


def test_dropout_is_refused_in_training():
    model = tlnn.LNN(tlnn.ModelParams(**MODEL, dropout_last_layer=0.1),
                     torch.Generator().manual_seed(0), device="cpu")  # fmt: skip
    with pytest.raises(NotImplementedError):
        model(None, None, None)  # refused before the forward reads its inputs


def test_make_batch_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    cloud = (np.zeros((10, 3), np.float32), np.zeros((10, 1), np.float32), np.zeros(10, np.int32))
    with pytest.raises(RuntimeError):
        tdp.make_batch([cloud], 16)


CONFIGS = sorted(Path(__file__).resolve().parent.parent.glob("config/*.cfg"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_train_params_view_matches(path):
    cj, ct = jconfig.load_config(path), tconfig.load_config(path)
    vj, vt = jconfig.TrainParams.from_config(cj), tconfig.TrainParams.from_config(ct)
    fields = [f.name for f in dataclasses.fields(vt)]
    assert {f: getattr(vj, f) for f in fields} == dataclasses.asdict(vt)
