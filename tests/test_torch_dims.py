"""Lattices of d > 3 (``xyz+intensity``, ``xyz+rgb``) in the port vs the JAX
package, on the CPU.

* d = 4, 5, 6: packed keys (two int64 columns) round-trip and keep the
  lexicographic order; every hierarchy table (keys, occupancy, neighbour
  tables, splat map, edge sort) bit-equal to JAX's jitted build, masked
  (the canonical order and fast build at d > 3 are in
  ``test_torch_batched_build.py``).
* A d = 4 cloud that ``check_positions`` accepts builds and serves (the
  fault where the port's check admitted d <= 6 and its build refused d > 3).
* Narrow ``LNN``s of d = 4 (a KITTI-like scan with its intensity) and
  d = 6 (a room with its colours, at a per-dimension sigma vector, the
  trainer's ``parse_sigmas`` when the config's sigmas differ), with the
  flax weights carried by
  ``interop.params_from_flax`` (first layers of d + C inputs, convs of 11
  and 15 rows a channel): log-probabilities to 1e-4 with equal labels, the
  train step's loss to 1e-5 and every gradient to 1e-4 relative L2.

JAX builds and steps are jitted (10x faster than eager on the CPU).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.misc.scannet_scale_probe import make_indoor_scene
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu_torch.config import load_config, model_params_from_config
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.serve import Predictor

torch.set_num_threads(2)

EVAL_CONFIG = Path(__file__).resolve().parent.parent / "config" / "lnn_eval_semantic_kitti.cfg"
LOGP_ATOL, LOSS_ATOL, GRAD_REL_L2 = 1e-4, 1e-5, 1e-4
N = 1024
CAPS = (4096, 2048, 1024)
MODEL = dict(
    nr_classes=5, pointnet_channels_per_layer=(8,), pointnet_start_nr_channels=8, nr_downsamples=2,
    nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
)  # fmt: skip


def _random_cloud(d, n=N, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, size=(n, d)).astype(np.float32)
    mask = rng.random(n) > 0.15
    return pos, mask


@functools.lru_cache(maxsize=None)
def _jbuild(sigma, caps):
    return jax.jit(functools.partial(js.build_hierarchy, sigma=sigma, nr_levels=len(caps) - 1, capacities=caps))


def _assert_tables(hj, ht):
    for a, b in zip(hj.structures, ht.structures, strict=True):
        np.testing.assert_array_equal(np.asarray(a.keys), b.keys.numpy())
        assert (int(a.nr_verts), int(a.nr_overflow)) == (int(b.nr_verts), int(b.nr_overflow))
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, b in zip(getattr(hj, name), getattr(ht, name), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(hj.splat_idx), ht.splat_idx.numpy())
    for f in ("perm", "vertex", "ends"):
        np.testing.assert_array_equal(np.asarray(getattr(hj.edges, f)), getattr(ht.edges, f).numpy(), err_msg=f)


@pytest.mark.parametrize("d", [4, 5, 6])
def test_packed_keys_round_trip_in_lexicographic_order(d):
    rng = np.random.default_rng(d)
    keys = rng.integers(-ts.PACK_BOUND + 1, ts.PACK_BOUND, size=(500, d)).astype(np.int32)
    keys[::7, :2] = keys[3, :2]  # shared prefixes
    packed = ts.pack_keys(torch.from_numpy(keys))
    assert packed.shape == (500, ts.key_columns(d)) == (500, 2)
    np.testing.assert_array_equal(ts.unpack_keys(packed, d).numpy(), keys)
    _, order = ts._sort_packed(packed)
    np.testing.assert_array_equal(order.numpy(), np.lexsort(keys.T[::-1]))
    table = np.concatenate([keys[:3], np.full((2, d), ts.SENTINEL, np.int32)])
    pt = ts.pack_key_table(torch.from_numpy(table))
    assert (pt[3:] == ts._PACKED_SENTINEL).all() and (pt[:3] == packed[:3]).all()


@pytest.mark.parametrize("d", [4, 5, 6])
def test_hierarchy_tables_match_jax(d):
    pos, mask = _random_cloud(d, seed=d)
    hj = _jbuild(0.4, CAPS)(jnp.asarray(pos), point_mask=jnp.asarray(mask))
    ht = ts.build_hierarchy(torch.from_numpy(pos), 0.4, 2, CAPS, point_mask=torch.from_numpy(mask))
    _assert_tables(hj, ht)
    assert int(ht.structures[0].nr_verts) > 0 and int((ht.neighbors_same[0] < CAPS[0]).sum()) > 0


# ---------------------------------------------------------------------------
# the model of d = 4 and d = 6
# ---------------------------------------------------------------------------

CLOUDS = {
    # a KITTI-like scan cropped close to the sensor, with its intensity
    "xyz+intensity": dict(values_mode="intensity", sigma=0.6),
    # a room with its colours, at per-dimension sigmas (the trainer's
    # parse_sigmas vector when the config's sigmas differ): the colour axes
    # finer than the xyz ones, a few lattice units across
    "xyz+rgb": dict(values_mode="rgb+height", sigma=(0.5, 0.5, 0.5, 0.25, 0.25, 0.25)),
}


def _model_cloud(name):
    """(mode, model fields, positions, values, targets) of a case."""
    mode = name
    if mode == "xyz+intensity":
        c = make_scene(N, seed=5, max_range=12.0)
    else:
        V, C, L = make_indoor_scene(N, seed=5)
        c = type("Cloud", (), dict(V=V, C=C, I=np.zeros((N, 1), np.float32), L_gt=L))
    fields = dict(MODEL, positions_mode=mode, values_mode=CLOUDS[name]["values_mode"])
    pos, vals, tgt = jlnn.prepare_cloud(c, jlnn.ModelParams(**fields))
    return mode, fields, pos, vals, tgt % MODEL["nr_classes"]


@pytest.fixture(scope="module", params=list(CLOUDS))
def model_case(request):
    name = request.param
    sigma = CLOUDS[name]["sigma"]
    mode, fields, pos, vals, tgt = _model_cloud(name)
    batch = jdp.make_batch([(pos, vals, tgt)], None, N + 64, rng=np.random.default_rng(0))
    b0 = {k: v[0] for k, v in batch.items()}
    build = jax.jit(functools.partial(js.build_hierarchy, nr_levels=2, capacities=CAPS))
    hj = build(b0["positions"], jnp.asarray(sigma), point_mask=b0["point_mask"], point_feats=b0["values"])
    model = jlnn.LNN(jlnn.ModelParams(**fields))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, b0["positions"], b0["values"])
    logp = jax.jit(model.apply)(params, hj, b0["positions"], b0["values"])[0]
    lf = jdp.make_loss_fn(model, jnp.asarray(sigma), 2, CAPS)
    (loss, _), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params, batch, jax.random.PRNGKey(1))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(mode=mode, sigma=sigma, mp=tlnn.ModelParams(**fields), hj=hj, batch=as_np(batch),
                params=as_np(params), logp=np.asarray(logp), loss=float(loss), grads=as_np(grads))  # fmt: skip


def _port(case):
    model = tlnn.LNN(case["mp"], torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    model.load_state_dict(params_from_flax(case["params"]))
    return model


def test_interop_carries_the_wide_first_layers(model_case):
    d = 4 if model_case["mode"] == "xyz+intensity" else 6
    model = _port(model_case)
    c = tlnn.input_dims(model_case["mp"])
    assert c[0] == d
    sd = model.state_dict()
    assert sd["PointNetModule_0.WNLinear_0.v"].shape[0] == d + c[1]  # (in, out)
    extent = 2 * (d + 1) + 1  # 11 or 15 rows a channel
    assert sd["PointNetModule_0.ConvIm2Row_0.v"].shape[0] == extent * 2 * MODEL["pointnet_channels_per_layer"][-1]
    assert sd["CoarsenAct_0.CoarsenConv_0.weight"].shape[0] == extent * MODEL["pointnet_start_nr_channels"]


def test_d_gt_3_tables_and_log_probs_match_jax(model_case):
    b = {k: torch.from_numpy(v[0].copy()) for k, v in model_case["batch"].items()}
    tops.check_positions(b["positions"].numpy(), b["values"].numpy(), sigma=model_case["sigma"])
    ht = ts.build_hierarchy(b["positions"], model_case["sigma"], 2, CAPS, point_mask=b["point_mask"],
                            point_feats=b["values"])  # fmt: skip
    hj = model_case["hj"]
    for a, s in zip(hj.structures, ht.structures, strict=True):
        np.testing.assert_array_equal(np.asarray(a.keys), s.keys.numpy())
    for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy"):
        for a, t in zip(getattr(hj, name), getattr(ht, name), strict=True):
            np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=name)
    with torch.inference_mode():
        logp, _ = _port(model_case)(ht, b["positions"], b["values"])
    np.testing.assert_allclose(logp.numpy(), model_case["logp"], rtol=0, atol=LOGP_ATOL)
    np.testing.assert_array_equal(logp.numpy().argmax(-1), model_case["logp"].argmax(-1))


def test_d_gt_3_train_step_gradients_match_jax(model_case):
    model = _port(model_case)
    batch = {k: torch.from_numpy(v.copy()) for k, v in model_case["batch"].items()}
    loss_fn = tdp.make_loss_fn(model, model_case["sigma"], 2, CAPS)
    leaves, loss, _ = tdp.forward_loss(loss_fn, model.state_dict(), batch)
    grads = tdp.gradients(loss, leaves)
    assert abs(loss.item() - model_case["loss"]) <= LOSS_ATOL
    want = {k: v.numpy() for k, v in params_from_flax(model_case["grads"]).items()}
    errs = {k: np.linalg.norm(grads[k].numpy() - w) / max(np.linalg.norm(w), 1e-30) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def test_a_d4_cloud_check_positions_accepts_builds_and_serves(tmp_path):
    # the port's check admits d = 2..6; the build and the model must too
    c = make_scene(600, seed=2, max_range=12.0)
    pos = np.concatenate([c.V, c.I], axis=1).astype(np.float32)
    tops.check_positions(pos, c.I, sigma=0.6)
    cfg = load_config(str(EVAL_CONFIG))
    cfg["model"]["positions_mode"] = "xyz+intensity"
    cfg["model"]["values_mode"] = "intensity"
    cfg["lattice_gpu"]["hash_table_capacity"] = 4096
    pred = Predictor.from_config(cfg, nr_classes=5, device="cpu", conv_dtype=torch.float32, n_points=1024)
    assert model_params_from_config(cfg, 5).positions_mode == "xyz+intensity"
    labels = pred.predict(pos, c.I)
    assert labels.shape == (600,) and labels.min() >= 0 and labels.max() < 5
    logp, h = pred.forward(pos, c.I)
    assert h.structures[0].keys.shape[1] == 4 and torch.isfinite(logp).all()
    assert int(h.structures[0].nr_overflow) == 0

