"""The port's LNN forward and Predictor vs the JAX package, in f32 on the CPU.

Same cloud (padded with a point mask, as the batcher does), same weights
(the flax params converted by ``params_from_flax``): log-probabilities agree
to 1e-4 absolute (f32 GEMMs and norms summed in another order through a
dozen layers) and the labels are equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.data import synth_kitti as tsynth
from lattice_net_tpu_torch.interop import hierarchy_from_numpy, params_from_flax
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.serve import Predictor

torch.set_num_threads(2)

LOGP_ATOL = 1e-4
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
CFG = """
model: {
    positions_mode: "xyz"
    values_mode: "intensity"
    pointnet_channels_per_layer: [8, 16]
    pointnet_start_nr_channels: 16
    nr_downsamples: 2
    nr_blocks_down_stage: [1, 1]
    nr_blocks_bottleneck: 1
    nr_blocks_up_stage: [1, 1]
    nr_levels_down_with_normal_resnet: 3
    nr_levels_up_with_normal_resnet: 3
}
lattice_gpu: {
    hash_table_capacity: 8192
    nr_sigmas: 1
    sigma_0: "0.6 3"
}
"""


@pytest.fixture(scope="module")
def ref():
    c = make_scene(N_POINTS, seed=1)
    pos, vals = c.V[:N_REAL], c.I[:N_REAL]
    pad = N_POINTS - N_REAL
    pos_p = np.pad(pos, ((0, pad), (0, 0)))
    vals_p = np.pad(vals, ((0, pad), (0, 0)))
    mask = np.arange(N_POINTS) < N_REAL
    hj = jbuild(
        jnp.asarray(pos_p), SIGMA, 2, CAPS, point_mask=jnp.asarray(mask),
        point_feats=jnp.asarray(vals_p),
    )  # fmt: skip
    model = jlnn.LNN(jlnn.ModelParams(**MODEL))
    # jitted: an eager init compiles every op on its own and takes 7x longer
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, jnp.asarray(pos_p), jnp.asarray(vals_p))
    logp, _ = jax.jit(model.apply)(params, hj, jnp.asarray(pos_p), jnp.asarray(vals_p))
    return dict(
        pos=pos, vals=vals, pos_p=pos_p, vals_p=vals_p, mask=mask, hj=hj,
        params=jax.tree.map(np.asarray, params), logp=np.asarray(logp),
    )  # fmt: skip


def _port_model(ref):
    m = tlnn.LNN(
        tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
        conv_dtype=torch.float32,
    )  # fmt: skip
    m.load_state_dict(params_from_flax(ref["params"]))
    return m.eval()


def test_params_from_flax_is_one_to_one(ref):
    sd = params_from_flax(ref["params"])
    flat = jax.tree_util.tree_flatten_with_path(ref["params"]["params"])[0]
    names = {".".join(k.key for k in path): v.shape for path, v in flat}
    assert {k: tuple(v.shape) for k, v in sd.items()} == names
    model = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu")
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert own == names  # same module paths and layouts, no transposes


def test_lnn_forward_matches_jax(ref):
    model = _port_model(ref)
    ht = build_hierarchy(
        torch.from_numpy(ref["pos_p"]), SIGMA, 2, CAPS,
        point_mask=torch.from_numpy(ref["mask"]), point_feats=torch.from_numpy(ref["vals_p"]),
    )  # fmt: skip
    with torch.inference_mode():
        logp, logits = model(ht, torch.from_numpy(ref["pos_p"]), torch.from_numpy(ref["vals_p"]))
    assert logp.shape == (N_POINTS, MODEL["nr_classes"]) and logits.dtype == torch.float32
    np.testing.assert_allclose(logp.numpy(), ref["logp"], rtol=0, atol=LOGP_ATOL)
    np.testing.assert_array_equal(logp.numpy().argmax(-1), ref["logp"].argmax(-1))


def test_lnn_forward_on_the_jax_hierarchy(ref):
    # the same comparison with the model isolated from the build
    model = _port_model(ref)
    ht = hierarchy_from_numpy(ref["hj"], device="cpu")
    with torch.inference_mode():
        logp, _ = model(ht, torch.from_numpy(ref["pos_p"]), torch.from_numpy(ref["vals_p"]))
    np.testing.assert_allclose(logp.numpy(), ref["logp"], rtol=0, atol=LOGP_ATOL)


def test_predictor_cpu_matches_jax_argmax(ref, tmp_path):
    cfg = tmp_path / "small.cfg"
    cfg.write_text(CFG)
    pred = Predictor.from_config(
        cfg, nr_classes=5, device="cpu", conv_dtype=torch.float32, n_points=N_POINTS
    )
    assert pred.capacities == CAPS and pred.sigma == SIGMA
    pred.model.load_state_dict(params_from_flax(ref["params"]))
    labels = pred.predict(ref["pos"], ref["vals"])
    assert labels.shape == (N_REAL,)
    np.testing.assert_array_equal(labels, ref["logp"][:N_REAL].argmax(-1))
    with pytest.raises(ValueError):
        pred.predict(np.zeros((N_POINTS + 1, 3), np.float32), np.zeros((N_POINTS + 1, 1)))


def test_predictor_rejects_out_of_range_scene(tmp_path):
    cfg = tmp_path / "small.cfg"
    cfg.write_text(CFG)
    pred = Predictor.from_config(cfg, nr_classes=5, device="cpu", n_points=16)
    far = np.full((8, 3), 1e5, np.float32)
    with pytest.raises(ValueError):
        pred.predict(far, np.zeros((8, 1), np.float32))


@pytest.mark.parametrize(
    "values_mode", ["none", "intensity", "rgb", "rgb+height", "rgb+xyz", "height", "xyz"]
)
def test_scene_and_prepare_cloud_match(values_mode):
    # the port's own copy of make_scene, mapped by its prepare_cloud
    cj, ct = make_scene(3000, seed=4), tsynth.make_scene(3000, seed=4)
    got = tlnn.prepare_cloud(ct, tlnn.ModelParams(values_mode=values_mode))
    want = jlnn.prepare_cloud(cj, jlnn.ModelParams(values_mode=values_mode))
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)
    assert tlnn.input_dims(tlnn.ModelParams(values_mode=values_mode))[1] == got[1].shape[1]
    with pytest.raises(NotImplementedError):
        tlnn.prepare_cloud(ct, tlnn.ModelParams(positions_mode="xyz+rgb"))


CONFIGS = sorted(Path(__file__).resolve().parent.parent.glob("config/*.cfg"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_config_views_match(path):
    # the port's views carry a subset of the JAX fields, each with its value
    cj, ct = jconfig.load_config(path), tconfig.load_config(path)
    assert cj == ct
    mj = jconfig.model_params_from_config(cj, 20)
    mt = tconfig.model_params_from_config(ct, 20)
    views = [(jconfig.LatticeParams.from_config(cj), tconfig.LatticeParams.from_config(ct)), (mj, mt)]
    for vj, vt in views:
        fields = [f.name for f in dataclasses.fields(vt)]
        assert {f: getattr(vj, f) for f in fields} == dataclasses.asdict(vt)
    assert jlnn.channel_plan(mj) == tlnn.channel_plan(mt)
