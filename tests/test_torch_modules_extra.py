"""The rest of the port's module zoo, weight-norm folding and the
``batch_stats`` interop vs the JAX package, on the CPU.

* ``GnReluCoarsen``, ``ConvAct``, ``TwoConv``, ``ResnetBlock2``,
  ``DensenetBlock`` and ``GnReluDepthwiseConv`` with the flax init's
  parameters (``params_from_flax``, so the names match): outputs at 1e-5,
  the gradients of every parameter and of the input at 1e-4 relative L2.
* ``BatchNormLattice``: a training forward (statistics over the occupied
  rows, biased variance, running statistics decaying by 0.9), its
  gradients, and an evaluation forward on the running statistics.
* ``fuse_weight_norm`` / ``unfuse_weight_norm`` against JAX's on two
  weight-norm groups (a conv's and a nested one), the conv's forward
  unchanged by fusing.
* ``params_to_flax`` / ``params_from_flax`` carry ``batch_stats`` both ways,
  and a JAX-written checkpoint of a ``BatchNormLattice`` model loads in the
  port, and the port's save loads in JAX.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.nn import modules as jnm
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu_torch.interop import hierarchy_from_numpy, params_from_flax, params_to_flax
from lattice_net_tpu_torch.nn import modules as tnm
from lattice_net_tpu_torch.parallel.data_parallel import TrainState
from lattice_net_tpu_torch.train import checkpoint as tck
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

SIGMA, CAPS, N, C = 0.6, (4096, 2048), 3000, 8
ATOL, GRAD_REL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def _data():
    pts = np.asarray(make_scene(N, seed=9).V, np.float32)
    build = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=1, capacities=CAPS))
    hj = build(jnp.asarray(pts))
    ht = hierarchy_from_numpy(hj, device="cpu")
    lv = np.random.default_rng(2).normal(1.0, 2.0, size=(CAPS[0], C)).astype(np.float32)
    return hj, ht, lv


def _gen():
    return torch.Generator().manual_seed(0)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(got.detach().numpy() - want) / max(np.linalg.norm(want), 1e-12))


def _cases():
    hj, ht, _ = _data()
    m0j, m0t = hj.structures[0].occupancy_mask(), ht.structures[0].occupancy_mask()
    nj, nt = hj.neighbors_same[0], ht.neighbors_same[0]
    g = _gen()
    return {
        "GnReluCoarsen": (jnm.GnReluCoarsen(C, 6), (hj.neighbors_coarsen[0], m0j),
                          tnm.GnReluCoarsen(C, 6, g), (ht.neighbors_coarsen[0], m0t, ht.neighbors_finefy[0])),
        "ConvAct": (jnm.ConvAct(C, 6, use_bias=True), (nj,), tnm.ConvAct(C, 6, g, use_bias=True), (nt,)),
        "TwoConv": (jnm.TwoConv(C, (True, False)), (nj, m0j), tnm.TwoConv(C, g, (True, False)), (nt, m0t)),
        "ResnetBlock2": (jnm.ResnetBlock2(C, (False, True)), (nj, m0j),
                         tnm.ResnetBlock2(C, g, (False, True)), (nt, m0t)),
        "DensenetBlock": (jnm.DensenetBlock(6, nr_layers=3), (nj, m0j),
                          tnm.DensenetBlock(6, g, nr_layers=3, in_channels=C), (nt, m0t)),
        "GnReluDepthwiseConv": (jnm.GnReluDepthwiseConv(C), (nj, m0j), tnm.GnReluDepthwiseConv(C, g), (nt, m0t)),
    }  # fmt: skip


BLOCKS = ("GnReluCoarsen", "ConvAct", "TwoConv", "ResnetBlock2", "DensenetBlock", "GnReluDepthwiseConv")


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_flax(name):
    _, _, lv = _data()
    jmod, jargs, tmod, targs = _cases()[name]
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(lv), *jargs)
    sd = params_from_flax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tmod.state_dict()), (sorted(sd), sorted(tmod.state_dict()))
    tmod.load_state_dict(sd)
    out_j = jmod.apply(variables, jnp.asarray(lv), *jargs)
    probe = np.random.default_rng(3).normal(size=out_j.shape).astype(np.float32)

    def loss(v, x):
        return jnp.sum(jmod.apply(v, x, *jargs) * probe)

    gv, gx = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(lv))
    x = torch.from_numpy(lv.copy()).requires_grad_()
    out_t = tmod(x, *targs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=0, atol=ATOL)
    (out_t * torch.from_numpy(probe)).sum().backward()
    assert _rel(x.grad, gx) <= GRAD_REL
    gv = params_from_flax(jax.tree.map(np.asarray, gv))
    for k, p in tmod.named_parameters():
        assert _rel(p.grad, gv[k]) <= GRAD_REL, k


def test_two_conv_dropout_drops_whole_channels():
    _, ht, lv = _data()
    mod = tnm.TwoConv(C, _gen(), dropout=0.5)
    nt, m0 = ht.neighbors_same[0], ht.structures[0].occupancy_mask()
    with torch.no_grad():
        ref = mod(torch.from_numpy(lv), nt, m0)
        a = mod(torch.from_numpy(lv), nt, m0, train=True, generator=torch.Generator().manual_seed(4))
        b = mod(torch.from_numpy(lv), nt, m0, train=True, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, ref)
    with pytest.raises(ValueError, match="Generator"):
        mod(torch.from_numpy(lv), nt, m0, train=True)


# ---------------------------------------------------------------------------
# module 14: BatchNormLattice, weight-norm folding
# ---------------------------------------------------------------------------


def test_batch_norm_lattice_train_and_eval():
    hj, ht, lv = _data()
    m_j, m_t = hj.structures[0].occupancy_mask(), ht.structures[0].occupancy_mask()
    jmod = jnm.BatchNormLattice(C)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(lv), m_j)
    out_j, upd = jmod.apply(variables, jnp.asarray(lv), m_j, mutable=["batch_stats"])
    tmod = tnm.BatchNormLattice(C)
    tmod.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables)))
    x = torch.from_numpy(lv.copy()).requires_grad_()
    out_t = tmod(x, m_t)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=0, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tmod, k).numpy(), np.asarray(upd["batch_stats"][k]), rtol=0, atol=1e-6)
    # the statistics are the occupied rows' (padded rows would move them)
    occ = lv[: int(ht.structures[0].nr_verts)]
    np.testing.assert_allclose(tmod.mean.numpy(), 0.1 * occ.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmod.var.numpy(), 0.9 + 0.1 * occ.var(0), rtol=1e-5, atol=1e-6)
    probe = np.random.default_rng(5).normal(size=lv.shape).astype(np.float32)
    gv, gx = jax.grad(
        lambda v, x: jnp.sum(jmod.apply(v, x, m_j, mutable=["batch_stats"])[0] * probe), argnums=(0, 1)
    )(variables, jnp.asarray(lv))
    (out_t * torch.from_numpy(probe)).sum().backward()
    assert _rel(x.grad, gx) <= GRAD_REL
    for k in ("scale", "bias"):
        assert _rel(getattr(tmod, k).grad, gv["params"][k]) <= GRAD_REL
    # evaluation: the running statistics
    ev_j = jmod.apply({**variables, **upd}, jnp.asarray(lv), m_j, use_running_average=True)
    with torch.no_grad():
        before = tmod.mean.clone()
        ev_t = tmod(torch.from_numpy(lv), m_t, use_running_average=True)
    torch.testing.assert_close(tmod.mean, before, rtol=0, atol=0)
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=0, atol=ATOL)


def test_fuse_and_unfuse_weight_norm_match_jax():
    hj, ht, lv = _data()
    jmod = jnm.ConvIm2Row(C, 6, weight_norm=True)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(lv), hj.neighbors_same[0])
    # a second group nested one level down, and the 1x1 WN linear
    tree = {"params": {"a": variables["params"], "b": {"WNLinear_0": {"v": variables["params"]["v"][:, :3],
                                                                        "g": variables["params"]["g"][:3] * 2}}}}  # fmt: skip
    sd = params_from_flax(jax.tree.map(np.asarray, tree))
    for fj, ft in ((jnm.fuse_weight_norm, tnm.fuse_weight_norm), (jnm.unfuse_weight_norm, tnm.unfuse_weight_norm)):
        want = params_from_flax(jax.tree.map(np.asarray, fj(tree)))
        got = ft(sd)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    tmod = tnm.ConvIm2Row(C, 6, _gen(), weight_norm=True)
    tmod.load_state_dict({k[2:]: v for k, v in sd.items() if k.startswith("a.")})
    nt = ht.neighbors_same[0]
    with torch.no_grad():
        ref = tmod(torch.from_numpy(lv), nt)
        tmod.load_state_dict(tnm.fuse_weight_norm(tmod.state_dict()))
        fused = tmod(torch.from_numpy(lv), nt)
    torch.testing.assert_close(fused, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# module 16: batch_stats through the interop and the checkpoints
# ---------------------------------------------------------------------------


class _JBNNet(fnn.Module):
    @fnn.compact
    def __call__(self, lv, nbrs, mask, train=True):
        lv = jnm.BatchNormLattice(C)(lv, mask, use_running_average=not train)
        return jnm.ConvIm2Row(C, 4)(lv, nbrs)


class _TBNNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.BatchNormLattice_0 = tnm.BatchNormLattice(C)
        self.ConvIm2Row_0 = tnm.ConvIm2Row(C, 4, _gen())

    def forward(self, lv, nbrs, mask, train=True):
        return self.ConvIm2Row_0(self.BatchNormLattice_0(lv, mask, not train), nbrs)


@functools.lru_cache(maxsize=None)
def _jax_bn_state():
    hj, _, lv = _data()
    net = _JBNNet()
    m = hj.structures[0].occupancy_mask()
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(lv), hj.neighbors_same[0], m)
    _, upd = net.apply(variables, jnp.asarray(lv), hj.neighbors_same[0], m, mutable=["batch_stats"])
    variables = {**variables, **upd}  # trained statistics, not the init's
    tx = jo.make_optimizer(1e-3, 1e-4)
    return net, variables, tx, jdp.TrainState.create(variables, tx)


def test_batch_stats_round_trip_through_the_interop():
    net, variables, _, _ = _jax_bn_state()
    sd = params_from_flax(jax.tree.map(np.asarray, variables))
    assert {"BatchNormLattice_0.mean", "BatchNormLattice_0.var"} <= set(sd)
    tnet = _TBNNet()
    tnet.load_state_dict(sd)
    back = params_to_flax(tnet.state_dict())
    assert set(back) == {"params", "batch_stats"}
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, variables))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], leaf)
    # the converted model evaluates as the JAX one on its running statistics
    hj, ht, lv = _data()
    want = net.apply(variables, jnp.asarray(lv), hj.neighbors_same[0], hj.structures[0].occupancy_mask(), False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(lv), ht.neighbors_same[0], ht.structures[0].occupancy_mask(), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_batch_stats_through_jax_and_port_checkpoints(tmp_path):
    _, variables, tx_j, jstate = _jax_bn_state()
    jck.save_checkpoint(tmp_path / "jax.ckpt", jstate)
    tnet = _TBNNet()
    tx = to.make_optimizer(1e-3, 1e-4)
    template = TrainState.create(tnet.state_dict(), tx)
    got = tck.load_checkpoint(tmp_path / "jax.ckpt", template)
    want = params_from_flax(jax.tree.map(np.asarray, variables))
    assert set(got.params) == set(want)
    for k in want:
        torch.testing.assert_close(got.params[k], want[k], rtol=0, atol=0)
    params = tck.load_params(tmp_path / "jax.ckpt", tnet.state_dict())
    torch.testing.assert_close(params["BatchNormLattice_0.var"], want["BatchNormLattice_0.var"], rtol=0, atol=0)
    tck.save_checkpoint(tmp_path / "port.ckpt", got, tx)
    restored = jck.load_checkpoint(tmp_path / "port.ckpt", jstate)
    for a, b in zip(jax.tree.leaves(restored.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(restored.params) == {"params", "batch_stats"}
