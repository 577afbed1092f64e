"""The port's flax-msgpack checkpoints vs the JAX package's, on the CPU.

* The codec (``train/_msgpack.py``, standard library and numpy) round-trips
  every type it writes, reads what the ``msgpack`` package writes, and
  writes what ``msgpack`` and flax read back equal (flax's ndarray, numpy
  scalar and complex extension types included).
* ``opt_state_to_optax_tree`` gives the layout (keys, shapes, dtypes) of
  ``flax.serialization.to_state_dict`` of the JAX optimizer state, for
  each schedule, with and without the global-norm clip.
* For both of the trainer's schedules (cosine warm restarts and
  reduce_on_plateau), after two optimizer steps: a state that JAX's
  ``save_checkpoint`` wrote loads in the port equal to ``params_from_flax``
  and ``opt_state_from_optax`` of it, and a state that the port wrote loads
  in JAX's ``load_checkpoint`` with every leaf equal, and the JAX
  optimizer steps on from it as the port does.
* ``load_params`` across optimizers, both ways.
* The real model: the port's ``state_dict`` names are the flax paths of the
  JAX init, and a port checkpoint of the toy config's model restores into
  the JAX ``TrainState`` of that init.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import optax.contrib
import pytest
import torch
from flax import serialization

from lattice_net_tpu import config as jconfig
from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu.train import checkpoint as jck
from lattice_net_tpu.train import optim as jo
from lattice_net_tpu_torch import config as tconfig
from lattice_net_tpu_torch.interop import (
    opt_state_from_optax,
    opt_state_to_optax_tree,
    params_from_flax,
    params_to_flax,
)
from lattice_net_tpu_torch.models.lnn import LNN
from lattice_net_tpu_torch.parallel.data_parallel import TrainState
from lattice_net_tpu_torch.train import _msgpack
from lattice_net_tpu_torch.train import checkpoint as tck
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

TOY = Path(__file__).resolve().parent.parent / "config" / "ln_train_toy.cfg"
SHAPES = {"Layer_0": {"kernel": (5, 4), "bias": (4,)}, "Layer_1": {"scale": (7,)}}
SCHEDULES = ["cosine_warm_restarts", "reduce_on_plateau"]
OPT = dict(lr=1e-3, weight_decay=1e-3, t0_steps=3, plateau_patience=1, plateau_accumulation=1)

VALUES = {
    "nil": None, "true": True, "false": False,
    "fixint": 5, "uint8": 200, "uint16": 60000, "uint32": 2**31, "uint64": 2**63 + 5,
    "negfixint": -7, "int8": -100, "int16": -30000, "int32": -(2**31), "int64": -(2**62),
    "float": -1.25e-300, "inf": float("inf"),
    "fixstr": "abc", "str8": "é" * 40, "str16": "x" * 300, "str32": "y" * 70000,
    "bin8": b"\x00\x01", "bin16": bytes(range(256)) * 2, "bin32": b"z" * 70000,
    "fixarray": [1, "a", None], "array16": list(range(20)), "array32": list(range(70000)),
    "fixmap": {"a": 1}, "map16": {str(i): i for i in range(20)},
    "map32": {str(i): i for i in range(70000)}, "nested": {"a": [{"b": [1.5, {}]}, []]},
    "complex": 1.5 - 2j,
}  # fmt: skip
ARRAYS = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "f64": np.linspace(0, 1, 5),
    "i32_0d": np.asarray(7, np.int32),
    "i64_empty": np.zeros((0, 3), np.int64),
    "bool": np.array([[True, False]]),
    "u8": np.arange(300, dtype=np.int64).astype(np.uint8),
    "f16_fortran": np.asfortranarray(np.arange(6, dtype=np.float16).reshape(2, 3)),
}
SCALARS = {"f32": np.float32(1.5), "i32": np.int32(-3), "bool": np.bool_(True), "u64": np.uint64(9)}


@pytest.mark.parametrize("name", list(VALUES))
def test_codec_round_trips_and_matches_msgpack(name):
    value = VALUES[name]
    data = _msgpack.packb(value)
    assert _msgpack.unpackb(data) == value
    # flax's reader (msgpack with its extension hook) reads what the port writes
    assert msgpack.unpackb(data, raw=False, strict_map_key=False,
                           ext_hook=serialization._msgpack_ext_unpack) == value  # fmt: skip
    if name != "complex":  # msgpack writes no complex itself
        assert _msgpack.unpackb(msgpack.packb(value, use_bin_type=True)) == value


def _same_array(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(ARRAYS))
def test_codec_arrays_match_flax(name):
    arr = ARRAYS[name]
    want = np.array(arr, order="C")
    _same_array(_msgpack.unpackb(_msgpack.packb({"a": arr}))["a"], want)
    _same_array(serialization.msgpack_restore(_msgpack.packb({"a": arr}))["a"], want)
    _same_array(_msgpack.unpackb(serialization.msgpack_serialize({"a": arr}))["a"], want)
    assert _msgpack.unpackb(_msgpack.packb(arr)).flags.writeable


@pytest.mark.parametrize("name", list(SCALARS))
def test_codec_numpy_scalars_match_flax(name):
    x = SCALARS[name]
    _same_array(_msgpack.unpackb(_msgpack.packb(x)), x)
    _same_array(serialization.msgpack_restore(_msgpack.packb({"s": x}))["s"], x)
    _same_array(_msgpack.unpackb(serialization.msgpack_serialize({"s": x}))["s"], x)


def test_codec_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        _msgpack.packb({"a": object()})
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb("abcdef")[:-1])


def _tree(rng, scale=1.0):
    return {"params": {mod: {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in leaves.items()}
                       for mod, leaves in SHAPES.items()}}  # fmt: skip


def _jax_tx(schedule, clip=False):
    tx = jo.make_optimizer(schedule=schedule, **OPT)
    if not clip:
        return tx
    # the chain JAX's make_optimizer means to build with max_grad_norm (its
    # function-local import makes it raise; tests/test_torch_optim.py)
    inner = jo.make_optimizer(schedule="none" if schedule == "reduce_on_plateau" else schedule, **OPT)
    tx = optax.chain(optax.clip_by_global_norm(1.0), inner)
    if schedule == "reduce_on_plateau":
        tx = optax.chain(tx, optax.contrib.reduce_on_plateau(patience=1, factor=0.1, accumulation_size=1))
    return tx


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return (a.shape, a.dtype.name)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("schedule", ["none", *SCHEDULES])
def test_opt_state_layout_is_flax_state_dict(schedule, clip):
    params = _tree(np.random.default_rng(0))
    state = jdp.TrainState.create(params, _jax_tx(schedule, clip))
    want = serialization.to_state_dict(state.opt_state)
    tx = to.make_optimizer(schedule=schedule, max_grad_norm=1.0 if clip else None, **OPT)
    got = opt_state_to_optax_tree(tx.init(params_from_flax(params)), tx)
    assert _layout(got) == _layout(want)


def _jax_states(schedule, n_steps=2):
    """A JAX TrainState after ``n_steps`` steps (loss values 2.0, 3.0, ...:
    the plateau stage reduces its scale once), with its gradients."""
    tx = _jax_tx(schedule)
    state = jdp.TrainState.create(_tree(np.random.default_rng(1)), tx)
    rng = np.random.default_rng(2)
    grads = [_tree(rng, 0.1) for _ in range(n_steps + 1)]
    for i in range(n_steps):
        extra = {"value": jnp.float32(2.0 + i)} if schedule == "reduce_on_plateau" else {}
        updates, opt = tx.update(grads[i], state.opt_state, state.params, **extra)
        state = state.replace(params=optax.apply_updates(state.params, updates), opt_state=opt,
                              step=state.step + 1)  # fmt: skip
    return tx, state, grads


def _assert_port_state(got: TrainState, params, opt_state, step):
    assert got.step == step
    for k, v in params_from_flax(params).items():
        assert got.params[k].dtype == torch.float32
        torch.testing.assert_close(got.params[k], v, rtol=0, atol=0)
    want = opt_state_from_optax(opt_state, device="cpu")
    assert got.opt_state["count"] == want["count"] == step
    for name in ("mu", "nu", "nu_max"):
        for k, v in want[name].items():
            torch.testing.assert_close(got.opt_state[name][k], v, rtol=0, atol=0)
    assert ("plateau" in got.opt_state) == ("plateau" in want)
    for k, v in want.get("plateau", {}).items():
        assert got.opt_state["plateau"][k].dtype == v.dtype
        torch.testing.assert_close(got.opt_state["plateau"][k], v, rtol=0, atol=0)


def _port_template(schedule):
    tx = to.make_optimizer(schedule=schedule, **OPT)
    params = {k: torch.zeros_like(v) for k, v in params_from_flax(_tree(np.random.default_rng(9))).items()}
    return tx, TrainState.create(params, tx)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_jax_checkpoint_loads_in_the_port(schedule, tmp_path):
    _, state, _ = _jax_states(schedule)
    jck.save_checkpoint(tmp_path / "jax.ckpt", state)
    _, template = _port_template(schedule)
    got = tck.load_checkpoint(tmp_path / "jax.ckpt", template)
    _assert_port_state(got, state.params, state.opt_state, 2)
    if schedule == "reduce_on_plateau":
        assert float(got.opt_state["plateau"]["scale"]) == np.float32(0.1)  # the reduction happened


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_port_checkpoint_loads_in_jax(schedule, tmp_path):
    jtx, jstate, grads = _jax_states(schedule)
    tx, _ = _port_template(schedule)
    # the port's state: JAX's after two steps, stepped once more by the port
    port = TrainState(params_from_flax(jstate.params), opt_state_from_optax(jstate.opt_state, "cpu"), 2)
    value = {"value": torch.tensor(4.0)} if schedule == "reduce_on_plateau" else {}
    updates, opt = tx.update(params_from_flax(grads[2]), port.opt_state, port.params, **value)
    port = TrainState({k: p + updates[k] for k, p in port.params.items()}, opt, 3)
    tck.save_checkpoint(tmp_path / "port.ckpt", port, tx)

    template = jdp.TrainState.create(jstate.params, jtx)
    restored = jck.load_checkpoint(tmp_path / "port.ckpt", template)
    want = serialization.to_state_dict(
        jdp.TrainState(params=params_to_flax(port.params),
                       opt_state=opt_state_to_optax_tree(port.opt_state, tx), step=np.int32(3))
    )  # fmt: skip
    got = serialization.to_state_dict(restored)
    assert _layout(got) == _layout(serialization.to_state_dict(template))
    for (kp, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree_util.tree_flatten_with_path(want)[0]):  # fmt: skip
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(kp))
    assert int(restored.step) == 3
    # JAX resumes: its next update from the restored state is the port's
    extra = {"value": jnp.float32(5.0)} if schedule == "reduce_on_plateau" else {}
    jup, _ = jtx.update(grads[0], restored.opt_state, restored.params, **extra)
    value = {"value": torch.tensor(5.0)} if schedule == "reduce_on_plateau" else {}
    tup, _ = tx.update(params_from_flax(grads[0]), port.opt_state, port.params, **value)
    for k, v in params_from_flax(jup).items():
        torch.testing.assert_close(tup[k], v, rtol=1e-6, atol=1e-10)


def test_load_params_across_optimizers(tmp_path):
    _, jstate, _ = _jax_states("reduce_on_plateau")
    jck.save_checkpoint(tmp_path / "jax.ckpt", jstate)
    tx, template = _port_template("cosine_warm_restarts")
    got = tck.load_params(tmp_path / "jax.ckpt", template.params)
    for k, v in params_from_flax(jstate.params).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # a port checkpoint of another optimizer, read by the port and by JAX
    port = TrainState(got, tx.init(got), 0)
    tck.save_checkpoint(tmp_path / "port.ckpt", port, tx)
    again = tck.load_params(tmp_path / "port.ckpt", template.params)
    assert all(torch.equal(again[k], got[k]) for k in got)
    jparams = jck.load_params(tmp_path / "port.ckpt", jstate.params)
    for k, v in params_from_flax(jparams).items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)
    # a params-only file
    (tmp_path / "params.ckpt").write_bytes(serialization.msgpack_serialize(jax.device_get(jstate.params)))
    only = tck.load_params(tmp_path / "params.ckpt", template.params)
    assert all(torch.equal(only[k], got[k]) for k in got)


def test_load_checkpoint_refuses_another_model_or_optimizer(tmp_path):
    tx, template = _port_template("reduce_on_plateau")
    tck.save_checkpoint(tmp_path / "c.ckpt", template, tx)
    params = dict(template.params)
    params["Layer_0.kernel"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="shape"):
        tck.load_checkpoint(tmp_path / "c.ckpt", TrainState(params, template.opt_state, 0))
    del params["Layer_0.kernel"]
    with pytest.raises(ValueError, match="names"):
        tck.load_params(tmp_path / "c.ckpt", params)
    cos_tx, cos_template = _port_template("cosine_warm_restarts")
    with pytest.raises(ValueError, match="plateau"):
        tck.load_checkpoint(tmp_path / "c.ckpt", cos_template)


def test_latest_checkpoint(tmp_path):
    assert tck.latest_checkpoint(tmp_path) is None
    for i, name in enumerate(("a.ckpt", "b.ckpt", "c.ckpt")):
        (tmp_path / name).write_bytes(b"")
        os.utime(tmp_path / name, (1000 + (i * 7) % 3, 1000 + (i * 7) % 3))
    assert tck.latest_checkpoint(tmp_path) == jck.latest_checkpoint(tmp_path)


def test_model_checkpoint_restores_into_the_jax_init(tmp_path):
    # the toy config's model: the port's parameter names and shapes are those
    # of the JAX init, and a port checkpoint restores into its TrainState
    jmp = jconfig.model_params_from_config(jconfig.load_config(TOY), 4)

    def init(pos):
        h = jbuild(pos, 0.2, jmp.nr_downsamples, (2048, 1024, 512))
        return jlnn.LNN(jmp).init(jax.random.PRNGKey(0), h, pos, jnp.zeros((256, 1)))

    # the init's tree by tracing alone (shapes and dtypes), as zeros
    shapes = jax.eval_shape(init, jax.ShapeDtypeStruct((256, 3), jnp.float32))
    jparams = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
    model = LNN(tconfig.model_params_from_config(tconfig.load_config(TOY), 4),
                torch.Generator().manual_seed(0), device="cpu")  # fmt: skip
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in params_from_flax(jparams).items()}
    tx = to.make_optimizer(schedule="reduce_on_plateau", plateau_accumulation=6)
    state = TrainState.create(model.state_dict(), tx)
    tck.save_checkpoint(tmp_path / "m.ckpt", state, tx)
    jtx = jo.make_optimizer(schedule="reduce_on_plateau", plateau_accumulation=6)
    template = jdp.TrainState.create(jparams, jtx)
    restored = jck.load_checkpoint(tmp_path / "m.ckpt", template)
    for k, v in params_from_flax(restored.params).items():
        torch.testing.assert_close(v, state.params[k], rtol=0, atol=0)
    assert _layout(serialization.to_state_dict(restored)) == _layout(
        serialization.to_state_dict(template))
