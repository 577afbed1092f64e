"""Full train-state checkpoints (parameters, optimizer state, step) in flax's
msgpack layout (counterpart of ``lattice_net_tpu/train/checkpoint.py``).

The file holds what ``flax.serialization.to_bytes`` writes for the JAX
package's ``TrainState``: ``{"params": {"params": ...}, "opt_state": ...,
"step": int32 array}``, the optimizer state in the layout of the JAX
``make_optimizer`` chain (``interop.opt_state_to_optax_tree``).  So a run
that JAX saved resumes in the port, and a run that the port saved resumes
in JAX.  The codec is ``train._msgpack`` (standard library and numpy).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.interop import (
    opt_state_from_optax,
    opt_state_to_optax_tree,
    params_from_flax,
    params_to_flax,
)
from lattice_net_tpu_torch.parallel.data_parallel import TrainState
from lattice_net_tpu_torch.train import _msgpack


def save_checkpoint(path, state: TrainState, tx) -> None:
    """Write ``state`` (of the optimizer ``tx``) to ``path``, through a
    temporary file, so that a crash never leaves half a checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {
        "params": params_to_flax(state.params),
        "opt_state": opt_state_to_optax_tree(state.opt_state, tx),
        "step": np.asarray(state.step, np.int32),
    }
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(_msgpack.packb(tree))
    tmp.replace(path)


def _like(tensors: dict, template: dict, what: str) -> dict:
    """``tensors`` on the devices and in the dtypes of ``template``, whose
    names and shapes they must have."""
    if set(tensors) != set(template):
        missing, extra = sorted(set(template) - set(tensors)), sorted(set(tensors) - set(template))
        raise ValueError(f"{what}: names differ: missing {missing}, unexpected {extra}")
    out = {}
    for k, t in template.items():
        if tensors[k].shape != t.shape:
            raise ValueError(f"{what}: {k} has shape {tuple(tensors[k].shape)}, expected {tuple(t.shape)}")
        out[k] = tensors[k].to(device=t.device, dtype=t.dtype)
    return out


def load_checkpoint(path, target: TrainState) -> TrainState:
    """The state saved at ``path``, with ``target``'s names, shapes, dtypes
    and devices (``target`` is a state of the run's model and optimizer,
    e.g. ``TrainState.create(model.state_dict(), tx)``)."""
    raw = _msgpack.unpackb(Path(path).read_bytes())
    device = next(iter(target.params.values())).device
    params = _like(params_from_flax(raw["params"]), target.params, "params")
    opt = opt_state_from_optax(raw["opt_state"], device=device)
    if ("plateau" in opt) != ("plateau" in target.opt_state):
        raise ValueError("the checkpoint's optimizer and the run's differ in the plateau stage")
    for name in ("mu", "nu", "nu_max"):
        opt[name] = _like(opt[name], target.opt_state[name], f"opt_state.{name}")
    return TrainState(params=params, opt_state=opt, step=int(raw["step"]))


def load_params(path, template: dict) -> dict:
    """Only the model parameters of a checkpoint, as tensors like
    ``template`` (``{name: tensor}``, e.g. ``model.state_dict()``), whatever
    optimizer wrote it; a params-only file is read too."""
    raw = _msgpack.unpackb(Path(path).read_bytes())
    sub = raw.get("params", raw)
    return _like(params_from_flax(sub), {k: v.detach() for k, v in template.items()}, "params")


def latest_checkpoint(directory):
    """The newest ``*.ckpt`` in ``directory`` by modification time, or None."""
    ckpts = sorted(Path(directory).glob("*.ckpt"), key=lambda p: p.stat().st_mtime)
    return ckpts[-1] if ckpts else None

