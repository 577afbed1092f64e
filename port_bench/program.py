"""The system under test: the only module of the benchmark that imports the
port (``lattice_net_tpu_torch``).  It builds the port's objects from a
configuration file and the weights the benchmark made, and exposes the
public calls the traffic drives, with the spans and counters the per-layer
metrics read.
"""

from __future__ import annotations

import contextlib

import torch

from lattice_net_tpu_torch.lattice import ops as port_ops
from lattice_net_tpu_torch.lattice.structure import (
    build_hierarchy,
    default_capacity_schedule,
)
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.ops_cuda import _build
from lattice_net_tpu_torch.parallel import data_parallel as dp
from lattice_net_tpu_torch.serve import Predictor
from lattice_net_tpu_torch.train.optim import make_optimizer
from lattice_net_tpu_torch.train.setup import scout_occupancy

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels(device) -> None:
    """Build (first run in a checkout) or find the six CUDA kernels in the
    port's own cache, ``lattice_net_tpu_torch/build/``."""
    if torch.device(device).type == "cuda":
        _build.build_all(_build.SOURCES)


def model_params(cfg: dict) -> ModelParams:
    return ModelParams(nr_classes=cfg["nr_classes"], **{
        k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()})  # fmt: skip


def make_model(cfg: dict, device) -> LNN:
    """The port's LNN of the configuration, in its conv dtype; its start
    weights are replaced by :func:`seeded_weights`' before any use."""
    gen = torch.Generator().manual_seed(0)
    return LNN(model_params(cfg), gen, device=device, conv_dtype=DTYPES[cfg["conv_dtype"]])


def seeded_weights(model: LNN, seed: int, device) -> dict:
    """``{name: tensor}`` weights drawn from ``seed`` on ``device`` in one
    call: each leaf a normal draw with the mean and spread of the
    initialiser's draw for that leaf (constant leaves, the norms' scales and
    biases, stay constant)."""
    init = {k: v.detach() for k, v in model.state_dict().items()}
    total = sum(v.numel() for v in init.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in init.items():
        n = v.numel()
        std = v.float().std() if n > 1 else torch.zeros((), device=device)
        out[k] = (z[at : at + n].reshape(v.shape) * std + v.float().mean()).to(v.dtype)
        at += n
    return out


def capacities(cfg: dict, section: str, scout_positions=(), device=None) -> tuple:
    """The per-level capacities of the config's ``lattice_<section>``:
    halving from ``hash_table_capacity``, or in the "auto" mode the port's
    ``scout_occupancy`` of ``scout_positions`` with the headroom."""
    lat = cfg[f"lattice_{section}"]
    nd = cfg["model"]["nr_downsamples"]
    upper = default_capacity_schedule(lat["hash_table_capacity"], nd)
    if lat["capacity_mode"] == "fixed":
        return tuple(upper)
    _, caps = scout_occupancy(model_params(cfg), lat["sigma"], upper, scout_positions,
                              lat["capacity_headroom"], upper, device)  # fmt: skip
    return tuple(int(c) for c in caps)


class Served:
    """``Predictor`` on the config's serving lattice."""

    def __init__(self, cfg, weights, caps, budget, device):
        model = make_model(cfg, device)
        model.load_state_dict(weights)
        self.predictor = Predictor(model.eval(), cfg["lattice_serve"]["sigma"], caps, budget, torch.device(device))

    def label(self, positions, values):
        """The timed path: ``Predictor.forward``, argmax, the labels' copy
        to the host (what ``Predictor.predict`` does); returns (labels on the
        host, log-probabilities, hierarchy)."""
        logp, h = self.predictor.forward(positions, values)
        with torch.inference_mode():
            labels = torch.argmax(logp, dim=-1)[: len(positions)].cpu()
        return labels, logp, h

    def label_staged(self, positions, values, clock):
        """:meth:`label` in its stages, each timed by ``clock(name)`` (a
        context manager): ``batch`` (pad, mask, copy), ``build``
        (``build_hierarchy``) and ``model`` (the LNN)."""
        p = self.predictor
        with clock("batch"):
            pos, val, mask = p._batch(positions, values)
        with torch.inference_mode():
            with clock("build"):
                h = build_hierarchy(pos, p.sigma, p.params.nr_downsamples, p.capacities,
                                    point_mask=mask, point_feats=val)  # fmt: skip
            with clock("model"):
                logp, _ = p.model(h, pos, val)
            labels = torch.argmax(logp, dim=-1)[: len(positions)].cpu()
        return labels, logp, h


class Trained:
    """``make_train_step``'s step of the config's model and optimizer on the
    train lattice, from the benchmark's weights."""

    def __init__(self, cfg, weights, caps, device):
        self.model = make_model(cfg, device)
        lat = cfg["lattice_train"]
        self.tx = make_optimizer(**cfg["optimizer"])
        nd = cfg["model"]["nr_downsamples"]
        self.step = dp.make_train_step(self.model, self.tx, lat["sigma"], nd, caps)
        self.loss_fn = dp.make_loss_fn(self.model, lat["sigma"], nd, caps)
        self.state = dp.TrainState.create({k: v.clone() for k, v in weights.items()}, self.tx)
        self.sigma, self.caps, self.device = lat["sigma"], caps, device

    def batch(self, host_batch):
        return dp.to_device(host_batch, self.device)

    def train(self, host_batch):
        """The timed path: the batch's copy to the card and one step;
        returns the step's metrics (on the device)."""
        self.state, metrics = self.step(self.state, self.batch(host_batch))
        return metrics

    def train_staged(self, host_batch, clock):
        """:meth:`train` from ``make_train_step``'s three public stages, each
        timed by ``clock(name)``: ``forward_loss``, ``backward``
        (``gradients``) and ``update`` (``apply_update``)."""
        batch = self.batch(host_batch)
        with clock("forward_loss"):
            leaves, loss, metrics = dp.forward_loss(self.loss_fn, self.state.params, batch)
        with clock("backward"):
            grads = dp.gradients(loss, leaves)
        with clock("update"):
            self.state = dp.apply_update(self.tx, self.state, grads, loss)
        return metrics

    def hierarchies(self, host_batch):
        """The hierarchy of each cloud of the batch, as the step builds it."""
        b = self.batch(host_batch)
        with torch.inference_mode():
            return [build_hierarchy(b["positions"][i], self.sigma, self.model.params.nr_downsamples, self.caps,
                                    point_mask=b["point_mask"][i]) for i in range(b["positions"].shape[0])]  # fmt: skip


def make_host_batch(clouds, budget):
    """The step's host batch of a list of (positions, values, target)."""
    return dp.make_host_batch(clouds, budget)


def occupancy(h) -> list:
    return [int(s.nr_verts) for s in h.structures]


@contextlib.contextmanager
def recording_k1():
    """Records the shapes and the id table of every K1 call made inside the
    block at its dispatch point in ``lattice/ops`` (as ``chip_smoke.py``'s
    recorder does, without copies): yields the list of ``(rows, channels,
    itemsize, neighbors, include_center, row0)``."""
    calls = []
    k1 = port_ops.patch_gather

    def recording(values, neighbors, include_center, plain=False, row0=0):
        calls.append((values.shape[0], values.shape[1], values.element_size(), neighbors,
                      bool(include_center), int(row0)))  # fmt: skip
        return k1(values, neighbors, include_center, plain=plain, row0=row0)

    port_ops.patch_gather = recording
    try:
        yield calls
    finally:
        port_ops.patch_gather = k1
