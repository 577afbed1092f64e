"""A training run's model, optimizer and lattice settings from a ``.cfg``
file: the setup half of the JAX package's ``train/ln_train.py``, which the
port's trainer (``train/ln_train.py``) and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lattice_net_tpu_torch.config import (
    LatticeParams,
    TrainParams,
    load_config,
    model_params_from_config,
)
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import (
    build_hierarchy,
    capacity_schedule_from_occupancy,
    default_capacity_schedule,
)
from lattice_net_tpu_torch.models.lnn import LNN
from lattice_net_tpu_torch.parallel.data_parallel import make_loss_fn, make_train_step
from lattice_net_tpu_torch.train.optim import AdamWAmsgrad, make_optimizer


def optimizer_from_config(tp: TrainParams, steps_per_epoch: int) -> AdamWAmsgrad:
    """The JAX trainer's optimizer: AdamW-amsgrad with the config's lr and
    weight decay; for SemanticKITTI cosine warm restarts with a period of
    three epochs, for every other dataset ``reduce_on_plateau`` over the
    mean loss of an epoch's steps."""
    schedule = "cosine_warm_restarts" if tp.dataset_name == "semantickitti" else "reduce_on_plateau"
    return make_optimizer(
        tp.lr, tp.weight_decay, schedule,
        t0_steps=3 * steps_per_epoch, plateau_accumulation=steps_per_epoch,
    )  # fmt: skip


def scout_occupancy(mp, sigma, scout_caps, clouds, headroom, cap_limits, device=None):
    """The largest per-level occupancy (vertices + overflow) of ``clouds``
    built at ``scout_caps``, and the schedule it gives: each level's
    occupancy times ``headroom`` snapped to a power of two, capped at
    ``cap_limits``.  Each cloud is padded to the largest scout size with a
    point mask, as the JAX package pads it, so the occupancies agree.  Runs
    in-process on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    clouds = [np.asarray(v, np.float32) for v in clouds]
    n_scout = max(len(v) for v in clouds)
    occ_max = np.zeros(mp.nr_downsamples + 1, np.int64)
    for v in clouds:
        pad = np.zeros((n_scout - len(v), v.shape[1]), np.float32)
        pos = torch.from_numpy(np.concatenate([v, pad])).to(dev)
        mask = torch.arange(n_scout, device=dev) < len(v)
        with torch.inference_mode():
            h = build_hierarchy(pos, sigma, mp.nr_downsamples, tuple(scout_caps), point_mask=mask)
            occ = np.asarray([int(s.nr_verts) + int(s.nr_overflow) for s in h.structures])
        occ_max = np.maximum(occ_max, occ)
    caps = capacity_schedule_from_occupancy(occ_max, headroom)
    return occ_max, tuple(min(c, m) for c, m in zip(caps, cap_limits))


def capacities_from_config(lp: LatticeParams, mp, clouds=(), device=None) -> tuple:
    """Per-level capacities.  ``"fixed"``: halving from
    ``hash_table_capacity``.  ``"auto"``: :func:`scout_occupancy` of
    ``clouds`` (the trainer passes its first four train clouds' positions) at
    that schedule, which stays the upper bound, with ``capacity_headroom``;
    prints the JAX trainer's line."""
    upper = tuple(default_capacity_schedule(lp.hash_table_capacity, mp.nr_downsamples))
    if lp.capacity_mode == "fixed":
        return upper
    if not clouds:
        raise ValueError("capacity_mode 'auto' sizes the capacities from scout clouds: pass them")
    sigma = lp.sigmas[0] if len(set(lp.sigmas)) == 1 else tuple(lp.sigmas)
    occ_max, caps = scout_occupancy(mp, sigma, upper, clouds, lp.capacity_headroom, upper, device)
    print(f"capacity_mode=auto: occupancy {occ_max.tolist()} -> caps {list(caps)} "
          f"(headroom {lp.capacity_headroom})")  # fmt: skip
    return caps


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    model: LNN
    tx: AdamWAmsgrad
    sigma: object
    capacities: tuple
    generator: torch.Generator  # the head's dropout masks, on the run's device

    @classmethod
    def from_config(
        cls,
        path,
        nr_classes: int,
        steps_per_epoch: int,
        device=None,
        conv_dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        capacities=None,
    ) -> "TrainSetup":
        """The JAX trainer's choices for the config at ``path`` (or a parsed
        config dict): the capacities of :func:`capacities_from_config` (in
        the ``"auto"`` mode the caller passes them) unless ``capacities``
        gives them, and :func:`optimizer_from_config`.
        Weights are drawn from ``torch.Generator().manual_seed(seed)``;
        dropout masks from a generator on the run's device seeded with
        ``seed`` too."""
        device = resolve_device(device)
        cfg = path if isinstance(path, dict) else load_config(path)
        lp, tp = LatticeParams.from_config(cfg), TrainParams.from_config(cfg)
        mp = model_params_from_config(cfg, nr_classes)
        if capacities is None:
            capacities = capacities_from_config(lp, mp)
        sigma = lp.sigmas[0] if len(set(lp.sigmas)) == 1 else tuple(lp.sigmas)
        tx = optimizer_from_config(tp, steps_per_epoch)
        gen = torch.Generator().manual_seed(seed)
        model = LNN(mp, gen, device=device, conv_dtype=conv_dtype)
        caps = tuple(int(c) for c in capacities)
        return cls(model, tx, sigma, caps, torch.Generator(device=device).manual_seed(seed))

    def loss_fn(self):
        return make_loss_fn(self.model, self.sigma, self.model.params.nr_downsamples, self.capacities)

    def train_step(self):
        """``make_train_step``'s step, drawing dropout masks from this run's
        generator unless the caller passes another."""
        step = make_train_step(
            self.model, self.tx, self.sigma, self.model.params.nr_downsamples, self.capacities
        )

        def train_step(state, batch, generator=None):
            return step(state, batch, self.generator if generator is None else generator)

        return train_step
