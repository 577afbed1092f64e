"""A training run's model, optimizer and lattice settings from a ``.cfg``
file: the setup half of the JAX package's ``train/ln_train.py`` (the
trainer loop, loaders and checkpoints are not ported yet).
"""

from __future__ import annotations

import dataclasses

import torch

from lattice_net_tpu_torch.config import (
    LatticeParams,
    TrainParams,
    load_config,
    model_params_from_config,
)
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import default_capacity_schedule
from lattice_net_tpu_torch.models.lnn import LNN
from lattice_net_tpu_torch.parallel.data_parallel import make_loss_fn, make_train_step
from lattice_net_tpu_torch.train.optim import AdamWAmsgrad, make_optimizer


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    model: LNN
    tx: AdamWAmsgrad
    sigma: object
    capacities: tuple

    @classmethod
    def from_config(
        cls,
        path,
        nr_classes: int,
        steps_per_epoch: int,
        device=None,
        conv_dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ) -> "TrainSetup":
        """The JAX trainer's choices: fixed capacities halving from
        ``hash_table_capacity``, AdamW-amsgrad with the config's lr and weight
        decay, and for SemanticKITTI cosine warm restarts with a period of
        three epochs.  Weights are drawn from
        ``torch.Generator().manual_seed(seed)``."""
        device = resolve_device(device)
        cfg = load_config(path)
        lp, tp = LatticeParams.from_config(cfg), TrainParams.from_config(cfg)
        if lp.capacity_mode != "fixed":
            raise NotImplementedError("capacity_mode 'auto' is not ported; use 'fixed'")
        mp = model_params_from_config(cfg, nr_classes)
        sigma = lp.sigmas[0] if len(set(lp.sigmas)) == 1 else tuple(lp.sigmas)
        caps = default_capacity_schedule(lp.hash_table_capacity, mp.nr_downsamples)
        schedule = "cosine_warm_restarts" if tp.dataset_name == "semantickitti" else "reduce_on_plateau"
        tx = make_optimizer(tp.lr, tp.weight_decay, schedule, t0_steps=3 * steps_per_epoch)
        gen = torch.Generator().manual_seed(seed)
        model = LNN(mp, gen, device=device, conv_dtype=conv_dtype)
        return cls(model, tx, sigma, caps)

    def loss_fn(self):
        return make_loss_fn(self.model, self.sigma, self.model.params.nr_downsamples, self.capacities)

    def train_step(self):
        return make_train_step(
            self.model, self.tx, self.sigma, self.model.params.nr_downsamples, self.capacities
        )
