"""Per-scan serving: one cloud in, one label per point out.

``Predictor`` is the counterpart of the JAX package's ``ln_eval``
predictor (its ``_predict_impl``: ``build_hierarchy`` with the point mask
and the values as carried point features, ``LNN.apply``, ``argmax``)
together with the padding of ``parallel.make_batch``.  A cloud over the
budget raises; ``train/ln_eval.predict_cloud_chunked`` splits one into
chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from lattice_net_tpu_torch.config import LatticeParams, load_config, model_params_from_config
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import (
    PACK_BOUND,
    build_hierarchy,
    default_capacity_schedule,
)
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.train.checkpoint import load_params


class Predictor:
    """A model, its lattice settings and a fixed point budget.

    Clouds are padded to ``n_points`` rows with a point mask (padding makes
    no lattice vertices); a larger cloud raises.
    """

    def __init__(
        self, model: LNN, sigma, capacities: tuple, n_points: int, device: torch.device
    ):
        self.model = model
        self.params: ModelParams = model.params
        self.sigma = sigma
        self.capacities = tuple(capacities)
        self.n_points = int(n_points)
        self.device = device

    @classmethod
    def from_config(
        cls,
        path,
        nr_classes: int,
        device=None,
        conv_dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        n_points: int = 1 << 17,
        checkpoint="",
    ) -> "Predictor":
        """Model and lattice settings from a ``.cfg`` file (or a parsed
        config dict), ``nr_classes`` from the caller (the eval CLI takes it
        from its loader).  The weights are a flax-msgpack ``checkpoint``'s
        (a train state or parameters only, as either package writes them;
        names and shapes must match the model), or, without one, drawn from
        ``torch.Generator().manual_seed(seed)``."""
        device = resolve_device(device)
        cfg = path if isinstance(path, dict) else load_config(path)
        lp = LatticeParams.from_config(cfg)
        if lp.capacity_mode != "fixed":
            raise NotImplementedError("capacity_mode 'auto' is not ported; use 'fixed'")
        mp = model_params_from_config(cfg, nr_classes)
        sigma = lp.sigmas[0] if len(set(lp.sigmas)) == 1 else tuple(lp.sigmas)
        caps = default_capacity_schedule(lp.hash_table_capacity, mp.nr_downsamples)
        gen = torch.Generator().manual_seed(seed)
        model = LNN(mp, gen, device=device, conv_dtype=conv_dtype).eval()
        if checkpoint:
            model.load_state_dict(load_params(checkpoint, model.state_dict()))
        return cls(model, sigma, caps, n_points, device)

    def _batch(self, positions, values):
        positions = np.asarray(positions, np.float32)
        values = np.asarray(values, np.float32)
        n, d = positions.shape
        if values.ndim != 2 or values.shape[0] != n:
            raise ValueError(f"values must be (N, C) matching positions, got {values.shape}")
        if n > self.n_points:
            raise ValueError(f"cloud of {n} points exceeds the budget of {self.n_points}")
        if not (np.isfinite(positions).all() and np.isfinite(values).all()):
            raise ValueError("positions or values contain NaN/Inf")
        sigma = np.broadcast_to(np.asarray(self.sigma, np.float64), (d,))
        max_key = 2.5 * np.max(np.abs(positions) / sigma) + 8
        if max_key >= PACK_BOUND:
            raise ValueError(f"scene too large for packed lattice keys: |key| ~ {max_key:.0f}")
        pad = self.n_points - n
        pos = np.pad(positions, ((0, pad), (0, 0)))
        val = np.pad(values, ((0, pad), (0, 0)))
        mask = np.arange(self.n_points) < n
        return tuple(torch.from_numpy(a).to(self.device) for a in (pos, val, mask))

    def forward(self, positions, values, plain: bool = False):
        """(log-probabilities (n_points, classes), hierarchy) of one padded
        cloud; ``plain`` runs the kernels' plain versions, to hold the
        kernels against them on the card."""
        return self.forward_padded(*self._batch(positions, values), plain=plain)

    def forward_padded(self, pos, val, mask, plain: bool = False):
        """:meth:`forward` of a cloud already padded to ``n_points`` rows on
        the predictor's device, with its point mask."""
        with torch.inference_mode():
            h = build_hierarchy(
                pos,
                self.sigma,
                self.params.nr_downsamples,
                self.capacities,
                point_mask=mask,
                point_feats=val,
            )
            logp, _ = self.model(h, pos, val, plain=plain)
        return logp, h

    def predict(self, positions, values) -> np.ndarray:
        """(N,) int64 labels of the cloud's N points."""
        logp, _ = self.forward(positions, values)
        with torch.inference_mode():
            labels = torch.argmax(logp, dim=-1)
        return labels[: len(positions)].cpu().numpy()
