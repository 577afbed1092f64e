"""LNN: the LatticeNet U-Net over a sparse permutohedral lattice.

A frozen copy of the port's ``models/lnn.py`` on its default path:
distribute -> PointNet -> [resnet/bottleneck blocks, coarsen] x D ->
bottleneck blocks -> [finefy, concat skip, blocks] x D -> deformable
slice-classify -> log-softmax, every conv in f32.  Submodules carry the
port's names (``ResnetBlock_0``, ``CoarsenAct_1``, ...), so the port's
``state_dict`` loads one to one.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import ops as lops
from . import modules as lnm

_VALUE_CHANNELS = {
    "none": 1, "intensity": 1, "rgb": 3, "rgb+height": 4, "rgb+xyz": 6, "height": 1, "xyz": 3,
}  # fmt: skip
# the reference's ablation modes; the last three keep the vertex-mean
# positions in the distribute's rows (no local mean), with the same weights
EXPERIMENTS = (
    "none", "slice_no_deform", "pointnet_no_local_mean", "pointnet_no_elevate_no_local_mean", "splat",
)  # fmt: skip
NO_LOCAL_MEAN = EXPERIMENTS[2:]


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Static model hyper-parameters (the JAX package's ``ModelParams``).
    ``dropout_last_layer`` is the head's whole-channel dropout in training;
    ``experiment`` is one of ``EXPERIMENTS``; ``remat_blocks``, the port's
    recompute of every block in the backward, changes no number and is
    ignored here."""

    nr_classes: int = 6
    positions_mode: str = "xyz"
    values_mode: str = "none"
    pointnet_channels_per_layer: tuple = (16, 32, 64)
    pointnet_start_nr_channels: int = 32
    nr_downsamples: int = 3
    nr_blocks_down_stage: tuple = (4, 4, 4)
    nr_blocks_bottleneck: int = 3
    nr_blocks_up_stage: tuple = (2, 2, 2)
    nr_levels_down_with_normal_resnet: int = 3
    nr_levels_up_with_normal_resnet: int = 2
    compression_factor: float = 1.0
    dropout_last_layer: float = 0.0
    experiment: str = "none"
    remat_blocks: bool = False


_POSITION_DIMS = {"xyz": 3, "xyz+intensity": 4, "xyz+rgb": 6}


def input_dims(p: ModelParams) -> tuple:
    """(pos_dim, value channels) of the configuration's modes: the
    lattice has d = 3 for "xyz", 4 for "xyz+intensity" and 6 for
    "xyz+rgb"."""
    if p.positions_mode not in _POSITION_DIMS:
        raise ValueError(f"positions mode {p.positions_mode} not implemented")
    if p.values_mode not in _VALUE_CHANNELS:
        raise ValueError(f"values mode {p.values_mode} not implemented")
    return _POSITION_DIMS[p.positions_mode], _VALUE_CHANNELS[p.values_mode]


def channel_plan(p: ModelParams):
    """Static channel bookkeeping of the U-Net."""
    cur = p.pointnet_start_nr_channels
    skips = []
    down = []
    for _ in range(p.nr_downsamples):
        skips.append(cur)
        after = int(cur * 2 * p.compression_factor)
        down.append((cur, after))
        cur = after
    up = []
    for _ in range(p.nr_downsamples):
        skip = skips.pop()
        finefy_out = cur // 2
        up.append((cur, finefy_out, skip))
        cur = skip + finefy_out
    return down, up, cur


class LNN(nn.Module):
    """The U-Net.

    Args:
      params: model hyper-parameters.
      generator: ``torch.Generator`` the initialisers draw from.
      device: where the parameters live.
    """

    def __init__(self, params: ModelParams, generator: torch.Generator, device):
        super().__init__()
        if params.experiment not in EXPERIMENTS:
            raise ValueError(f"unknown experiment {params.experiment!r}: one of {EXPERIMENTS}")
        self.params = params
        pos_dim, value_channels = input_dims(params)
        gen = generator
        kw = dict(pos_dim=pos_dim)
        p = params
        self.PointNetModule_0 = lnm.PointNetModule(
            pos_dim + value_channels,
            tuple(p.pointnet_channels_per_layer),
            p.pointnet_start_nr_channels,
            gen,
            **kw,
        )
        down_plan, up_plan, final_channels = channel_plan(p)
        counts = {"ResnetBlock": 0, "BottleneckBlock": 0}

        def block(resnet: bool, channels: int, is_last: bool = False) -> str:
            kind = "ResnetBlock" if resnet else "BottleneckBlock"
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            if resnet:
                mod = lnm.ResnetBlock(channels, gen, (False, is_last), **kw)
            else:
                mod = lnm.BottleneckBlock(channels, gen, (False, False, is_last), **kw)
            self.add_module(name, mod)
            return name

        self._down = []
        for i in range(p.nr_downsamples):
            cur, after = down_plan[i]
            resnet = i < p.nr_levels_down_with_normal_resnet
            names = [block(resnet, cur) for _ in range(p.nr_blocks_down_stage[i])]
            self.add_module(f"CoarsenAct_{i}", lnm.CoarsenAct(cur, after, gen, **kw))
            self._down.append(names)
        bott_ch = down_plan[-1][1]
        self._bottleneck = [block(False, bott_ch) for _ in range(p.nr_blocks_bottleneck)]
        self._up = []
        for i in range(p.nr_downsamples):
            cur, finefy_out, skip_ch = up_plan[i]
            self.add_module(f"GnReluFinefy_{i}", lnm.GnReluFinefy(cur, finefy_out, gen, **kw))
            ch = skip_ch + finefy_out
            resnet = i >= p.nr_downsamples - p.nr_levels_up_with_normal_resnet
            nb = p.nr_blocks_up_stage[i]
            last_stage = i == p.nr_downsamples - 1
            self._up.append([block(resnet, ch, last_stage and j == nb - 1) for j in range(nb)])
        self.SliceFastModule_0 = lnm.SliceFastModule(
            final_channels, p.nr_classes, gen, dropout=p.dropout_last_layer,
            experiment=p.experiment,
        )  # fmt: skip
        self.to(device)

    def forward(self, h, positions, values, train=None):
        """-> (log-probabilities (N, classes), logits (N, classes)), f32.
        ``train`` (default ``self.training``) is the training mode."""
        p = self.params
        train = self.training if train is None else train
        cap0 = h.structures[0].capacity
        masks = [s.occupancy_mask() for s in h.structures]
        rows_sorted, _ = lops.distribute_sorted(
            positions, values, h.edges, cap0, subtract_local_mean=p.experiment not in NO_LOCAL_MEAN
        )
        lv = self.PointNetModule_0(rows_sorted, h.edges, cap0, h.neighbors_same[0])

        def block(name, lv, lvl):
            return getattr(self, name)(lv, h.neighbors_same[lvl], masks[lvl])

        skip_values = []
        for i, names in enumerate(self._down):
            for name in names:
                lv = block(name, lv, i)
            skip_values.append(lv)
            # the finefy table is the coarsen table's exact transpose: it
            # routes the backward through the flip-neighbours adjoint
            coarsen = getattr(self, f"CoarsenAct_{i}")
            lv = coarsen(lv, h.neighbors_coarsen[i], h.neighbors_finefy[i])

        lvl = p.nr_downsamples
        for name in self._bottleneck:
            lv = block(name, lv, lvl)

        for i, names in enumerate(self._up):
            lvl = p.nr_downsamples - 1 - i  # the finer level we go to
            finefy = getattr(self, f"GnReluFinefy_{i}")
            lv = finefy(
                lv, h.neighbors_finefy[lvl], masks[lvl + 1], h.neighbors_coarsen[lvl]
            )
            lv = torch.cat([lv, skip_values.pop()], dim=-1)
            for name in names:
                lv = block(name, lv, lvl)

        logits = self.SliceFastModule_0(lv, masks[0], h.splat_idx, h.splat_weights, train)
        return torch.log_softmax(logits, dim=-1), logits
