"""LNN: the LatticeNet U-Net over a sparse permutohedral lattice.

Counterpart of ``lattice_net_tpu/models/lnn.py``: distribute -> PointNet ->
[resnet/bottleneck blocks, coarsen] x D -> bottleneck blocks -> [finefy,
concat skip, blocks] x D -> deformable slice-classify -> log-softmax.
Submodules carry the flax names (``ResnetBlock_0``, ``CoarsenAct_1``, ...),
so the flax params tree loads one to one (``interop.params_from_flax``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import ops as lops
from lattice_net_tpu_torch.nn import modules as lnm

_VALUE_CHANNELS = {
    "none": 1, "intensity": 1, "rgb": 3, "rgb+height": 4, "rgb+xyz": 6, "height": 1, "xyz": 3,
}  # fmt: skip


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Static model hyper-parameters (the JAX package's ``ModelParams``, less
    its ``remat_blocks``).  Channel dropout is not ported yet: a model with
    ``dropout_last_layer > 0`` serves (dropout is off at inference) but does
    not train."""

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


def input_dims(p: ModelParams) -> tuple:
    """(pos_dim, value channels) that ``prepare_cloud`` produces.  Only the
    "xyz" positions mode is served: the port packs lattice keys of d <= 3."""
    if p.positions_mode != "xyz":
        raise NotImplementedError(f"positions mode {p.positions_mode!r} is not ported (d > 3)")
    return 3, _VALUE_CHANNELS[p.values_mode]


def prepare_cloud(cloud, model_params: ModelParams):
    """Map a cloud record (numpy attrs V, C, I, L_gt) to (positions, values,
    target) per the config modes."""
    input_dims(model_params)
    positions = np.asarray(cloud.V, np.float32)

    vm = model_params.values_mode
    if vm == "none":
        values = np.zeros((positions.shape[0], 1), np.float32)
    elif vm == "intensity":
        values = np.asarray(cloud.I, np.float32)
    elif vm == "rgb":
        values = np.asarray(cloud.C, np.float32)
    elif vm == "rgb+height":
        values = np.concatenate([cloud.C, cloud.V[:, 1:2]], axis=1).astype(np.float32)
    elif vm == "rgb+xyz":
        values = np.concatenate([cloud.C, cloud.V], axis=1).astype(np.float32)
    elif vm == "height":
        values = np.asarray(cloud.V[:, 1:2], np.float32)
    elif vm == "xyz":
        values = np.asarray(cloud.V, np.float32)
    else:
        raise ValueError(f"values mode {vm} not implemented")

    target = np.asarray(cloud.L_gt, np.int32).reshape(-1)
    return positions, values, target


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
      device: where the parameters live (default ``cuda``, raises without a
        card; pass ``"cpu"`` for the plain path).
      conv_dtype: compute type of every lattice conv (bf16 by default, the
        JAX package's accelerator policy; f32 is what JAX computes on the CPU).
    """

    def __init__(
        self,
        params: ModelParams,
        generator: torch.Generator,
        device=None,
        conv_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        device = resolve_device(device)
        if params.experiment != "none":
            raise NotImplementedError(f"experiment {params.experiment!r} is not ported")
        self.params = params
        pos_dim, value_channels = input_dims(params)
        gen = generator
        kw = dict(pos_dim=pos_dim, conv_dtype=conv_dtype)
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
        self.SliceFastModule_0 = lnm.SliceFastModule(final_channels, p.nr_classes, gen)
        self.to(device)

    def forward(self, h, positions, values, plain=False):
        """-> (log-probabilities (N, classes), logits (N, classes)), f32.

        In training mode (``self.training``, the JAX ``deterministic=False``)
        a model with ``dropout_last_layer > 0`` raises: channel dropout is
        not ported."""
        p = self.params
        if self.training and p.dropout_last_layer > 0.0:
            raise NotImplementedError("dropout_last_layer > 0 needs channel_dropout (not ported)")
        cap0 = h.structures[0].capacity
        masks = [s.occupancy_mask() for s in h.structures]
        rows_sorted, _ = lops.distribute_sorted(positions, values, h.edges, cap0)
        lv = self.PointNetModule_0(rows_sorted, h.edges, cap0, h.neighbors_same[0], plain=plain)

        skip_values = []
        for i, names in enumerate(self._down):
            for name in names:
                lv = getattr(self, name)(lv, h.neighbors_same[i], masks[i], plain=plain)
            skip_values.append(lv)
            # the finefy table is the coarsen table's exact transpose: it
            # routes the backward through the flip-neighbours adjoint
            coarsen = getattr(self, f"CoarsenAct_{i}")
            lv = coarsen(lv, h.neighbors_coarsen[i], h.neighbors_finefy[i], plain=plain)

        lvl = p.nr_downsamples
        for name in self._bottleneck:
            lv = getattr(self, name)(lv, h.neighbors_same[lvl], masks[lvl], plain=plain)

        for i, names in enumerate(self._up):
            lvl = p.nr_downsamples - 1 - i  # the finer level we go to
            finefy = getattr(self, f"GnReluFinefy_{i}")
            lv = finefy(
                lv, h.neighbors_finefy[lvl], masks[lvl + 1], h.neighbors_coarsen[lvl], plain=plain
            )
            lv = torch.cat([lv, skip_values.pop()], dim=-1)
            for name in names:
                lv = getattr(self, name)(lv, h.neighbors_same[lvl], masks[lvl], plain=plain)

        logits = self.SliceFastModule_0(
            lv, masks[0], h.splat_idx, h.splat_weights, plain=plain
        )
        return torch.log_softmax(logits, dim=-1), logits
