"""Lattice modules of the LNN (counterpart of ``lattice_net_tpu/nn/modules.py``).

Values are ``(capacity, C)`` tensors padded to the level's capacity; padded
rows may hold garbage after affine ops, and every op that reads across rows
(convs through neighbour tables, GroupNorm statistics, the head gather)
masks by validity.

Submodules and parameters carry the flax names and layouts of the JAX
package (``GnReluConv_0``, ``ConvIm2Row_0/weight`` as (extent * C_in,
C_out), ...), so a flax params tree maps one to one onto a ``state_dict``
(see ``interop.params_from_flax``).  Parameters are drawn at construction
from an explicit ``torch.Generator`` with the reference's initialisers;
shapes that flax infers from the first input (input features, the
neighbourhood extent) are constructor arguments here.

``conv_dtype`` is the compute type of the convs (the JAX package's
accelerator policy is bf16); ``plain=True`` in a forward runs the kernels'
plain versions, forward and backward (see ``lattice.ops``).  Cross-level
convs take their paired table, which routes their backward through the
flip-neighbours adjoint.  Elementwise kinks take JAX's subgradients
(``leaky_relu`` passes the whole cotangent at 0, ``amax`` splits ties), so
that gradients compare entry for entry.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lattice_net_tpu_torch.lattice import ops as lops

LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``jax.nn.leaky_relu``: the same values as ``F.leaky_relu``, with the
    gradient 1 (not ``slope``) at exactly 0."""
    return torch.where(x >= 0, x, slope * x)


def filter_extent(pos_dim: int) -> int:
    """2(d+1) one-hop neighbours plus the centre vertex."""
    return 2 * (pos_dim + 1) + 1


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def kaiming_uniform_rows(shape, fan: float, gen, gain: float = math.sqrt(2.0), mult: float = 1.0):
    """torch kaiming_uniform with an explicit fan (reference conv init)."""
    bound = math.sqrt(3.0) * gain / math.sqrt(fan) * mult
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=gen))


def uniform_bias(shape, fan: float, gen):
    bound = 1.0 / math.sqrt(fan)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=gen))


def kaiming_normal_fan_in(shape, fan_in: float, gen, gain: float = math.sqrt(2.0)):
    return nn.Parameter(torch.empty(shape).normal_(0.0, gain / math.sqrt(fan_in), generator=gen))


def leaky_relu_gain(slope: float = LEAKY_SLOPE) -> float:
    return math.sqrt(2.0 / (1.0 + slope**2))


def _const(shape, value: float):
    return nn.Parameter(torch.full(shape, float(value)))


# ---------------------------------------------------------------------------
# group norm over real vertices only
# ---------------------------------------------------------------------------


def masked_group_norm(lv, mask, num_groups, scale, bias, eps=1e-5):
    """GroupNorm whose statistics ignore padded rows.

    Each group is shifted by its mean over row 0 (always a real vertex:
    sorted tables put valid rows first) before the moments are formed, so
    E[x^2] - E[x]^2 does not cancel when |mean| >> spread."""
    cap, c = lv.shape
    g = num_groups
    gs = c // g
    m = mask[:, None].to(lv.dtype)
    t_g = lv[0].detach().reshape(g, gs).mean(-1)
    count = torch.clamp(m.sum() * gs, min=1.0)
    lvs = lv - t_g.repeat_interleave(gs)
    lvm = lvs * m
    s1 = lvm.sum(0)
    s2 = (lvm * lvs).sum(0)
    gmean_s = s1.reshape(g, gs).sum(-1) / count
    gvar = torch.clamp(s2.reshape(g, gs).sum(-1) / count - gmean_s * gmean_s, min=0.0)
    mean_c = (gmean_s + t_g).repeat_interleave(gs)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(gs)
    return (lv - mean_c) * (inv_c * scale) + bias


def reference_group_count(channels: int, preferred: int = 32) -> int:
    """32 groups when divisible, else C/2."""
    if channels % preferred == 0:
        return preferred
    return max(1, channels // 2)


class GroupNormLattice(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.groups = reference_group_count(channels)
        self.scale = _const((channels,), 1.0)
        self.bias = _const((channels,), 0.0)

    def forward(self, lv, mask):
        return masked_group_norm(lv, mask, self.groups, self.scale, self.bias)


# ---------------------------------------------------------------------------
# linear layers and lattice convolutions
# ---------------------------------------------------------------------------


class WNLinear(nn.Module):
    """Weight-normalised linear: kernel = g * v / ||v|| (norm over input rows)."""

    def __init__(self, in_features: int, features: int, gen, use_bias: bool = True):
        super().__init__()
        gain = leaky_relu_gain()
        self.v = kaiming_uniform_rows((in_features, features), in_features, gen, gain)
        self.g = _const((features,), gain)
        self.bias = _const((features,), 0.0) if use_bias else None

    def forward(self, x):
        norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
        y = x @ (self.v * (self.g[None, :] / torch.clamp(norm, min=1e-12)))
        return y if self.bias is None else y + self.bias


class ConvIm2Row(nn.Module):
    """Same-level 1-hop lattice conv; the centre is the query row itself."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        gen,
        pos_dim: int = 3,
        use_bias: bool = True,
        weight_norm: bool = False,
        conv_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        rows = filter_extent(pos_dim) * in_channels
        self.conv_dtype = conv_dtype
        if weight_norm:
            self.v = kaiming_uniform_rows((rows, out_channels), rows, gen)
            self.g = _const((out_channels,), math.sqrt(2.0))
        else:
            self.weight = kaiming_uniform_rows((rows, out_channels), rows, gen)
        self.bias = uniform_bias((out_channels,), rows, gen) if use_bias else None

    def filter_bank(self):
        if hasattr(self, "v"):
            norm = torch.linalg.vector_norm(self.v, dim=0, keepdim=True)
            return self.v * (self.g[None, :] / torch.clamp(norm, min=1e-12))
        return self.weight

    def forward(self, lv, neighbors, plain=False):
        out = lops.conv_im2row(
            lv, neighbors, self.filter_bank(), True, self.conv_dtype, plain=plain
        )
        return out if self.bias is None else out + self.bias


class _CrossLevelConv(nn.Module):
    """Coarsen/finefy conv body: the neighbour table carries its own centre;
    halved-fan x2 init for the mostly empty neighbourhoods."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        gen,
        pos_dim: int = 3,
        conv_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        rows = filter_extent(pos_dim) * in_channels
        self.conv_dtype = conv_dtype
        self.weight = kaiming_uniform_rows((rows, out_channels), rows / 2.0, gen, mult=2.0)

    def forward(self, lv_src, neighbors, neighbors_t, plain=False):
        return lops.conv_im2row(
            lv_src, neighbors, self.weight, False, self.conv_dtype, plain, neighbors_t
        )


class CoarsenConv(_CrossLevelConv):
    """Fine -> coarse conv; neighbors = hierarchy.neighbors_coarsen[i], its
    pair neighbors_finefy[i]."""


class FinefyConv(_CrossLevelConv):
    """Coarse -> fine conv; neighbors = hierarchy.neighbors_finefy[i], its
    pair neighbors_coarsen[i]."""


# ---------------------------------------------------------------------------
# composed layers (GN -> ReLU -> op)
# ---------------------------------------------------------------------------


class GnRelu1x1(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, gen, use_bias: bool = False):
        super().__init__()
        self.GroupNormLattice_0 = GroupNormLattice(in_channels)
        self.kernel = kaiming_normal_fan_in((in_channels, out_channels), in_channels, gen)
        self.bias = _const((out_channels,), 0.0) if use_bias else None

    def forward(self, lv, mask):
        lv = F.relu(self.GroupNormLattice_0(lv, mask)) @ self.kernel
        return lv if self.bias is None else lv + self.bias


class GnReluConv(nn.Module):
    def __init__(
        self, in_channels, out_channels, gen, pos_dim=3, use_bias=False, conv_dtype=torch.float32
    ):
        super().__init__()
        self.GroupNormLattice_0 = GroupNormLattice(in_channels)
        self.ConvIm2Row_0 = ConvIm2Row(
            in_channels, out_channels, gen, pos_dim, use_bias, conv_dtype=conv_dtype
        )

    def forward(self, lv, neighbors, mask, plain=False):
        lv = F.relu(self.GroupNormLattice_0(lv, mask))
        return self.ConvIm2Row_0(lv, neighbors, plain=plain)


class CoarsenAct(nn.Module):
    """Coarsen conv -> LeakyReLU (the model's downsample)."""

    def __init__(self, in_channels, out_channels, gen, pos_dim=3, conv_dtype=torch.float32):
        super().__init__()
        self.CoarsenConv_0 = CoarsenConv(in_channels, out_channels, gen, pos_dim, conv_dtype)

    def forward(self, lv_fine, coarsen_table, finefy_table, plain=False):
        return leaky_relu(self.CoarsenConv_0(lv_fine, coarsen_table, finefy_table, plain=plain))


class GnReluFinefy(nn.Module):
    """GN(coarse) -> ReLU -> finefy conv."""

    def __init__(self, in_channels, out_channels, gen, pos_dim=3, conv_dtype=torch.float32):
        super().__init__()
        self.GroupNormLattice_0 = GroupNormLattice(in_channels)
        self.FinefyConv_0 = FinefyConv(in_channels, out_channels, gen, pos_dim, conv_dtype)

    def forward(self, lv_coarse, finefy_table, coarse_mask, coarsen_table, plain=False):
        lv = F.relu(self.GroupNormLattice_0(lv_coarse, coarse_mask))
        return self.FinefyConv_0(lv, finefy_table, coarsen_table, plain=plain)


class ResnetBlock(nn.Module):
    """Pre-activation residual block of two GnReluConv."""

    def __init__(self, channels, gen, biases=(False, False), pos_dim=3, conv_dtype=torch.float32):
        super().__init__()
        for i in range(2):
            conv = GnReluConv(channels, channels, gen, pos_dim, biases[i], conv_dtype)
            self.add_module(f"GnReluConv_{i}", conv)

    def forward(self, lv, neighbors, mask, plain=False):
        out = self.GnReluConv_0(lv, neighbors, mask, plain=plain)
        return self.GnReluConv_1(out, neighbors, mask, plain=plain) + lv


class BottleneckBlock(nn.Module):
    """Pre-activation bottleneck: 1x1 contract (/4) -> conv -> 1x1 expand."""

    def __init__(
        self, channels, gen, biases=(False, False, False), pos_dim=3, conv_dtype=torch.float32
    ):
        super().__init__()
        mid = channels // 4
        self.GnRelu1x1_0 = GnRelu1x1(channels, mid, gen, biases[0])
        self.GnReluConv_0 = GnReluConv(mid, mid, gen, pos_dim, biases[1], conv_dtype)
        self.GnRelu1x1_1 = GnRelu1x1(mid, channels, gen, biases[2])

    def forward(self, lv, neighbors, mask, plain=False):
        out = self.GnRelu1x1_0(lv, mask)
        out = self.GnReluConv_0(out, neighbors, mask, plain=plain)
        return self.GnRelu1x1_1(out, mask) + lv


# ---------------------------------------------------------------------------
# pointnet featuriser and the slice-classify head
# ---------------------------------------------------------------------------


class PointNetModule(nn.Module):
    """Per-edge WN MLP -> per-vertex max-pool with the winner's barycentric
    weight -> min-points mask -> WN 1-hop conv -> LeakyReLU."""

    def __init__(
        self,
        in_features: int,
        channels_per_layer: Sequence[int],
        out_channels: int,
        gen,
        pos_dim: int = 3,
        min_points: int = 4,
        conv_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.min_points = min_points
        self.nr_layers = len(channels_per_layer)
        cur = in_features
        for i, c in enumerate(channels_per_layer):
            self.add_module(f"WNLinear_{i}", WNLinear(cur, c, gen))
            cur = c
        self.ConvIm2Row_0 = ConvIm2Row(
            2 * cur, out_channels, gen, pos_dim, use_bias=True, weight_norm=True,
            conv_dtype=conv_dtype,
        )  # fmt: skip

    def forward(self, rows_sorted, edges, capacity, neighbors, plain=False):
        bary = rows_sorted[:, -1].contiguous()
        feats = rows_sorted[:, :-1]
        for i in range(self.nr_layers):
            feats = leaky_relu(getattr(self, f"WNLinear_{i}")(feats))
        maxed, bary_red = lops.seg_max_sorted(
            feats.contiguous(), bary, edges, capacity, plain=plain
        )
        lv = torch.cat([maxed, bary_red], dim=-1)  # (capacity, 2C)
        count = lops.seg_counts_sorted(edges, capacity)
        lv = torch.where((count >= self.min_points)[:, None], lv, 0.0)
        return leaky_relu(self.ConvIm2Row_0(lv, neighbors, plain=plain))


class SliceFastModule(nn.Module):
    """Stepdown -> 8-channel bottleneck -> per-point gather -> learned
    barycentric offsets -> deformable slice of the pre-classified table.

    The default (preclassify) path of the JAX module: the classifier is
    linear, so the vertex table is classified first (cap x C -> cap x
    classes) and one f32 gather of [bottleneck, logits] rows serves both
    heads."""

    def __init__(self, in_channels: int, nr_classes: int, gen, bottleneck_size: int = 8):
        super().__init__()
        self.bottleneck_size = bottleneck_size
        cur = in_channels
        for i in range(2):
            out = in_channels // (2**i)
            self.add_module(f"GnRelu1x1_{i}", GnRelu1x1(cur, out, gen))
            cur = out
        self.GnRelu1x1_2 = GnRelu1x1(cur, bottleneck_size, gen)
        vdim = bottleneck_size + 1
        self.gamma = _const((vdim,), 1.0)
        self.beta = _const((vdim,), 0.0)
        # delta-weight head: kaiming fan-in for tanh, scaled 0.1; zero bias
        self.delta_kernel = kaiming_uniform_rows((vdim, 1), vdim, gen, 5.0 / 3.0, 0.1)
        self.delta_bias = _const((1,), 0.0)
        self.classify_kernel = kaiming_uniform_rows(
            (nr_classes, in_channels), in_channels, gen, leaky_relu_gain(1.0)
        )
        self.classify_bias = _const((nr_classes,), 0.0)

    def forward(self, lv, mask, splat_idx, splat_weights, plain=False):
        n, d1 = splat_idx.shape
        lv_b = lv
        for i in range(3):
            lv_b = getattr(self, f"GnRelu1x1_{i}")(lv_b, mask)
        wide = lv @ self.classify_kernel.T  # per-vertex logits, f32
        both = torch.cat([lv_b, wide], dim=1)  # (cap, bottleneck + classes)
        g_all = lops.gather_rows_clustered(both, splat_idx, plain=plain)
        g_b = g_all[..., : self.bottleneck_size]
        g_v = g_all[..., self.bottleneck_size :]

        valid = splat_idx < lv.shape[0]
        w_val = torch.where(valid, splat_weights, 0.0)
        g = torch.cat([g_b * w_val[..., None], w_val[..., None]], dim=-1)
        max_vals = torch.amax(g, dim=1, keepdim=True)
        g = g - (self.gamma * max_vals + self.beta)
        delta = (g @ self.delta_kernel + self.delta_bias).reshape(n, d1)
        w_def = torch.where(valid, splat_weights + delta, 0.0)
        return (g_v * w_def[..., None]).sum(1) + self.classify_bias
