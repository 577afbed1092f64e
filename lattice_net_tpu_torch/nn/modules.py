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
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lattice_net_tpu_torch import tracing
from lattice_net_tpu_torch.lattice import ops as lops
from lattice_net_tpu_torch.ops_cuda.norm import group_norm_act, masked_group_norm, norm_stats_distributed

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
        with tracing.span(tracing.NORM):
            return masked_group_norm(lv, mask, self.groups, self.scale, self.bias)

    def relu(self, lv, mask, out_dtype, plain=False):
        """``F.relu(self(lv, mask))`` for a consumer that takes ``out_dtype``
        (:func:`norm_act`)."""
        return norm_act(lv, mask, self.groups, self.scale, self.bias, out_dtype, plain=plain)


def norm_act(lv, mask, num_groups, scale, bias, out_dtype, relu=True, plain=False):
    """``act(masked_group_norm(lv, mask, num_groups, scale, bias))``, ``act``
    ReLU or (``relu=False``) the identity, for a consumer that takes
    ``out_dtype`` (a conv's ``conv_dtype``; ``lv``'s dtype for a GEMM).

    Outside autograd (``no_grad``, ``inference_mode``, or no input that needs
    a gradient) it is one call of ``ops_cuda.norm.group_norm_act``: on the
    card the fused kernel, whose statistics read only the rows ``mask``
    marks, with the output already in ``out_dtype``; its plain version (this
    same composition) on the CPU, under ``plain=True`` and under
    ``LNT_FAST_OPS=0``.  Under autograd, and inside
    :class:`norm_stats_distributed`, the composition as it always ran, in
    ``lv``'s dtype (the consumer casts): the kernel has no backward and no
    all-reduce."""
    with tracing.span(tracing.NORM):
        grads = torch.is_grad_enabled() and (lv.requires_grad or scale.requires_grad or bias.requires_grad)
        if grads or norm_stats_distributed.current() is not None:
            out = masked_group_norm(lv, mask, num_groups, scale, bias)
            return F.relu(out) if relu else out
        with tracing.span(tracing.NORM_FUSED):
            plain = plain or not lops._fast_ops()
            return group_norm_act(lv, mask, num_groups, scale, bias, relu, out_dtype, plain=plain)


class BatchNormLattice(nn.Module):
    """BatchNorm over the real lattice vertices (the JAX ``BatchNormLattice``).

    In training (``use_running_average=False``) the statistics are the
    mean and the biased variance over the occupied rows, and the running
    ones (the buffers ``mean`` and ``var``, flax's ``batch_stats``) decay
    by ``momentum`` = 0.9 towards them; ``use_running_average=True``
    normalises with the running ones.  ``nn.BatchNorm1d`` is another
    function (all rows, an unbiased running variance, momentum 0.1)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.scale = _const((channels,), 1.0)
        self.bias = _const((channels,), 0.0)

    def forward(self, lv, mask, use_running_average: bool = False):
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            m = mask[:, None].to(lv.dtype)
            count = torch.clamp(m.sum(), min=1.0)
            mean = (lv * m).sum(0) / count
            var = (((lv - mean) ** 2) * m).sum(0) / count
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        return (lv - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


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


def _wn_groups(params):
    """The weight-norm groups of a ``{name: tensor}`` dict: the prefixes
    holding both ``<prefix>v`` and ``<prefix>g``."""
    return [k[:-1] for k in params if k.rsplit(".", 1)[-1] == "v" and k[:-1] + "g" in params]


def fuse_weight_norm(params: dict) -> dict:
    """Fold every weight-norm ``g`` into its direction ``v``: ``v`` becomes
    the effective kernel ``v * g / ||v||`` and ``g`` its column norms, so
    the same modules give the same outputs (the JAX
    ``fuse_weight_norm``).  ``params`` is a ``{name: tensor}`` dict (a
    ``state_dict``); returns a new one."""
    out = dict(params)
    for pre in _wn_groups(params):
        v, g = params[pre + "v"], params[pre + "g"]
        norm = torch.clamp(torch.linalg.vector_norm(v, dim=0, keepdim=True), min=1e-12)
        out[pre + "v"] = v * (g[None, :] / norm)
        out[pre + "g"] = torch.linalg.vector_norm(out[pre + "v"], dim=0)
    return out


def unfuse_weight_norm(params: dict) -> dict:
    """Set every weight-norm ``g`` to ``||v||``, so that a ``v`` holding a
    plain kernel is what the weight-norm forward applies (the JAX
    ``unfuse_weight_norm``)."""
    out = dict(params)
    for pre in _wn_groups(params):
        out[pre + "g"] = torch.linalg.vector_norm(params[pre + "v"], dim=0)
    return out


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

    def forward(self, lv, mask, plain=False):
        lv = self.GroupNormLattice_0.relu(lv, mask, lv.dtype, plain=plain) @ self.kernel
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
        lv = self.GroupNormLattice_0.relu(lv, mask, self.ConvIm2Row_0.conv_dtype, plain=plain)
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
        lv = self.GroupNormLattice_0.relu(lv_coarse, coarse_mask, self.FinefyConv_0.conv_dtype, plain=plain)
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
        out = self.GnRelu1x1_0(lv, mask, plain=plain)
        out = self.GnReluConv_0(out, neighbors, mask, plain=plain)
        return self.GnRelu1x1_1(out, mask, plain=plain) + lv


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


def channel_keep_mask(channels: int, prob: float, generator, device) -> torch.Tensor:
    """(1, C) bool: each channel kept with probability 1 - ``prob``, drawn
    from ``generator`` (Philox on the card), as ``jax.random.bernoulli``
    draws it: a uniform below 1 - ``prob``."""
    u = torch.rand((1, channels), generator=generator, device=device)
    return u < 1.0 - prob


def channel_dropout(lv: torch.Tensor, prob: float, train: bool, generator) -> torch.Tensor:
    """Dropout2d-style whole-channel dropout (the JAX ``channel_dropout``):
    one keep mask for all rows, survivors scaled by 1 / (1 - ``prob``); the
    identity when not training or when ``prob`` is 0."""
    if not train or prob == 0.0:
        return lv
    if generator is None:
        raise ValueError("channel dropout in training needs a torch.Generator")
    keep = channel_keep_mask(lv.shape[1], prob, generator, lv.device)
    return lv * keep / (1.0 - prob)


class SliceFastModule(nn.Module):
    """Stepdown -> 8-channel bottleneck -> per-point gather -> learned
    barycentric offsets -> deformable slice-classify (the JAX module).

    The classifier is linear, so the vertex table is classified first (cap x
    C -> cap x classes) and one f32 gather of [bottleneck, logits] rows
    serves both heads, as the JAX module does by default.
    ``LNT_HEAD_SEGVJP`` (default "0", read at each forward): "1", with
    ``edges`` given, gathers through ``gather_rows_clustered_segbwd`` (K4
    forward, the edge-sort adjoint with K3) instead of
    ``gather_rows_clustered`` (K1, K1-bwd).

    ``dropout`` is whole-channel dropout on the vertex values in training;
    ``experiment="slice_no_deform"`` zeroes the learned offsets."""

    def __init__(
        self,
        in_channels: int,
        nr_classes: int,
        gen,
        bottleneck_size: int = 8,
        dropout: float = 0.0,
        experiment: str = "none",
    ):
        super().__init__()
        self.bottleneck_size = bottleneck_size
        self.dropout = dropout
        self.experiment = experiment
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

    def forward(
        self, lv, mask, splat_idx, splat_weights, edges=None, train=False, generator=None,
        plain=False,
    ):  # fmt: skip
        n, d1 = splat_idx.shape
        lv_b = lv
        for i in range(3):
            lv_b = getattr(self, f"GnRelu1x1_{i}")(lv_b, mask, plain=plain)
        lv_eff = channel_dropout(lv, self.dropout, train, generator)
        wide = lv_eff @ self.classify_kernel.T  # per-vertex logits, f32
        both = torch.cat([lv_b, wide], dim=1)  # (cap, bottleneck + classes)
        if edges is not None and os.environ.get("LNT_HEAD_SEGVJP", "0") == "1":
            g_all = lops.gather_rows_clustered_segbwd(both, splat_idx, edges, plain=plain)
        else:
            g_all = lops.gather_rows_clustered(both, splat_idx, plain=plain)
        g_b = g_all[..., : self.bottleneck_size].to(torch.float32)
        g_v = g_all[..., self.bottleneck_size :]

        valid = splat_idx < lv.shape[0]
        w_val = torch.where(valid, splat_weights, 0.0)
        g = torch.cat([g_b * w_val[..., None], w_val[..., None]], dim=-1)
        max_vals = torch.amax(g, dim=1, keepdim=True)
        g = g - (self.gamma * max_vals + self.beta)
        delta = (g @ self.delta_kernel + self.delta_bias).reshape(n, d1)
        if self.experiment == "slice_no_deform":
            delta = torch.zeros_like(delta)
        w_def = torch.where(valid, splat_weights + delta, 0.0)
        return (g_v.to(torch.float32) * w_def[..., None]).sum(1) + self.classify_bias


# ---------------------------------------------------------------------------
# the rest of the reference's module zoo (off the model's path)
# ---------------------------------------------------------------------------


def distribute_module(positions, values, splat_idx, splat_weights, capacity, point_mask=None):
    """Parameter-free distribute with the local-mean subtraction
    (``ops.distribute``): ``(rows, edge_idx)``, one row per (point, vertex)
    edge."""
    return lops.distribute(positions, values, splat_idx, splat_weights, capacity, point_mask)


class GnReluCoarsen(nn.Module):
    """GN(fine) -> ReLU -> coarsen conv.  ``finefy_table``, the coarsen
    table's pair, routes the value gradient through the flip-neighbours
    adjoint; without it the values get none."""

    def __init__(self, in_channels, out_channels, gen, pos_dim=3, conv_dtype=torch.float32):
        super().__init__()
        self.GroupNormLattice_0 = GroupNormLattice(in_channels)
        self.CoarsenConv_0 = CoarsenConv(in_channels, out_channels, gen, pos_dim, conv_dtype)

    def forward(self, lv_fine, coarsen_table, fine_mask, finefy_table=None, plain=False):
        lv = self.GroupNormLattice_0.relu(lv_fine, fine_mask, self.CoarsenConv_0.conv_dtype, plain=plain)
        return self.CoarsenConv_0(lv, coarsen_table, finefy_table, plain=plain)


class SplatModule(nn.Module):
    """Parameter-free barycentric splat (``ops.splat``)."""

    def forward(self, values, splat_idx, splat_weights, capacity):
        return lops.splat(values, splat_idx, splat_weights, capacity)


class SliceModule(nn.Module):
    """Parameter-free barycentric slice (``ops.slice_lattice``), its gather
    in ``conv_dtype``."""

    def __init__(self, conv_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dtype = conv_dtype

    def forward(self, lv, splat_idx, splat_weights, plain=False):
        return lops.slice_lattice(lv, splat_idx, splat_weights, self.conv_dtype, plain=plain)


class ConvAct(nn.Module):
    """[channel dropout in training] -> same-level conv -> LeakyReLU."""

    def __init__(
        self, in_channels, out_channels, gen, pos_dim=3, use_bias=False, dropout=0.0,
        conv_dtype=torch.float32,
    ):  # fmt: skip
        super().__init__()
        self.dropout = dropout
        self.ConvIm2Row_0 = ConvIm2Row(
            in_channels, out_channels, gen, pos_dim, use_bias, conv_dtype=conv_dtype
        )

    def forward(self, lv, neighbors, train=False, generator=None, plain=False):
        lv = channel_dropout(lv, self.dropout, train, generator)
        return leaky_relu(self.ConvIm2Row_0(lv, neighbors, plain=plain))


class TwoConv(nn.Module):
    """Two :class:`ConvAct`, no residual; the second has the dropout."""

    def __init__(
        self, channels, gen, biases=(False, False), dropout=0.0, pos_dim=3, conv_dtype=torch.float32
    ):
        super().__init__()
        kw = dict(pos_dim=pos_dim, conv_dtype=conv_dtype)
        self.ConvAct_0 = ConvAct(channels, channels, gen, use_bias=biases[0], **kw)
        self.ConvAct_1 = ConvAct(channels, channels, gen, use_bias=biases[1], dropout=dropout, **kw)

    def forward(self, lv, neighbors, mask, train=False, generator=None, plain=False):
        lv = self.ConvAct_0(lv, neighbors, plain=plain)
        return self.ConvAct_1(lv, neighbors, train, generator, plain=plain)


class ResnetBlock2(nn.Module):
    """conv -> one-group masked GroupNorm (``ln_scale``, ``ln_bias``) -> conv
    -> LeakyReLU, plus the input."""

    def __init__(self, channels, gen, biases=(False, False), pos_dim=3, conv_dtype=torch.float32):
        super().__init__()
        kw = dict(conv_dtype=conv_dtype)
        self.ConvIm2Row_0 = ConvIm2Row(channels, channels, gen, pos_dim, biases[0], **kw)
        self.ln_scale = _const((channels,), 1.0)
        self.ln_bias = _const((channels,), 0.0)
        self.ConvIm2Row_1 = ConvIm2Row(channels, channels, gen, pos_dim, biases[1], **kw)

    def forward(self, lv, neighbors, mask, plain=False):
        out = self.ConvIm2Row_0(lv, neighbors, plain=plain)
        out = norm_act(out, mask, 1, self.ln_scale, self.ln_bias, self.ConvIm2Row_1.conv_dtype, False, plain)
        return leaky_relu(self.ConvIm2Row_1(out, neighbors, plain=plain)) + lv


class DensenetBlock(nn.Module):
    """``nr_layers`` GnReluConv layers, each reading the input and every
    earlier layer's output; returns the layers' outputs concatenated
    (``nr_layers * channels``).  ``in_channels`` (default ``channels``) is
    the input's width, which flax infers."""

    def __init__(
        self, channels, gen, nr_layers=2, in_channels=None, pos_dim=3, conv_dtype=torch.float32
    ):
        super().__init__()
        self.nr_layers = nr_layers
        width = channels if in_channels is None else in_channels
        for i in range(nr_layers):
            conv = GnReluConv(width, channels, gen, pos_dim, conv_dtype=conv_dtype)
            self.add_module(f"GnReluConv_{i}", conv)
            width += channels

    def forward(self, lv, neighbors, mask, plain=False):
        stack, outputs = lv, []
        for i in range(self.nr_layers):
            new = getattr(self, f"GnReluConv_{i}")(stack, neighbors, mask, plain=plain)
            stack = torch.cat([stack, new], dim=-1)
            outputs.append(new)
        return torch.cat(outputs, dim=-1)


class GnReluDepthwiseConv(nn.Module):
    """GN -> ReLU -> depthwise lattice conv (``ops.depthwise_conv``), its
    (extent, C) ``weight`` kaiming-uniform with fan = extent."""

    def __init__(self, channels, gen, pos_dim=3):
        super().__init__()
        extent = filter_extent(pos_dim)
        self.GroupNormLattice_0 = GroupNormLattice(channels)
        self.weight = kaiming_uniform_rows((extent, channels), extent, gen)

    def forward(self, lv, neighbors, mask, plain=False):
        lv = self.GroupNormLattice_0.relu(lv, mask, lv.dtype, plain=plain)
        return lops.depthwise_conv(lv, neighbors, self.weight, True, plain=plain)
