"""The masked GroupNorm and its activation in one kernel (``csrc/group_norm_act.cu``).

:func:`group_norm_act` computes ``act(masked_group_norm(lv, mask, ...))``
(``act`` ReLU or the identity) in the dtype of its consumer: bf16 for a conv
that runs in bf16, f32 for a GEMM.  Its dispatch point launches the kernel
for CUDA tensors and runs :func:`group_norm_act_plain` for CPU tensors;
neither falls back from the kernel to the plain version.  ``plain=True``
takes the plain version on any device.  ``group_norm_act.launches`` counts
the kernel's calls (three launches a call, counted once).

The kernel replaces no TPU kernel: the JAX package's norm is XLA code, which
fuses itself.  It has no backward; ``nn.modules.norm_act`` calls it only
outside autograd and outside :class:`norm_stats_distributed`, and there
keeps the composition, :func:`masked_group_norm`, which this module holds
as the kernel's plain version (``nn.modules`` re-exports both names).
"""

from __future__ import annotations

import contextvars
import ctypes

import torch
import torch.nn.functional as F

from lattice_net_tpu_torch.ops_cuda import _build

MAX_CHANNELS = 4096  # the kernel's shared memory holds a few floats a channel


# The lattice-sharded mode (parallel/lattice_sharded.py): while a
# norm_stats_distributed context is active, masked norm statistics count the
# OWNED vertices only (halo copies would count twice) and are summed over the
# stripe axis, so every shard normalises with the global moments.  The owned
# masks are keyed by table capacity (the sharded steps require distinct
# per-level capacities), as the JAX package keys them; a context variable
# carries them to every GroupNorm of the forward without threading an
# argument through each module.
_NORM_DIST: contextvars.ContextVar = contextvars.ContextVar("norm_stats_distributed", default=None)


class norm_stats_distributed:
    """Context manager: masked GroupNorm statistics over the vertices of
    ``own_masks[capacity]``, summed by ``mesh.psum(., axis)`` (differentiable:
    its backward psums the cotangent).  ``current()`` is the active
    ``(mesh, axis, own_masks)``, which ``norm_stats_distributed(*current)``
    re-enters (a remat block's recompute in the backward runs outside the
    forward's context)."""

    def __init__(self, mesh, axis: str, own_masks: dict):
        self.state = (mesh, axis, dict(own_masks))

    @staticmethod
    def current():
        return _NORM_DIST.get()

    def __enter__(self):
        self._token = _NORM_DIST.set(self.state)
        return self

    def __exit__(self, *exc):
        _NORM_DIST.reset(self._token)
        return False


def masked_group_norm(lv, mask, num_groups, scale, bias, eps=1e-5):
    """GroupNorm whose statistics ignore padded rows.

    Each group is shifted by its mean over row 0 (always a real vertex:
    sorted tables put valid rows first) before the moments are formed, so
    E[x^2] - E[x]^2 does not cancel when |mean| >> spread.  Under
    :class:`norm_stats_distributed` the moments are global: the owned rows'
    sums psum'd over the stripe axis, the count psum'd before its clamp at 1
    (a shard that owns no vertex adds 0), one shift pmean'd across shards.
    With the activation and the cast it is the plain version of
    :func:`group_norm_act`; its callers in ``nn.modules`` enter the
    ``lnt.norm`` span."""
    cap, c = lv.shape
    g = num_groups
    gs = c // g
    m = mask[:, None].to(lv.dtype)
    dist = _NORM_DIST.get()
    if dist is not None:
        mesh, axis, own_masks = dist
        own = own_masks.get(cap)
        if own is not None:
            m = m * own[:, None].to(lv.dtype)
    t_g = lv[0].detach().reshape(g, gs).mean(-1)
    count = m.sum() * gs
    if dist is not None:  # one all-reduce: the shift's mean and the count (no gradient through either)
        summed = mesh.psum(torch.cat([t_g, count.reshape(1)]), axis)
        t_g, count = summed[:g] / mesh.size(axis), summed[g]
    count = torch.clamp(count, min=1.0)
    lvs = lv - t_g.repeat_interleave(gs)
    lvm = lvs * m
    s1 = lvm.sum(0)
    s2 = (lvm * lvs).sum(0)
    if dist is not None:
        s1, s2 = mesh.psum(torch.stack([s1, s2]), axis)
    gmean_s = s1.reshape(g, gs).sum(-1) / count
    gvar = torch.clamp(s2.reshape(g, gs).sum(-1) / count - gmean_s * gmean_s, min=0.0)
    mean_c = (gmean_s + t_g).repeat_interleave(gs)
    inv_c = torch.rsqrt(gvar + eps).repeat_interleave(gs)
    return (lv - mean_c) * (inv_c * scale) + bias


def group_norm_act_plain(lv, mask, num_groups, scale, bias, relu, out_dtype, eps=1e-5):
    """The composition the kernel replaces, as the modules ran it:
    :func:`masked_group_norm`, then ``F.relu`` (where ``relu``), then the
    cast to ``out_dtype`` that the consumer would make."""
    out = masked_group_norm(lv, mask, num_groups, scale, bias, eps)
    return (F.relu(out) if relu else out).to(out_dtype)


def _lib():
    lib = _build.load("group_norm_act")
    fn = lib.lnt_group_norm_act
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ll, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.lnt_group_norm_act_scratch.argtypes = [ll, i]
        lib.lnt_group_norm_act_scratch.restype = ll
    return lib


def _check(lv, mask, num_groups, scale, bias, out_dtype) -> None:
    if lv.dim() != 2 or mask.dim() != 1 or mask.shape[0] != lv.shape[0]:
        raise ValueError(f"need (cap, C) values and a (cap,) mask, got {tuple(lv.shape)}, {tuple(mask.shape)}")
    cap, c = lv.shape
    if cap == 0 or c == 0 or c > MAX_CHANNELS:
        raise ValueError(f"group_norm_act takes 1 to {MAX_CHANNELS} channels and at least one row, got {tuple(lv.shape)}")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if lv.dtype != torch.float32 or scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"values, scale and bias must be f32, got {lv.dtype}, {scale.dtype}, {bias.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be ({c},), got {tuple(scale.shape)}, {tuple(bias.shape)}")
    if any(t.device != lv.device for t in (mask, scale, bias)):
        raise ValueError("values, mask, scale and bias must share a device")
    if not all(t.is_contiguous() for t in (lv, mask, scale, bias)):
        raise ValueError("group_norm_act needs contiguous values, mask, scale and bias")


def _group_norm_act(lv, mask, num_groups, scale, bias, relu, out_dtype, eps):
    """The kernel's dispatch point: the plain version for CPU tensors, the
    kernel for CUDA."""
    if _build.device_type(lv, "group_norm_act") == "cpu":
        return group_norm_act_plain(lv, mask, num_groups, scale, bias, relu, out_dtype, eps)
    _check(lv, mask, num_groups, scale, bias, out_dtype)
    cap, c = lv.shape
    lib = _lib()
    out = torch.empty((cap, c), dtype=out_dtype, device=lv.device)
    with torch.cuda.device(lv.device):
        scratch = torch.empty(lib.lnt_group_norm_act_scratch(cap, c), dtype=torch.float32, device=lv.device)
        err = lib.lnt_group_norm_act(
            lv.data_ptr(), mask.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            cap, c, num_groups, eps, int(relu), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )  # fmt: skip
    _build.check(err, "group_norm_act")
    group_norm_act.launches += 1
    return out


def group_norm_act(lv, mask, num_groups, scale, bias, relu=True, out_dtype=torch.float32, eps=1e-5, plain=False):
    """``act(masked_group_norm(lv, mask, num_groups, scale, bias, eps))`` in
    ``out_dtype``, ``act`` ReLU (``relu``) or the identity: (cap, C) f32
    values, a (cap,) bool mask of the rows the statistics read, (C,) f32
    scale and bias.  Every row is normalised, marked or not.  No gradient."""
    if plain:
        return group_norm_act_plain(lv, mask, num_groups, scale, bias, relu, out_dtype, eps)
    return _group_norm_act(lv, mask, num_groups, scale, bias, relu, out_dtype, eps)


group_norm_act.launches = 0
