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
outside autograd, and training keeps the composition.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lattice_net_tpu_torch.ops_cuda import _build

MAX_CHANNELS = 4096  # the kernel's shared memory holds a few floats a channel


def group_norm_act_plain(lv, mask, num_groups, scale, bias, relu, out_dtype, eps=1e-5):
    """The composition the kernel replaces, as the modules ran it:
    ``masked_group_norm``, then ``F.relu`` (where ``relu``), then the cast to
    ``out_dtype`` that the consumer would make."""
    from lattice_net_tpu_torch.nn.modules import masked_group_norm  # nn.modules imports this module

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
