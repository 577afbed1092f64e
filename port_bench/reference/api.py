"""The plain reference the benchmark holds the port against.

The modules beside this one are a frozen copy of the port's default path
(the permutohedral build, the lattice ops, the LNN and its modules, the
loss and AdamW-amsgrad), which the port's CPU tests hold against the JAX
package, cut to what :func:`forward` and :func:`train_steps` reach.  They
read no environment, import nothing of the port, launch no kernel (each
kernel is its plain version, ``plain_kernels.py``) and run their convs in
f32 with TF32 off.  The control is the same code with every conv operand
rounded to float8 (e4m3, one scale a tensor): the precision below the
port's bf16 convs.
"""

from __future__ import annotations

import contextlib

import torch
from torch.func import functional_call

from . import lnn, ops, optim, structure
from . import losses as losses_mod

PRECISIONS = ("f32", "fp8")
_FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to the format's largest), back in ``t``'s dtype."""
    amax = t.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, amax / _FP8_MAX, torch.ones_like(amax))
    q = (t.to(torch.float32) / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return (q * scale).to(t.dtype)


@contextlib.contextmanager
def precision(name: str):
    """The reference's arithmetic inside the block: "f32" (TF32 off) or the
    control's "fp8"."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if name == "fp8":
        ops.OPERAND_ROUNDING.append(_round_fp8)
    try:
        yield
    finally:
        if name == "fp8":
            ops.OPERAND_ROUNDING.pop()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_model(model: dict, nr_classes: int, weights: dict, device) -> lnn.LNN:
    """The reference LNN of a configuration's ``model`` section, f32 convs,
    holding ``weights`` (``{state_dict name: tensor}``)."""
    mp = lnn.ModelParams(nr_classes=nr_classes, **{k: tuple(v) if isinstance(v, list) else v
                                                   for k, v in model.items()})  # fmt: skip
    net = lnn.LNN(mp, torch.Generator().manual_seed(0), device)
    net.load_state_dict({k: v.to(device, torch.float32) for k, v in weights.items()})
    return net.eval()


def hierarchy(net: lnn.LNN, positions, values, mask, sigma, capacities):
    return structure.build_hierarchy(
        positions, sigma, net.params.nr_downsamples, tuple(capacities), point_mask=mask,
        point_feats=values,
    )  # fmt: skip


@torch.no_grad()
def forward(net: lnn.LNN, positions, values, mask, sigma, capacities):
    """(log-probabilities (N, classes), overflow per level) of one padded
    cloud."""
    h = hierarchy(net, positions, values, mask, sigma, capacities)
    logp, _ = net(h, positions, values)
    return logp, [int(s.nr_overflow) for s in h.structures]


def iou_counts(logp, target, mask):
    """(classes,) intersection and union of the argmax labels with the
    targets over the valid points (labels >= 0), as the train step's
    metrics count them."""
    classes = torch.arange(logp.shape[-1], device=logp.device)
    valid = (target != -1) & mask
    p = (torch.argmax(logp, dim=-1)[:, None] == classes) & valid[:, None]
    t = (target[:, None] == classes) & valid[:, None]
    return (p & t).sum(dim=0), (p | t).sum(dim=0)


def loss(net: lnn.LNN, params: dict, batch: dict, sigma, capacities):
    """The train step's loss of a batch, in training mode: the mean over
    its clouds of each cloud's loss, and the :func:`iou_counts` summed over
    them."""
    losses, inter, union = [], 0, 0
    for i in range(batch["positions"].shape[0]):
        pos, val, tgt, mask = (batch[k][i] for k in ("positions", "values", "target", "point_mask"))
        h = hierarchy(net, pos, val, mask, sigma, capacities)
        logp, _ = functional_call(net, params, (h, pos, val), dict(train=True))
        losses.append(losses_mod.segmentation_loss(logp, tgt, -1, mask))
        i_c, u_c = iou_counts(logp.detach(), tgt, mask)
        inter, union = inter + i_c, union + u_c
    return torch.stack(losses).mean(), (inter, union)


def train_steps(net: lnn.LNN, optimizer: dict, batches, sigma, capacities, params: dict, opt_state: dict):
    """``len(batches)`` train steps from ``params`` and the optimizer state
    ``opt_state`` (``{"count", "mu", "nu", "nu_max"}`` and ``"plateau"``
    where the schedule has one): ``(losses, first gradients, parameters
    after the last step, each step's iou counts)``.  ``optimizer`` holds
    ``make_optimizer``'s arguments."""
    tx = optim.make_optimizer(**optimizer)
    params = {k: v.detach().to(torch.float32).clone() for k, v in params.items()}
    state = opt_state
    out_losses, first, counts = [], None, []
    for batch in batches:
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        value, c = loss(net, leaves, batch, sigma, capacities)
        counts.append(c)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()), materialize_grads=True)))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            extra = {"value": value.detach()} if tx.wants_value else {}
            updates, state = tx.update(grads, state, params, **extra)
            params = {k: p + updates[k] for k, p in params.items()}
        out_losses.append(float(value.detach()))
    return out_losses, first, params, counts


ADAM_B1 = optim.B1
