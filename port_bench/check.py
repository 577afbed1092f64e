"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``reference/api.py``), which works it out
again from the benchmark's own inputs and weights.

Served or labelled clouds: each sampled cloud's labels and
log-probabilities against the reference's forward of the same cloud.
Training: three consecutive steps of the program (:class:`Steps`) against
three reference steps from the same start, the first three from the
benchmark's weights and three that the window took, from the program's
state at their start.  Under ``env.control`` the reference in fp8 takes the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import yardstick
from port_bench.reference import api as ref


def _reference_model(env):
    return ref.make_model(env.cfg["model"], env.cfg["nr_classes"], env.weights, env.device)


def _padded(pos, val, budget, device):
    pad = budget - len(pos)
    p = torch.from_numpy(np.pad(pos, ((0, pad), (0, 0)))).to(device)
    v = torch.from_numpy(np.pad(val, ((0, pad), (0, 0)))).to(device)
    m = torch.arange(budget, device=device) < len(pos)
    return p, v, m


def reference_labels(env, caps, section, clouds, precision):
    """The reference's (log-probabilities, overflow) of each cloud, in
    ``precision``."""
    net = _reference_model(env)
    sigma = env.cfg[f"lattice_{section}"]["sigma"]
    out = []
    with ref.precision(precision):
        for pos, val, _ in clouds:
            p, v, m = _padded(pos, val, env.traffic["budget"], env.device)
            logp, ovf = ref.forward(net, p, v, m, sigma, caps)
            out.append((logp[: len(pos)], ovf))
    return out


def label_numbers(ref_logp, labels, logp) -> dict:
    n = ref_logp.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=ref_logp.device)
    labels = labels.to(ref_logp.device)
    logp = logp[:n].to(ref_logp.device)
    return dict(label_gap=yardstick.label_gap(ref_logp, labels, valid),
                logp_max_abs=yardstick.logp_max_abs(logp, ref_logp, valid),
                logp_best_gap=yardstick.logp_best_gap(logp, ref_logp, valid))  # fmt: skip


def labels(env, caps, section, items, expected):
    """``items``: (cloud, host labels, log-probabilities) of the sampled
    clouds, ``expected`` of them due."""
    clouds = [c for c, _, _ in items]
    refs = reference_labels(env, caps, section, clouds, "f32")
    if env.control:
        ctl = reference_labels(env, caps, section, clouds, "fp8")
        items = [(c, torch.argmax(lp, dim=-1), lp) for c, (lp, _) in zip(clouds, ctl)]
    worst = {}
    for (_, got, logp), (ref_logp, _) in zip(items, refs):
        for k, v in label_numbers(ref_logp, got, logp).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return checked(worst, env.limits, len(items), expected)


class Steps:
    """``n`` consecutive train steps from step ``at``: the state before the
    first, the first moment after the first and the parameters after the
    last (a step makes new tensors, so keeping them copies nothing), each
    step's loss, iou counts and batch.  :meth:`before` and :meth:`after`
    are called around every step ``i`` of the loop that watches."""

    def __init__(self, at: int, n: int):
        self.at, self.n = at, n
        self.start = self.first_mu = self.end_params = None
        self.batches, self.losses, self.counts = [], [], []

    def before(self, i, state):
        if i == self.at:
            self.start = state

    def after(self, i, state, metrics, host_batch):
        if not self.at <= i < self.at + self.n:
            return
        self.batches.append(host_batch)
        self.losses.append(metrics["loss"])
        self.counts.append((metrics["iou_intersection"], metrics["iou_union"]))
        if i == self.at:
            self.first_mu = state.opt_state["mu"]
        if i == self.at + self.n - 1:
            self.end_params = state.params

    @property
    def done(self) -> bool:
        return self.end_params is not None

    def program_side(self) -> dict:
        """What the program did, on the device: the first gradient as the
        optimizer got it (from its first moment before and after: ``(mu1 -
        b1 mu0) / (1 - b1)``), the parameters' change over the steps, the
        losses and the counts; the start state for the reference."""
        b1 = ref.ADAM_B1
        mu0, mu1 = self.start.opt_state["mu"], self.first_mu
        grads = {k: (mu1[k] - b1 * mu0[k]) / (1 - b1) for k in mu1}
        change = {k: self.end_params[k] - self.start.params[k] for k in self.start.params}
        return dict(grads=grads, change=change, losses=[float(x) for x in self.losses], counts=self.counts,
                    params=self.start.params, opt_state=self.start.opt_state, batches=self.batches)  # fmt: skip


def reference_train(env, caps, side, precision):
    net = _reference_model(env)
    dev_batches = [{k: torch.from_numpy(v).to(env.device) for k, v in b.items()} for b in side["batches"]]
    with ref.precision(precision):
        return ref.train_steps(net, env.cfg["optimizer"], dev_batches, env.cfg["lattice_train"]["sigma"], caps,
                               side["params"], side["opt_state"])  # fmt: skip


def train_numbers(ref_out, side) -> dict:
    """Every training number of one :class:`Steps`: the first step's loss
    gap, each step's worst, the first gradient's and the change's gaps by
    the worst and by the median leaf, and the first step's and the worst
    step's gap of the labels' iou counts."""
    r_losses, r_grads, r_params, r_counts = ref_out
    start = side["params"]
    iou = [yardstick.iou_counts_gap(p, r) for p, r in zip(side["counts"], r_counts)]
    r_change = {k: r_params[k] - start[k] for k in start}
    moved = yardstick.moved_leaves(r_grads)
    losses = yardstick.loss_gaps(side["losses"], r_losses)
    g = yardstick.leaf_norm_gaps(side["grads"], r_grads)
    u = yardstick.leaf_norm_gaps(side["change"], r_change, keep=moved)
    return dict(
        loss1_gap=losses[0], loss_gap=max(losses), grad_gap=max(g), grad_gap_median=yardstick.median(g),
        update_gap=max(u), update_gap_median=yardstick.median(u), iou_gap1=iou[0], iou_gap=max(iou),
    )  # fmt: skip


def train(env, caps, sides, expected: int):
    """``sides``: (prefix, :meth:`Steps.program_side`) of each watched run
    of steps; a number is named with its run's prefix, and runs that share
    a prefix give their worst."""
    numbers, compared = {}, 0
    for prefix, side in sides:
        if env.control:
            losses, grads, params, counts = reference_train(env, caps, side, "fp8")
            side = dict(side, losses=losses, grads=grads, counts=counts,
                        change={k: params[k] - side["params"][k] for k in params})  # fmt: skip
        for k, v in train_numbers(reference_train(env, caps, side, "f32"), side).items():
            numbers[prefix + k] = max(numbers.get(prefix + k, 0.0), v)
        compared += len(side["batches"])
    return checked(numbers, env.limits, compared, expected)


def checked(numbers, limits, compared, expected):
    """The numbers that have a limit in the configuration are compared; the
    others are reported beside them."""
    return dict(numbers={k: numbers[k] for k in limits}, limits=limits, compared=compared, expected=expected,
                info={k: v for k, v in numbers.items() if k not in limits})  # fmt: skip
