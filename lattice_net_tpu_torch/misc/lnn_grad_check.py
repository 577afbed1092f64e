"""Gradient checks of each differentiable lattice op (the JAX package's
``misc/lnn_grad_check.py``).

    python -m lattice_net_tpu_torch.misc.lnn_grad_check [--device cuda|cpu]

On a tiny lattice of a toy cloud (40 points, sigma 0.4, capacities 256 and
128) each op's gradient is checked: splat then slice, the same-level conv
in its values and its weights, the coarsen and finefy convs (without their
paired tables: the plain adjoint, K1-bwd on the card) and the head gather
(``gather_lattice``).  On the CPU the autograd gradient is held in f64 against central
finite differences (rtol 1e-4, atol 1e-5, the JAX tool's); on the card, in
f32, the kernels' gradient against the plain path's (``plain=True``, rtol
1e-4, atol 1e-5).  Prints one line an op and raises on a miss.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lattice_net_tpu_torch.data.toy import make_toy_cloud
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import ops
from lattice_net_tpu_torch.lattice.structure import build_hierarchy

RTOL, ATOL = 1e-4, 1e-5


def fd_grad(f, x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central finite-difference gradient of the scalar ``f`` at ``x``."""
    x = np.array(x, np.float64)
    g = np.zeros_like(x)
    flat, gf = x.reshape(-1), g.reshape(-1)
    for i in range(flat.size):
        old = flat[i]
        flat[i] = old + eps
        fp = float(f(x))
        flat[i] = old - eps
        fm = float(f(x))
        flat[i] = old
        gf[i] = (fp - fm) / (2 * eps)
    return g


def autograd_grad(f, x: np.ndarray, dtype, device, plain=False) -> np.ndarray:
    leaf = torch.tensor(x, dtype=dtype, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(f(leaf, plain=plain), leaf)
    return g.detach().cpu().double().numpy()


def check_op(name, f, x0, device, eps=1e-4, verbose=True) -> float:
    """``f(leaf, plain=False) -> scalar``.  On the CPU: the f64 autograd
    gradient against finite differences; on the card: the f32 kernels'
    gradient against the plain path's.  Returns the max abs difference."""
    x0 = np.asarray(x0, np.float64)
    if device.type == "cpu":
        got = autograd_grad(f, x0, torch.float64, device)
        want = fd_grad(lambda x: f(torch.from_numpy(x)).item(), x0, eps)
        against = "FD"
    else:
        got = autograd_grad(f, x0, torch.float32, device)
        want = autograd_grad(f, x0, torch.float32, device, plain=True)
        against = "plain"
    diff = float(np.abs(got - want).max())
    denom = max(float(np.abs(want).max()), 1e-8)
    if verbose:
        print(f"{name:>22}: max|autograd-{against}| {diff:.3e}  rel {diff / denom:.3e}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    return diff


def build_test_fixture(device, dtype, n=40, sigma=0.4, cap=256, seed=0):
    cloud = make_toy_cloud(n_points=n, nr_classes=3, seed=seed)
    pos = torch.tensor(np.asarray(cloud.V), dtype=dtype, device=device)
    return cloud, pos, build_hierarchy(pos, sigma, 1, (cap, cap // 2))


def run_all(device=None, verbose=True) -> dict:
    """Every check of the module docstring; returns ``{op: max abs diff}``."""
    device = resolve_device(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    _, pos, h = build_test_fixture(device, dtype)
    cap, cap1 = h.structures[0].capacity, h.structures[1].capacity
    n = pos.shape[0]
    rng = np.random.default_rng(0)
    c_in, c_out = 3, 2
    idx, w = h.splat_idx, h.splat_weights.to(dtype)
    vals0 = rng.normal(size=(n, c_in))
    lv0 = ops.splat(torch.tensor(vals0, dtype=dtype, device=device), idx, w, cap).cpu().double().numpy()
    extent = h.neighbors_same[0].shape[1] + 1
    w_conv = rng.normal(size=(extent * c_in, c_out)) * 0.3
    w_cross = rng.normal(size=(extent * c_in, c_out)) * 0.3
    lv1 = rng.normal(size=(cap1, c_in))

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    def conv(table, same, weight):
        return lambda v, plain=False: (ops.conv_im2row(v, table, weight(v), same, dtype, plain) ** 2).sum()

    checks = [
        ("splat+slice", lambda v, plain=False: (ops.slice_lattice(ops.splat(v, idx, w, cap), idx, w, dtype,
                                                                  plain=plain) ** 2).sum(), vals0),  # fmt: skip
        ("conv(values)", conv(h.neighbors_same[0], True, lambda v: t(w_conv)), lv0),
        ("conv(weight)", lambda wt, plain=False: (ops.conv_im2row(t(lv0), h.neighbors_same[0], wt, True, dtype,
                                                                  plain) ** 2).sum(), w_conv),  # fmt: skip
        ("coarsen", conv(h.neighbors_coarsen[0], False, lambda v: t(w_cross)), lv0),
        ("finefy", conv(h.neighbors_finefy[0], False, lambda v: t(w_cross)), lv1),
        ("gather", lambda v, plain=False: (ops.gather_lattice(v, idx, w, dtype, plain=plain) ** 2).sum(), lv0),
    ]
    return {name: check_op(name, f, x0, device, verbose=verbose) for name, f, x0 in checks}


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default: f32 kernels vs plain) or cpu (f64 vs finite differences)")
    a = ap.parse_args()
    results = run_all(a.device)
    print(f"all {len(results)} gradient checks passed")


if __name__ == "__main__":
    main()
