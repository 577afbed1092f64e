"""Times of the hierarchy build's parts, the stages of the JAX package's
``misc/profile_build.py``.

    python -m lattice_net_tpu_torch.misc.profile_build [--n-points N]
        [--cap C] [--sigma S] [--iters I] [--positions-mode xyz|xyz+intensity|xyz+rgb]
        [--only-lookup] [--device cuda|cpu]

On one synthetic 2^17-point ``make_scene`` scan (its intensity or its
colours appended for the wider position modes; capacities C, C/2, C/8 as
in JAX), each stage runs ``--iters`` times back to back after two warm-up
calls: ``canonical_point_order``; ``build_hierarchy`` on the input order
and by the canonical fast build on canonically ordered points; level 0
alone by the default build and by the corner-dedup build; the same-level
and coarsen lookups of level 0.  (The JAX tool's A/B of its build
switches has no counterpart: the port has one formulation of each step.)
One JSON line a stage: ``ms`` (CUDA events on the card, host gaps
included) and, from a ``torch.profiler`` capture of 3 more calls, the
card's ``device_ms`` a call and ``idle_share`` (not measured on the CPU),
and the calls and wall ms of the build's spans (``tracing.SPANS``).
``--only-lookup`` (the JAX tool's) runs only the two lookup rows.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.misc.profiling import stage_row

POSITION_COLUMNS = {"xyz": "V", "xyz+intensity": "VI", "xyz+rgb": "VC"}


def hierarchy_tables(h):
    """Every table of a hierarchy, for a bit-equality check."""
    out = [s.keys for s in h.structures] + [s.nr_verts for s in h.structures]
    out += list(h.neighbors_same) + list(h.neighbors_coarsen) + list(h.neighbors_finefy)
    return out + [h.splat_idx, h.splat_weights, h.edges.perm, h.edges.vertex, h.edges.ends]


def positions_of(mode: str, n_points: int, seed: int = 0) -> np.ndarray:
    """A ``make_scene`` scan's positions in a positions mode."""
    cloud = make_scene(n_points, seed=seed)
    cols = {"V": cloud.V, "I": cloud.I, "C": cloud.C}
    return np.concatenate([cols[c] for c in POSITION_COLUMNS[mode]], axis=1).astype(np.float32)


def run(n_points=1 << 17, cap=1 << 16, sigma=0.6, iters=20, positions_mode="xyz", device=None, only_lookup=False):
    """Prints one JSON line of setup, then one a stage (the two lookup rows
    alone with ``only_lookup``); returns the rows."""
    device = resolve_device(device)
    caps = (cap, cap >> 1, cap >> 3)
    pos = torch.from_numpy(positions_of(positions_mode, n_points)).to(device)
    n, d = pos.shape
    with torch.inference_mode():
        perm = st.canonical_point_order(pos, sigma)
        pos_c = pos[perm]
        h = st.build_hierarchy(pos, sigma, 2, caps)
    rows = [dict(setup="make_scene", positions_mode=positions_mode, d=d, points=n, sigma=sigma, capacities=list(caps),
                 occupancy=[int(s.nr_verts) for s in h.structures], device=str(device))]  # fmt: skip
    print(json.dumps(rows[0]), flush=True)

    def stage(name, fn):
        rows.append(stage_row(name, fn, device, iters))
        print(json.dumps(rows[-1]), flush=True)

    sig = torch.as_tensor(sigma, dtype=torch.float32, device=device).broadcast_to((d,))
    mask = torch.ones(n, dtype=torch.bool, device=device)
    if not only_lookup:
        stage("canonical_point_order", lambda: st.canonical_point_order(pos, sigma))
        stage("build_hierarchy GENERIC (input order)", lambda: st.build_hierarchy(pos, sigma, 2, caps))
        stage("build_hierarchy CANONICAL fast (pre-sorted input)",
              lambda: st.build_hierarchy(pos_c, sigma, 2, caps, canonical_points=True))  # fmt: skip
        stage("L0 build_structure generic (with edges)",
              lambda: st.build_structure(pos, sigma, caps[0], with_edges=True))  # fmt: skip
        stage("L0 canonical corner-dedup build (pre-sorted)",
              lambda: st._canonical_fast_build(pos_c, sig, caps[0], caps[0] // 2, mask))  # fmt: skip
    s0, s1 = h.structures[0], h.structures[1]
    moves = st._axis_moves(d, device)
    occ0, occ1 = s0.occupancy_mask(), s1.occupancy_mask()
    q_same = torch.where(occ0[:, None], s0.keys, 0)[:, None, :] + moves[None]
    base1 = torch.where(occ1[:, None], s1.keys, 0)[:, None, :] * 2
    q_coarsen = torch.cat([base1 + moves[None], base1 - moves[None], base1], dim=1)
    stage(f"same-level lookup cap0 ({q_same.shape[0]}x{q_same.shape[1]})", lambda: s0.lookup(q_same))
    stage(f"coarsen lookup cap1->cap0 ({q_coarsen.shape[0]}x{q_coarsen.shape[1]})", lambda: s0.lookup(q_coarsen))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-points", type=int, default=1 << 17)
    ap.add_argument("--cap", type=int, default=1 << 16)
    ap.add_argument("--sigma", type=float, default=0.6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--positions-mode", default="xyz", choices=sorted(POSITION_COLUMNS))
    ap.add_argument("--only-lookup", action="store_true", help="time only the same-level and coarsen lookups")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    run(a.n_points, a.cap, a.sigma, a.iters, a.positions_mode, a.device, a.only_lookup)


if __name__ == "__main__":
    main()
