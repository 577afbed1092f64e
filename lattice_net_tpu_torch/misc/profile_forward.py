"""Per-stage times of one served scan's forward, the stages of the JAX
package's ``misc/profile_forward.py``.

    python -m lattice_net_tpu_torch.misc.profile_forward [config]
        [--n-points N] [--cap C] [--sigma S] [--iters I] [--device cuda|cpu]
        [--trace DIR [--trace-only]] [section.key=value ...]

On one synthetic cloud of the config's dataset (``misc/profiling``; the
default config is ``config/lnn_eval_semantic_kitti.cfg`` on a 2^17-point
``make_scene`` scan) with the config's model at full width (seeded random
weights; bf16 convs on the card, f32 on the CPU; ``LNT_CONV_DTYPE``
overrides), each stage runs ``--iters`` times back to back after two
warm-up calls: the build of each level alone and with its same-level
neighbour table, the whole hierarchy, a conv, the
row gather, a segment sum, the distribute, the max-pool, the sorted segment
sum, the head gather, a GroupNorm, a Resnet block, the coarsen and finefy
convs, the PointNet, the head, the model on a prebuilt hierarchy and the
build with the model end to end.  One JSON line a stage: ``ms`` (CUDA
events on the card, host gaps included) and, from a ``torch.profiler``
capture of 3 more calls, the card's ``device_ms`` a call and its
``idle_share`` (1 - the union of its operations' intervals / wall; not
measured on the CPU), with the port's ``spans`` (calls and wall ms).  Capacities
halve from ``--cap`` (default: the config's ``hash_table_capacity``).

With ``--trace DIR`` (the JAX tool's ``--trace``) the warmed end-to-end
stage is captured once more and written as a Chrome trace to
``DIR/forward.pt.trace.json``; its ``trace`` line carries that capture's
``device_ms`` and ``idle_share``, so the trace and the summary read one
window (``misc/parse_trace.py DIR`` sums the trace per kernel).
``--trace-only`` skips the stage rows and traces only that stage.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from lattice_net_tpu_torch.config import (
    LatticeParams,
    TrainParams,
    apply_overrides,
    load_config,
    model_params_from_config,
)
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import ops
from lattice_net_tpu_torch.lattice.ops import default_conv_dtype
from lattice_net_tpu_torch.lattice.structure import (
    build_hierarchy,
    build_neighbors_same_level,
    build_structure,
    default_capacity_schedule,
)
from lattice_net_tpu_torch.misc.profiling import NR_CLASSES, mean_ms, profile, stage_row, synthetic_cloud
from lattice_net_tpu_torch.models.lnn import LNN, prepare_cloud
from lattice_net_tpu_torch.nn import modules as lnm

CONFIG = Path(__file__).resolve().parents[2] / "config" / "lnn_eval_semantic_kitti.cfg"
TRACE_NAME = "forward.pt.trace.json"
TRACED = 3  # end-to-end calls in the traced capture


def run(config=CONFIG, n_points=1 << 17, cap=0, sigma=0.0, iters=20, overrides=(), device=None, trace=None,
        trace_only=False):  # fmt: skip
    """Prints one JSON line of setup, then one a stage (none with
    ``trace_only``) and, with a ``trace`` directory, the traced capture's;
    returns the rows."""
    device = resolve_device(device)
    cfg = apply_overrides(load_config(config), overrides)
    tp, lp = TrainParams.from_config(cfg), LatticeParams.from_config(cfg)
    mp = model_params_from_config(cfg, NR_CLASSES.get(tp.dataset_name, 20))
    nl = mp.nr_downsamples
    caps = default_capacity_schedule(cap or lp.hash_table_capacity, nl)
    if not sigma:
        sigma = lp.sigmas[0] if len(set(lp.sigmas)) == 1 else tuple(lp.sigmas)
    positions, values, _ = prepare_cloud(synthetic_cloud(tp.dataset_name, n_points, seed=0), mp)
    pos = torch.from_numpy(positions).to(device)
    vals = torch.from_numpy(values).to(device)
    conv_dtype = default_conv_dtype(device)
    model = LNN(mp, torch.Generator().manual_seed(0), device=device, conv_dtype=conv_dtype).eval()
    with torch.inference_mode():
        h = build_hierarchy(pos, sigma, nl, caps, point_feats=vals)
    d = pos.shape[1]
    rows = [dict(setup=str(config), positions_mode=mp.positions_mode, d=d, points=n_points, capacities=list(caps),
                 occupancy=[int(s.nr_verts) for s in h.structures], conv_dtype=str(conv_dtype), device=str(device))]  # fmt: skip
    print(json.dumps(rows[0]), flush=True)

    def stage(name, fn):
        rows.append(stage_row(name, fn, device, iters))
        print(json.dumps(rows[-1]), flush=True)

    def e2e():
        hh = build_hierarchy(pos, sigma, nl, caps, point_feats=vals)
        return model(hh, pos, vals)[0].argmax(-1)

    def traced():
        with torch.inference_mode():
            mean_ms(e2e, device, iters=1)
            prof = profile(e2e, device, TRACED, trace=Path(trace) / TRACE_NAME)
        rows.append(dict(stage="END-TO-END (build + forward), traced", **prof))
        print(json.dumps(rows[-1]), flush=True)
        return rows

    if trace_only:
        return traced()
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    for lvl in range(nl + 1):
        feats = vals if lvl == 0 else None
        stage(f"build_structure L{lvl} (sort+dedup)", lambda l=lvl, f=feats: build_structure(
            pos, sig * 2.0**l, caps[l], l, with_edges=l == 0, point_feats=f, need_point_maps=l == 0))  # fmt: skip
    for lvl in range(nl + 1):
        stage(f"build L{lvl} + neighbors_same", lambda l=lvl: build_neighbors_same_level(
            build_structure(pos, sig * 2.0**l, caps[l], l)[0]))  # fmt: skip
    stage("build_hierarchy TOTAL", lambda: build_hierarchy(pos, sigma, nl, caps, point_feats=vals))

    c_in, c_out = 32, 32
    gen = torch.Generator().manual_seed(0)
    vals0 = torch.randn(caps[0], c_in, generator=gen).to(device)
    nbr0 = h.neighbors_same[0]
    extent = nbr0.shape[1] + 1
    w = (torch.randn(extent * c_in, c_out, generator=gen) * 0.05).to(device)
    mask0 = h.structures[0].occupancy_mask()
    stage(f"conv_im2row L0 ({caps[0]}x{c_in}->{c_out}, extent {extent})",
          lambda: ops.conv_im2row(vals0, nbr0, w, True, conv_dtype))  # fmt: skip
    stage(f"gather_rows L0 ({caps[0]}x{extent - 1} idx)", lambda: ops.gather_rows(vals0, nbr0))
    edge_idx = h.splat_idx.reshape(-1)
    edge_vals = torch.randn(edge_idx.shape[0], c_in, generator=gen).to(device)
    stage(f"segment_sum ({edge_idx.shape[0]} rows -> {caps[0]})", lambda: ops.segment_sum(edge_vals, edge_idx, caps[0]))
    dist = lambda: ops.distribute_sorted(pos, vals, h.edges, caps[0], splat_weights=h.splat_weights)[0]  # noqa: E731
    stage(f"distribute_sorted ({edge_idx.shape[0]} rows)", dist)
    with torch.inference_mode():
        rows_arr = dist()
    stage("seg_max_sorted", lambda: ops.seg_max_sorted(
        rows_arr[:, :-1].contiguous(), rows_arr[:, -1].contiguous(), h.edges, caps[0]))  # fmt: skip
    stage("seg_sum_sorted", lambda: ops.seg_sum_sorted(rows_arr, h.edges, caps[0]))
    head_vals = torch.randn(caps[0], 8, generator=gen).to(device)
    stage(f"gather_lattice head ({n_points} pts x 8ch)",
          lambda: ops.gather_lattice(head_vals, h.splat_idx, h.splat_weights))  # fmt: skip

    mods = dict(
        gn=lnm.GroupNormLattice(c_in), rb=lnm.ResnetBlock(c_in, gen, pos_dim=d, conv_dtype=conv_dtype),
        co=lnm.CoarsenConv(c_in, 64, gen, d, conv_dtype), fi=lnm.FinefyConv(64, c_in, gen, d, conv_dtype),
        pn=lnm.PointNetModule(rows_arr.shape[1] - 1, (16, 32), c_in, gen, d, conv_dtype=conv_dtype),
        sf=lnm.SliceFastModule(c_in, 20, gen),
    )  # fmt: skip
    for m in mods.values():
        m.to(device).eval()
    vals1 = torch.randn(caps[1], 64, generator=gen).to(device)
    stage(f"GroupNorm L0 ({caps[0]}x{c_in})", lambda: mods["gn"](vals0, mask0))
    stage("ResnetBlock L0 (2 convs + 2 GN)", lambda: mods["rb"](vals0, nbr0, mask0))
    stage(f"CoarsenConv L0->L1 ({c_in}->64)", lambda: mods["co"](vals0, h.neighbors_coarsen[0], h.neighbors_finefy[0]))
    stage(f"FinefyConv L1->L0 (64->{c_in})", lambda: mods["fi"](vals1, h.neighbors_finefy[0], h.neighbors_coarsen[0]))
    stage("PointNetModule (MLP + segmax + conv)", lambda: mods["pn"](rows_arr, h.edges, caps[0], nbr0))
    stage("SliceFast head (gather+dw+classify)",
          lambda: mods["sf"](vals0, mask0, h.splat_idx, h.splat_weights, h.edges))  # fmt: skip
    stage("LNN forward (prebuilt hierarchy)", lambda: model(h, pos, vals))
    stage("END-TO-END (build + forward)", e2e)
    return rows if trace is None else traced()


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", default=str(CONFIG))
    ap.add_argument("--n-points", type=int, default=1 << 17)
    ap.add_argument("--cap", type=int, default=0, help="level-0 capacity, halved a level (default: the config's)")
    ap.add_argument("--sigma", type=float, default=0.0, help="one sigma for every dimension (default: the config's)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, help=f"write a Chrome trace of the warmed end-to-end stage to DIR/{TRACE_NAME}")
    ap.add_argument("--trace-only", action="store_true", help="with --trace: skip the stage rows")
    ap.add_argument("overrides", nargs="*", help="config overrides (section.key=value)")
    a = ap.parse_args()
    if a.trace_only and a.trace is None:
        ap.error("--trace-only needs --trace DIR")
    run(a.config, a.n_points, a.cap, a.sigma, a.iters, a.overrides, a.device, a.trace, a.trace_only)


if __name__ == "__main__":
    main()
