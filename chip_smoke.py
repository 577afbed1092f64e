#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lattice_net_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no ``"ok"`` line):

1. environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the four ``csrc/*.cu`` (one nvcc per source, in
   parallel);
2. the forward kernels K1 and K2 against their plain PyTorch versions on
   the card, on exactly the inputs of each of their calls in one served
   scan (recorded during that forward; K2 also with ties planted): bit
   equality required; kernel, plain and library times by CUDA events;
3. serving: ``Predictor.from_config`` on the SemanticKITTI eval config at
   full width (seeded random weights) answers five 2^17-point scans and one
   of 100000 points padded with a point mask; per request the latency, the
   per-level occupancy and the kernel launch counts, which must equal the
   model's 15 patch gathers and 1 max-pool;
4. the same scan with the kernels and with their plain versions (bf16 convs
   both): labels agree on >= 99.9% of points, log-probabilities to 1e-3;
5. a small scan in f32 on the card against the plain path on the CPU (the
   path the CPU tests hold against the JAX package): log-probabilities to
   1e-3, labels on >= 99%;
6. all four kernels against their plain versions, on exactly the inputs of
   each of their calls in one train step of phase 7 (recorded during that
   step): K1's 43 calls (the forward's 15, and in each conv's backward the
   recomputed patch and the flipped conv of the cotangent) and K2 bit-equal,
   K2-bwd's d_vals bit-equal (also with ties planted), K1-bwd (f32 atomics)
   and K2-bwd's d_carry to ``BWD_TOL``; kernel, plain and library times and
   byte bounds per call, summed per step;
7. training: the SemanticKITTI train config at full width (seeded random
   weights, bf16 convs, AdamW-amsgrad with cosine warm restarts) takes 10
   steps of ``make_train_step`` on one 2^17-point scan with its labels; per
   step the time, the loss, the level-0 occupancy, the overflow and the
   launches of the four kernels, which must equal 3 gathers per conv module
   plus the head's (43), and 1 each of K1-bwd, K2 and K2-bwd.  The loss and
   the new parameters must stay finite, and the mean loss of the last 3
   steps must be below that of the first 3;
8. one step's loss and gradients with the kernels and with their plain
   versions from the same state (bf16 convs both): loss to 1e-5, each
   parameter's gradient to ``TRAIN_PLAIN_GRAD_REL``.  Also printed: how far
   a second run with the kernels lies from the first, and how far a run
   lies when the flipped gather of one conv reads the wrong row for 1% of
   its queries (each conv in turn), which must exceed the tolerance;
9. a small f32 step on the card against the plain path on the CPU: loss to
   1e-5, each parameter's gradient to ``TRAIN_CPU_GRAD_REL``.

The next-to-last lines are the card (``nvidia-smi`` name, power limit) and
one JSON object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
TRAIN_CONFIG = ROOT / "config" / "lnn_train_semantic_kitti.cfg"
NR_CLASSES = 20
KITTI_TRAIN_SCANS = 19130  # one epoch at batch size 1: the schedule's period is 3
TRAIN_STEPS = 10
KERNELS = ("patch_gather", "seg_max", "patch_scatter", "seg_max_bwd")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SERVE_TOL = dict(logp_max_abs=1e-3, label_agreement=0.999)
CPU_TOL = dict(logp_max_abs=1e-3, label_agreement=0.99)
# f32 atomics (K1-bwd) and a warp-shuffle sum over channels (K2-bwd's
# d_carry) add in another order than the plain versions: each entry within
# 1e-4 of itself plus 1e-6 of the largest entry
BWD_TOL = dict(rtol=1e-4, atol_of_max=1e-6)
LOSS_ATOL = 1e-5
# kernels vs plain, bf16 convs: about twice the largest reading on an H100
# (1.56e-3 to 2.01e-3).  K1-bwd's atomics and K2-bwd's d_carry add in another
# order than the plain versions, and the phase prints how far two runs with
# the kernels lie apart for that reason alone.  A flipped gather wrong on 1% of
# its rows must fail this limit: the phase plants that fault in each conv.
TRAIN_PLAIN_GRAD_REL = 4e-3
# card vs CPU, f32: every GEMM, norm and scatter sums in another order, and
# the deep layers' f32 gradients are only good to ~1e-3 on any device (the
# CPU's own are up to 6e-4 from f64 there: misc/grad_precision.py)
TRAIN_CPU_GRAD_REL = 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )  # fmt: skip
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    from lattice_net_tpu_torch.ops_cuda import _build

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    names = ", ".join(f"csrc/{k}.cu" for k in KERNELS)
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    return card


def scan(pred, n_points, seed):
    """(positions, values) of one synthetic LiDAR scan, per the config's modes."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud

    positions, values, _ = prepare_cloud(make_scene(n_points, seed=seed), pred.params)
    return positions, values


@contextlib.contextmanager
def recording_kernel_inputs(torch):
    """Records the inputs of every kernel call made inside the block, in call
    order, copied as the caller passed them: yields ``(calls, phase)`` with
    ``calls = {"k1": [(values, table, include_center, role), ...], "k2":
    [...], "k1b": [...], "k2b": [...]}``.  K1 calls made after the caller
    sets ``phase[0] = "backward"`` alternate between the two of each conv's
    backward: the recomputed patch of the weight gradient, then the flipped
    conv of the value gradient (the order of ``ops._ConvFlip.backward``)."""
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.ops_cuda import patch, segment

    calls = dict(k1=[], k2=[], k1b=[], k2b=[])
    phase = ["forward"]
    k1, k2 = ops.patch_gather, ops.seg_max_carry
    k1b, k2b = patch.patch_scatter, segment.seg_max_carry_bwd

    def recording_k1(values, neighbors, include_center, plain=False):
        role = phase[0]
        if role == "backward":
            n_bwd = sum(c[3] != "forward" for c in calls["k1"])
            role = ("backward: patch of d_w", "backward: flipped conv of d_values")[n_bwd % 2]
        calls["k1"].append((values.detach().clone(), neighbors.clone(), include_center, role))
        return k1(values, neighbors, include_center, plain=plain)

    def recording_k2(*args, plain=False):
        calls["k2"].append(tuple(t.detach().clone() for t in args))
        return k2(*args, plain=plain)

    def recording_k1b(g, neighbors, cap, include_center):
        calls["k1b"].append((g.clone(), neighbors.clone(), cap, include_center))
        return k1b(g, neighbors, cap, include_center)

    def recording_k2b(*args):
        calls["k2b"].append(tuple(t.clone() for t in args))
        return k2b(*args)

    # the backward wrappers count on the module names they are called by,
    # which are the recorders' here: give those counts a home (a recording
    # run is not the main path, whose counts start at 0 later)
    recording_k1b.launches = recording_k2b.launches = 0
    ops.patch_gather, ops.seg_max_carry = recording_k1, recording_k2
    patch.patch_scatter, segment.seg_max_carry_bwd = recording_k1b, recording_k2b
    try:
        yield calls, phase
    finally:
        ops.patch_gather, ops.seg_max_carry = k1, k2
        patch.patch_scatter, segment.seg_max_carry_bwd = k1b, k2b


def check_k1(torch, calls, dev, where):
    """K1 against its plain version and ``index_select`` on each recorded
    call ``(values, table, include_center, role)``, bit-equal, and timed
    there with its byte bound.  Returns the sums over the calls."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_gather_plain

    tot = dict(calls=len(calls), ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0)  # fmt: skip
    for v, table, center, role in calls:
        (cap, c), (q, k) = v.shape, table.shape
        label = f"cap={cap} C={c} Q={q} K={k}{'+centre' if center else ''}"
        got = patch_gather(v, table, center)
        want = patch_gather_plain(v, table, center)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"K1 {where} {role} {label}: kernel != plain (max abs {err})")
        # yardstick: one index_select on the table with a zero row appended
        ids = torch.where((table >= 0) & (table < cap), table, cap)
        if center:
            ids = torch.cat([ids, torch.arange(q, device=dev, dtype=ids.dtype)[:, None]], 1)
        ids = ids.reshape(-1).long()
        vz = torch.cat([v, v.new_zeros(1, c)])
        check(torch.equal(vz.index_select(0, ids).reshape(got.shape), got),
              f"K1 {where} {role} {label}: library")  # fmt: skip
        # bytes this call needs: each value row that some id (or the centre
        # column) references, read once; the id table; the patch, written once
        rows_read = int(torch.unique(ids[ids < cap]).numel())
        nbytes = rows_read * c * v.element_size() + table.numel() * 4
        nbytes += got.numel() * got.element_size()
        row = dict(
            kernel="K1 patch_gather", where=where, role=role, shape=label,
            dtype=str(v.dtype).removeprefix("torch."), rows_read=rows_read,
            ms=time_ms(torch, lambda: patch_gather(v, table, center)),
            plain_ms=time_ms(torch, lambda: patch_gather_plain(v, table, center)),
            library_ms=time_ms(torch, lambda: vz.index_select(0, ids)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
        )  # fmt: skip
        emit(row)
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            tot[key] += row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return tot


def check_k2(torch, args, where):
    """K2 against its plain version on one recorded call, then once more with
    ties planted (the same values rounded to quarters repeat within runs):
    bit-equal; timed on the recorded inputs with its byte bound."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    feats, carry, ids, run_end = args
    err = 0.0
    for v in (feats, torch.round(feats * 4) / 4):
        got = seg_max_carry(v, carry, ids, run_end)
        want = seg_max_carry_plain(v, carry, ids, run_end)
        torch.cuda.synchronize()
        err = max([err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"K2 {where}: kernel != plain ({err})")
    # bytes: the rows of edges that lie in some vertex's run, their carry,
    # the run ends, and the two outputs
    (m, c), cap = feats.shape, run_end.shape[0]
    in_runs = int((ids < cap).sum())
    nbytes = (in_runs * (c + 1) + run_end.numel() + 2 * got[0].numel()) * 4
    row = dict(
        kernel="K2 seg_max_carry", where=where, shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs, ms=time_ms(torch, lambda: seg_max_carry(feats, carry, ids, run_end)),
        plain_ms=time_ms(torch, lambda: seg_max_carry_plain(feats, carry, ids, run_end)),
        library_ms=None, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def kernels_vs_plain(torch, pred, dev):
    """K1 and K2 against their plain versions, and timed, on exactly the
    inputs one served 2^17-point scan (seed 0) gives them."""
    pos, vals = scan(pred, 1 << 17, seed=0)
    with recording_kernel_inputs(torch) as (calls, _):
        pred.forward(pos, vals)
    k1 = check_k1(torch, calls["k1"], dev, "served scan")
    check(len(calls["k2"]) == 1, f"{len(calls['k2'])} max-pools in one forward, expected 1")
    return k1, check_k2(torch, calls["k2"][0], "served scan")


def conv_modules(model):
    from lattice_net_tpu_torch.nn.modules import ConvIm2Row, _CrossLevelConv

    return sum(isinstance(m, (ConvIm2Row, _CrossLevelConv)) for m in model.modules())


def patch_gathers_per_scan(model):
    """K1 launches one forward must make: one per lattice conv module, plus
    the head's per-point gather."""
    return conv_modules(model) + 1


def patch_gathers_per_step(model):
    """K1 launches one train step must make: the forward's, and two more per
    conv module in the backward (the recomputed patch of the weight
    gradient, the flipped conv of the value gradient)."""
    return patch_gathers_per_scan(model) + 2 * conv_modules(model)


def counters():
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_scatter
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_bwd

    return dict(k1=patch_gather, k1b=patch_scatter, k2=seg_max_carry, k2b=seg_max_carry_bwd)


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def serve(torch, pred, k1_per_scan):
    requests = [(1 << 17, s) for s in range(5)] + [(100000, 5)]
    totals = dict(k1=0, k2=0)
    latencies = []
    for i, (n, seed) in enumerate(requests):
        pos, vals = scan(pred, n, seed)
        zero_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logp, h = pred.forward(pos, vals)
        labels = torch.argmax(logp, dim=-1)[:n]
        stop.record()
        labels = labels.cpu()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        k1, k2 = counts["k1"], counts["k2"]
        check(counts["k1b"] == counts["k2b"] == 0, f"request {i} launched backward kernels")
        totals["k1"] += k1
        totals["k2"] += k2
        ms = start.elapsed_time(stop)
        latencies.append(ms)
        occ = [int(s.nr_verts) for s in h.structures]
        ovf = [int(s.nr_overflow) for s in h.structures]
        emit(dict(
            request=i, points=n, seed=seed, latency_ms=ms, host_ms=host_ms,
            occupancy=occ, capacities=list(pred.capacities), overflow=ovf,
            k1_launches=k1, k2_launches=k2,
        ))  # fmt: skip
        check(
            k1 == k1_per_scan and k2 == 1,
            f"request {i}: launches K1={k1} K2={k2}, expected {k1_per_scan} and 1",
        )
        check(tuple(logp.shape) == (pred.n_points, NR_CLASSES), f"logp shape {tuple(logp.shape)}")
        check(bool(torch.isfinite(logp).all()), f"request {i}: non-finite log-probabilities")
        check(int(labels.min()) >= 0 and int(labels.max()) < NR_CLASSES, "labels out of range")
    steady = sorted(latencies[1:])
    emit(dict(
        serving="SemanticKITTI eval config, 2^17-point budget", requests=len(requests),
        first_ms=latencies[0], steady_median_ms=steady[len(steady) // 2],
        steady_min_ms=steady[0], steady_max_ms=steady[-1],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ))  # fmt: skip
    return totals


def kernels_vs_plain_end_to_end(torch, pred):
    pos, vals = scan(pred, 1 << 17, seed=0)
    logp_k, _ = pred.forward(pos, vals)
    zero_counts()
    logp_p, _ = pred.forward(pos, vals, plain=True)
    check(not any(read_counts().values()), "plain run launched kernels")
    n = len(pos)
    agree = (logp_k[:n].argmax(-1) == logp_p[:n].argmax(-1)).float().mean().item()
    diff = (logp_k[:n] - logp_p[:n]).abs().max().item()
    emit(dict(check="kernels vs plain, whole path, bf16 convs", label_agreement=agree,
              logp_max_abs=diff, tolerance=SERVE_TOL))  # fmt: skip
    check(agree >= SERVE_TOL["label_agreement"], f"label agreement {agree}")
    check(diff <= SERVE_TOL["logp_max_abs"], f"logp max abs {diff}")


def card_vs_cpu(torch, dev):
    from lattice_net_tpu_torch.serve import Predictor

    small = dict(nr_classes=NR_CLASSES, conv_dtype=torch.float32, seed=1, n_points=1 << 13)
    gpu = Predictor.from_config(CONFIG, device=dev, **small)
    cpu = Predictor.from_config(CONFIG, device="cpu", **small)
    pos, vals = scan(cpu, 6000, seed=11)
    logp_g, _ = gpu.forward(pos, vals)
    logp_c, _ = cpu.forward(pos, vals)
    n = len(pos)
    logp_g = logp_g[:n].cpu()
    agree = (logp_g.argmax(-1) == logp_c[:n].argmax(-1)).float().mean().item()
    diff = (logp_g - logp_c[:n]).abs().max().item()
    emit(dict(check="card vs CPU plain path, f32, 6000 points", label_agreement=agree,
              logp_max_abs=diff, tolerance=CPU_TOL))  # fmt: skip
    check(agree >= CPU_TOL["label_agreement"], f"card vs CPU label agreement {agree}")
    check(diff <= CPU_TOL["logp_max_abs"], f"card vs CPU logp max abs {diff}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_batch(torch, dev, n_points, budget, seed):
    """One synthetic scan with its labels, padded to ``budget`` points as the
    trainer's batcher does (the train config's values mode is "none")."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import ModelParams, prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import make_batch

    cloud = prepare_cloud(make_scene(n_points, seed=seed), ModelParams(values_mode="none"))
    return make_batch([cloud], budget, device=dev)


def close(torch, got, want):
    """Max abs error, and whether it is within ``BWD_TOL``."""
    err = (got - want).abs()
    bound = BWD_TOL["rtol"] * want.abs() + BWD_TOL["atol_of_max"] * want.abs().max()
    return err.max().item(), bool((err <= bound).all())


def train_step_kernels_vs_plain(torch, run, state, batch, dev):
    """Every kernel against its plain version, and timed, on exactly the
    inputs one train step's forward and backward (the step's own stages)
    give it: K1's forward and backward calls, the forward's K2, K1-bwd and
    K2-bwd."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_scatter, patch_scatter_plain
    from lattice_net_tpu_torch.ops_cuda.segment import (
        seg_max_carry_bwd,
        seg_max_carry_bwd_plain,
        seg_max_carry_plain,
    )
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    with recording_kernel_inputs(torch) as (calls, phase):
        leaves, loss, _ = forward_loss(run.loss_fn(), state.params, batch)
        phase[0] = "backward"
        gradients(loss, leaves)
    roles = [c[3] for c in calls["k1"]]
    n_conv = conv_modules(run.model)
    check(
        roles.count("forward") == patch_gathers_per_scan(run.model)
        and len(roles) == patch_gathers_per_step(run.model),
        f"K1 calls in one step: {len(roles)}, {roles.count('forward')} in the forward; expected "
        f"{patch_gathers_per_step(run.model)} and {patch_gathers_per_scan(run.model)} "
        f"({n_conv} convs and a head)",
    )
    k1 = check_k1(torch, calls["k1"], dev, "train step")
    check(len(calls["k2"]) == 1, f"{len(calls['k2'])} max-pools in one step, expected 1")
    k2 = check_k2(torch, calls["k2"][0], "train step")
    check(len(calls["k1b"]) == 1, f"{len(calls['k1b'])} K1-bwd calls in one step, expected 1")
    check(len(calls["k2b"]) == 1, f"{len(calls['k2b'])} K2-bwd calls in one step, expected 1")

    g, table, cap, center = calls["k1b"][0]
    (q, kk, c), k = g.shape, table.shape[1]
    got = patch_scatter(g, table, cap, center)
    want = patch_scatter_plain(g, table, cap, center)
    torch.cuda.synchronize()
    err, ok = close(torch, got, want)
    check(ok, f"K1-bwd: kernel != plain beyond {BWD_TOL} (max abs {err})")
    # yardstick: one index_add_ into a table with a row for the dropped ids
    ids = torch.where((table >= 0) & (table < cap), table, cap).reshape(-1).long()
    g_rows = g[:, :k].reshape(-1, c)
    lib = lambda: torch.zeros(cap + 1, c, device=g.device).index_add_(0, ids, g_rows)  # noqa: E731
    check(not center, "K1-bwd runs for the head gather, which has no centre column")
    check(close(torch, lib()[:cap], want)[1], "K1-bwd: library call != plain")
    nbytes = (g.numel() + table.numel() + cap * c) * 4
    k1b = dict(
        kernel="K1-bwd patch_scatter", shape=f"Q={q} K={k}{'+centre' if center else ''} C={c} "
        f"cap={cap}", ms=time_ms(torch, lambda: patch_scatter(g, table, cap, center)),
        plain_ms=time_ms(torch, lambda: patch_scatter_plain(g, table, cap, center)),
        library_ms=time_ms(torch, lib), bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err,
    )  # fmt: skip
    emit(k1b)

    # K2-bwd on the max-pool's inputs, then once more with ties planted: the
    # same values rounded to quarters repeat within runs, and the maxima are
    # taken anew from them
    vals, ids, run_end, maxed, g_max, g_carry = calls["k2b"][0]
    cap = run_end.shape[0]
    vals_q = torch.round(vals * 4) / 4
    maxed_q, _ = seg_max_carry_plain(vals_q, torch.zeros_like(vals[:, 0]), ids, run_end)
    err = 0.0
    ties = 0
    for args in ((vals, ids, run_end, maxed, g_max, g_carry),
                 (vals_q, ids, run_end, maxed_q, g_max, g_carry)):  # fmt: skip
        got = seg_max_carry_bwd(*args)
        want = seg_max_carry_bwd_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), "K2-bwd: d_vals kernel != plain")
        e, ok = close(torch, got[1], want[1])
        check(ok, f"K2-bwd: d_carry kernel != plain beyond {BWD_TOL} (max abs {e})")
        err = max(err, e, (got[0] - want[0]).abs().max().item())
        idc = ids.long().clamp(max=cap - 1)
        hits = ((args[0] == args[3][idc]) & (ids < cap)[:, None]).float()
        per = torch.zeros(cap + 1, vals.shape[1], device=vals.device)
        ties = int((per.index_add_(0, ids.long().clamp(max=cap), hits)[:cap] > 1).sum())
    check(ties > 0, "the tie-planted K2-bwd case has no tie")
    (m, c) = vals.shape
    in_runs = int((ids < cap).sum())
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    present = int((run_end > prev).sum())
    nbytes = (in_runs * c + cap + 3 * present * c + m * c + m) * 4
    k2b = dict(
        kernel="K2-bwd seg_max_carry_bwd", shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs, vertices_with_runs=present, tied_pairs_planted=ties,
        ms=time_ms(torch, lambda: seg_max_carry_bwd(vals, ids, run_end, maxed, g_max, g_carry)),
        plain_ms=time_ms(
            torch, lambda: seg_max_carry_bwd_plain(vals, ids, run_end, maxed, g_max, g_carry)
        ),
        library_ms=None, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(k2b)
    return k1, k2, k1b, k2b


def all_finite(torch, tensors):
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def train(torch, run, state, batch):
    """The main training path: ``TRAIN_STEPS`` steps of ``make_train_step``."""
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy

    model = run.model
    expected = dict(k1=patch_gathers_per_step(model), k1b=1, k2=1, k2b=1)
    b = {k: v[0] for k, v in batch.items()}
    h = build_hierarchy(
        b["positions"], run.sigma, model.params.nr_downsamples, run.capacities,
        point_mask=b["point_mask"], point_feats=b["values"],
    )  # fmt: skip
    emit(dict(
        training="SemanticKITTI train config, one 2^17-point scan", capacities=list(run.capacities),
        occupancy=[int(s.nr_verts) for s in h.structures],
        overflow=[int(s.nr_overflow) for s in h.structures], expected_launches=expected,
    ))  # fmt: skip
    step = run.train_step()
    totals = dict.fromkeys(expected, 0)
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        stop.synchronize()
        counts = read_counts()
        for k in totals:
            totals[k] += counts[k]
        times.append(start.elapsed_time(stop))
        losses.append(float(metrics["loss"]))
        emit(dict(
            step=i, step_ms=times[-1], loss=losses[-1], acc=float(metrics["acc"]),
            occupancy_level0=float(metrics["nr_verts_mean"]),
            overflow=float(metrics["nr_overflow_mean"]), launches=counts,
        ))  # fmt: skip
        check(counts == expected, f"step {i}: launches {counts}, expected {expected}")
        check(math.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}")
        check(all_finite(torch, state.params.values()), f"step {i}: non-finite parameters")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    steady = sorted(times[1:])
    emit(dict(
        training_steps=TRAIN_STEPS, first_step_ms=times[0], steady_median_ms=steady[len(steady) // 2],
        steady_min_ms=steady[0], steady_max_ms=steady[-1], loss_first3=first, loss_last3=last,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ))  # fmt: skip
    check(last < first, f"loss did not fall: first 3 steps {first}, last 3 {last}")
    return totals, expected


def loss_and_grads(torch, loss_fn, params, batch, plain=False):
    """The loss and gradients of one step, by the train step's own stages."""
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    leaves, loss, _ = forward_loss(loss_fn, params, batch, plain=plain)
    return loss.item(), gradients(loss, leaves)


def worst_rel_l2(torch, got, want):
    """The parameter whose gradient is furthest from ``want``'s, by relative
    L2 error, and that error."""
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        w = w.double().cpu()
        rel = ((got[k].double().cpu() - w).norm() / w.norm().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, k
    return worst, worst_name


def compare_grads(torch, got, want, tol, what):
    worst, worst_name = worst_rel_l2(torch, got, want)
    check(all_finite(torch, list(got.values())), f"{what}: non-finite gradients")
    check(worst <= tol, f"{what}: gradient of {worst_name} off by {worst} (rel L2 > {tol})")
    return worst, worst_name


def faulty_grads(torch, loss_fn, params, batch, conv):
    """Gradients with the kernels, but with the flipped conv of the value
    gradient of one conv module (``conv``-th in backward order) reading the
    next row of the cotangent for every 100th query: a K1 call that is
    wrong on 1% of its rows."""
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    k1 = ops.patch_gather
    n_bwd = [0]

    def faulty_k1(values, neighbors, include_center, plain=False):
        if n_bwd[0] == 2 * conv + 1:
            cap = values.shape[0]
            neighbors = neighbors.clone()
            rows = neighbors[::100]
            neighbors[::100] = torch.where((rows >= 0) & (rows < cap), (rows + 1) % cap, rows)
        n_bwd[0] += 1
        return k1(values, neighbors, include_center, plain=plain)

    leaves, loss, _ = forward_loss(loss_fn, params, batch)
    ops.patch_gather = faulty_k1  # every K1 call from here on is the backward's
    try:
        grads = gradients(loss, leaves)
    finally:
        ops.patch_gather = k1
    check(n_bwd[0] > 2 * conv + 1, f"the backward made only {n_bwd[0]} patch gathers")
    return grads


def train_kernels_vs_plain(torch, run, state, batch):
    """One step's loss and gradients with the kernels against the plain
    versions, bf16 convs both.  Two readings frame the tolerance: a second
    run with the kernels (K1-bwd's atomics and K2-bwd's shuffle sums add in
    another order each time, nothing else differs), and each conv's flipped
    gather made wrong on 1% of its rows, which the tolerance must fail."""
    loss_fn = run.loss_fn()
    loss_k, grads_k = loss_and_grads(torch, loss_fn, state.params, batch)
    _, grads_k2 = loss_and_grads(torch, loss_fn, state.params, batch)
    zero_counts()
    loss_p, grads_p = loss_and_grads(torch, loss_fn, state.params, batch, plain=True)
    check(not any(read_counts().values()), "the plain step launched kernels")
    repeat, repeat_name = worst_rel_l2(torch, grads_k2, grads_k)
    faults = [worst_rel_l2(torch, faulty_grads(torch, loss_fn, state.params, batch, j), grads_p)
              for j in range(conv_modules(run.model))]  # fmt: skip
    weakest = min(range(len(faults)), key=lambda j: faults[j][0])
    worst, name = worst_rel_l2(torch, grads_k, grads_p)
    emit(dict(check="train step, kernels vs plain, bf16 convs", loss=loss_k,
              loss_abs_diff=abs(loss_k - loss_p), worst_grad_rel_l2=worst, worst_param=name,
              kernels_vs_kernels_rel_l2=repeat, kernels_vs_kernels_param=repeat_name,
              planted_fault_rel_l2=[f[0] for f in faults], planted_fault_weakest=weakest,
              planted_fault_weakest_param=faults[weakest][1],
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_PLAIN_GRAD_REL)))  # fmt: skip
    compare_grads(torch, grads_k, grads_p, TRAIN_PLAIN_GRAD_REL, "kernels vs plain")
    check(abs(loss_k - loss_p) <= LOSS_ATOL, f"kernels vs plain loss {loss_k} vs {loss_p}")
    check(
        faults[weakest][0] > TRAIN_PLAIN_GRAD_REL,
        f"a flipped gather wrong on 1% of its rows (conv {weakest} in backward order) moved the "
        f"gradients by only {faults[weakest][0]}: the tolerance {TRAIN_PLAIN_GRAD_REL} would pass it",
    )


def train_card_vs_cpu(torch, dev):
    from lattice_net_tpu_torch.train.setup import TrainSetup

    small = dict(conv_dtype=torch.float32, seed=1)
    gpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, **small)
    cpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device="cpu", **small)
    batch_g, batch_c = (train_batch(torch, d, 6000, 1 << 13, seed=11) for d in (dev, "cpu"))
    loss_g, grads_g = loss_and_grads(torch, gpu.loss_fn(), gpu.model.state_dict(), batch_g)
    loss_c, grads_c = loss_and_grads(torch, cpu.loss_fn(), cpu.model.state_dict(), batch_c)
    worst, name = compare_grads(torch, grads_g, grads_c, TRAIN_CPU_GRAD_REL, "card vs CPU")
    emit(dict(check="train step, card vs CPU plain path, f32, 6000 points", loss=loss_g,
              loss_abs_diff=abs(loss_g - loss_c), worst_grad_rel_l2=worst, worst_param=name,
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_CPU_GRAD_REL)))  # fmt: skip
    check(abs(loss_g - loss_c) <= LOSS_ATOL, f"card vs CPU loss {loss_g} vs {loss_c}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from lattice_net_tpu_torch.serve import Predictor
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = environment(torch)

    pred = Predictor.from_config(CONFIG, nr_classes=NR_CLASSES, device=dev, seed=0)
    k1, k2 = kernels_vs_plain(torch, pred, dev)
    k1_per_scan = k1["calls"]
    check(
        k1_per_scan == patch_gathers_per_scan(pred.model),
        f"one forward made {k1_per_scan} patch gathers, the model has "
        f"{patch_gathers_per_scan(pred.model)} convs and a head",
    )
    launches = serve(torch, pred, k1_per_scan)
    kernels_vs_plain_end_to_end(torch, pred)
    card_vs_cpu(torch, dev)
    del pred

    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.train.setup import TrainSetup

    run = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, seed=0)
    batch = train_batch(torch, dev, 1 << 17, 1 << 17, seed=0)
    state = TrainState.create(run.model.state_dict(), run.tx)
    k1_step, k2_step, k1b, k2b = train_step_kernels_vs_plain(torch, run, state, batch, dev)
    trained, per_step = train(torch, run, state, batch)
    train_kernels_vs_plain(torch, run, state, batch)
    train_card_vs_cpu(torch, dev)

    def both(key):
        return dict(launches=launches.get(key, 0) + trained[key],
                    launches_serving=launches.get(key, 0), launches_training=trained[key])  # fmt: skip

    def per_train_step(t):
        return {f"{k}_per_step": t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    rows = [
        dict(
            name="patch_gather", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_gather.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:133", **both("k1"),
            launches_per_scan=k1_per_scan, launches_per_step=per_step["k1"],
            max_abs_err=max(k1["max_abs_err"], k1_step["max_abs_err"]), ms=k1["ms"],
            plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"], bound_by="bytes",
            library_ms=k1["library_ms"], **per_train_step(k1_step),
            timed_as=f"ms: sum over the {k1_per_scan} gathers of one served scan; ms_per_step: "
            f"sum over the {k1_step['calls']} gathers of one train step; each on its own inputs",
        ),
        dict(
            name="seg_max_carry", route="cuda", source="lattice_net_tpu_torch/csrc/seg_max.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:413", **both("k2"),
            launches_per_scan=1, launches_per_step=per_step["k2"],
            max_abs_err=max(k2["max_abs_err"], k2_step["max_abs_err"]), ms=k2["ms"],
            plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"], bound_by="bytes", library_ms=None,
            **per_train_step(k2_step),
            timed_as="ms: the max-pool of one served scan; ms_per_step: that of one train step",
        ),
        dict(
            name="patch_scatter", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_scatter.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:252", **both("k1b"),
            launches_per_step=per_step["k1b"], max_abs_err=k1b["max_abs_err"], ms=k1b["ms"],
            plain_ms=k1b["plain_ms"], bound_ms=k1b["bound_ms"], bound_by="bytes",
            library_ms=k1b["library_ms"], timed_as="the head gather's adjoint in one train step",
        ),
        dict(
            name="seg_max_carry_bwd", route="cuda",
            source="lattice_net_tpu_torch/csrc/seg_max_bwd.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:488", **both("k2b"),
            launches_per_step=per_step["k2b"], max_abs_err=k2b["max_abs_err"], ms=k2b["ms"],
            plain_ms=k2b["plain_ms"], bound_ms=k2b["bound_ms"], bound_by="bytes",
            library_ms=None, timed_as="the max-pool's adjoint in one train step",
        ),
    ]  # fmt: skip
    print(card)
    emit({"kernels": rows})
    name = torch.cuda.get_device_name(0)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
