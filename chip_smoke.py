#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lattice_net_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no ``"ok"`` line); phases 2-9
run the default head (``LNT_HEAD_SEGVJP=0``, ``LNT_HEAD_PRECLASSIFY=1``)
whatever the caller's environment:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the six ``csrc/*.cu`` (one nvcc per source, in
   parallel) and the native scan reader (``native/cloud_loader.cpp``, g++);
2. the forward kernels K1 and K2 against their plain PyTorch versions on
   the card, on exactly the inputs of each of their calls in one served
   scan (recorded during that forward): bit equality required; kernel,
   plain and library times by CUDA events.  K2 runs twice on each of six
   cases, its outputs landing on NaN-filled blocks of the caching
   allocator, both outputs bit-equal to the plain version and to
   themselves: the recorded call, ties planted, ``PAD_EDGES`` edges in no
   run appended, ``LONG_RUN`` edges added to one vertex, ties planted on
   both sides of the 32-row chunk bounds of that long run (the later row
   must win), and ``NARROW_K2B`` random columns (the scalar kernel).  Its
   row also times one max-only ``torch.segment_reduce``, labelled as a
   reference: it computes no carry, so it is not K2's library call;
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
   recomputed patch and the flipped conv of the cotangent) and K2 (on the
   cases of phase 2) bit-equal, K1-bwd (f32 atomics) to ``BWD_TOL`` on the
   recorded call and three cases built from it (the centre column on a
   same-level table, ids equal to cap and negative, ``NARROW_K1B`` random
   columns), twice each into NaN-filled blocks, with the gap between the
   two runs and the share of the head's rows whose destination repeats
   within 32 consecutive points; kernel, plain and library times and byte
   bounds per call, summed per step.  The max-pool's run lengths are
   printed (edges in runs, non-empty runs, mean, p99, max, a log2
   histogram).  K2-bwd runs twice on each of five cases, its outputs landing
   on blocks of the caching allocator filled with NaN: the recorded call,
   ties planted, ``PAD_EDGES`` edges in no run appended, ``LONG_RUN`` edges
   added to one vertex, and ``NARROW_K2B`` random columns (C % 4 != 0, the
   scalar kernel).  Its d_vals must be bit-equal to the plain version and to
   itself, its d_carry within ``BWD_TOL`` and bit-equal to itself;
7. training: the SemanticKITTI train config at full width (seeded random
   weights, bf16 convs, AdamW-amsgrad with cosine warm restarts) takes 10
   steps of ``make_train_step`` on one 2^17-point scan with its labels; per
   step the time, the loss, the level-0 occupancy, the overflow and the
   launches of the six kernels, which must equal 3 gathers per conv module
   plus the head's (43), 1 each of K1-bwd, K2 and K2-bwd, and no K3 or K4.
   The loss and the new parameters must stay finite, and the mean loss of
   the last 3 steps must be below that of the first 3;
8. one step's loss and gradients with the kernels and with their plain
   versions from the same state (bf16 convs both): loss to 1e-5, each
   parameter's gradient to ``TRAIN_PLAIN_GRAD_REL``.  Also printed: how far
   a second run with the kernels lies from the first, and how far a run
   lies when the flipped gather of one conv reads the wrong row for 1% of
   its queries (each conv in turn), which must exceed the tolerance;
9. a small f32 step on the card against the plain path on the CPU: loss to
   1e-5, each parameter's gradient to ``TRAIN_CPU_GRAD_REL``;
10. K3 and K4 against their plain versions, on exactly the inputs of their
    calls in one train step with the edge-sort head adjoint
    (``LNT_HEAD_SEGVJP=1``), once with the default preclassified head (f32
    K4, K3 at C = 28) and once with ``LNT_HEAD_PRECLASSIFY=0`` (bf16 K4, K3
    at C = 8 + 96): K4 bit-equal, K3 within ``BWD_TOL`` of its plain version
    (whose ``index_add_`` adds with atomics) and bit-equal to itself run
    twice, into NaN-filled blocks, on the recorded call and on the cases of
    phase 6 (``NARROW_K3`` random columns for the width); the run lengths of
    each call; kernel, plain and library times and byte bounds per call;
11. training with ``LNT_HEAD_SEGVJP=1``: from phase 7's state and scan,
    ``TRAIN_STEPS`` steps, each run right after a step of the default head
    from its own copy of that state, so that the two step medians come from
    interleaved runs.  Per step the time, the loss and the launches, which
    must equal the model's: K1 loses the head's gather (42), K4 and K3 one
    each, K1-bwd none, K2 and K2-bwd one each.  The loss must fall as in
    phase 7;
12. one segvjp step's loss and gradients against the default head's, against
    its plain versions (bf16 convs both), and card f32 against the CPU's
    plain path, at ``LOSS_ATOL``, ``TRAIN_PLAIN_GRAD_REL`` and
    ``TRAIN_CPU_GRAD_REL``.  Two faults are planted, and each must move the
    gradients past the tolerance: K3 sums one vertex's run into its
    neighbour's row (the vertex with the largest run sum), and it does so for
    1% of the vertices;
13. one train step with ``dropout_last_layer = 0.5`` and a Philox generator
    on the card: finite loss and parameters, one keep mask for one seed, and
    the same loss from two forwards with generators of one seed;
14. the training CLI's ``run`` on the card: ``config/lnn_train_synthkitti20.cfg``
    at full width (2^17-point procedural 20-class scenes, capacities
    65536/32768/16384, sigma 0.6, ``"auto"`` class weights,
    ``reduce_on_plateau``) with 8 train and 4 test scenes, checkpoints and a
    scene cache in a temporary directory, for 2 epochs testing after each;
    then ``run(..., max_epochs=3, resume=<dir>/last.ckpt)``.  The printed
    class weights must agree with line 43 of ``docs/runs/synthkitti20_r5.log``
    (the JAX run's) within ``CLASS_WEIGHT_ATOL`` (the entries equal to 3
    decimals are counted); every train and test loss must be
    finite; each train step must launch the default head's kernels (43 K1,
    1 K1-bwd, 1 K2, 1 K2-bwd, no K3 or K4) and each test forward no
    backward kernel (15 K1, 1 K2); ``last.ckpt`` and one ``model_e_*`` file
    must exist; ``last.ckpt`` must load bit-equal to the first run's final
    state; the second run must resume at step 16 (epoch 2) and end at step
    24, its plateau state equal to the saved one carried through its 8 step
    losses.  Printed per epoch: the train and test loss, the mIoU and the
    samples per second (the first train epoch's include the scene
    synthesis on the host);
15. SemanticKITTI evaluation: ``write_kitti_dir`` writes ``KITTI_SCANS``
    20-class 2^17-point scans in the dataset's layout (train in sequence 00,
    test in 11) in a temporary directory, which is also the working
    directory of the phase; the training CLI trains one epoch of
    ``config/lnn_train_semantic_kitti.cfg`` at full width on them (only the
    dataset and checkpoint paths overridden; its test phase falls back to
    sequence 11), then ``ln_eval`` runs ``config/lnn_eval_semantic_kitti.cfg``
    from its ``last.ckpt`` twice, at the default budget (one chunk a scan)
    and at ``EVAL_CHUNK`` points (two).  Each run must write one ``.label``
    per test scan at ``sequences/11/predictions/<scan>.label`` with one
    uint32 per velodyne point, every value one of ``LEARNING_MAP_INV``'s;
    launch 15 K1 and 1 K2 per chunk and no other kernel; label >= 99.9% of
    points as ``Predictor.forward(plain=True)`` does on the same chunks; and
    ``prepare_submission`` must accept its directory.  The one-chunk run's
    mIoU must be within ``EVAL_MIOU_ATOL`` of the trainer's test phase (the
    same weights and scans).  Printed: seconds per scan and scans/s and the
    mIoU of both budgets, beside the CPU ablation's gap
    (``docs/runs/eval_chunk_ablation.log``).  Then ``ln_eval_stream`` runs
    ``config/ln_eval_stream.cfg`` with seeded weights, ``STREAM_SCENES``
    scenes and ``STREAM_SCANS`` scans at ``STREAM_HZ`` for each wire (f32,
    f16, i16): one finite latency per scan, 15 K1 and 1 K2 launches per
    forward, the f32 wire's labels equal to ``Predictor.predict``'s on the
    same scans (the other wires' agreement printed), and its compute-only
    and H2D times, MB per scan, end-to-end p50/p95/max, misses and
    sustained scans/s printed.

Each timed call has two times: ``ms`` (:func:`time_ms`, back-to-back calls
between two CUDA events, which counts the card's idle gaps where the host
issues a call more slowly than the card runs it) and ``device_ms``
(:func:`device_ms`, the same calls queued behind a sleeping kernel, so the
card alone); likewise ``plain_*`` and ``library_*``.

The next-to-last lines are the card (``nvidia-smi`` name, power limit) and
one JSON object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
TRAIN_CONFIG = ROOT / "config" / "lnn_train_semantic_kitti.cfg"
SYNTH_CONFIG = ROOT / "config" / "lnn_train_synthkitti20.cfg"
# the JAX run of SYNTH_CONFIG; its line 43 prints the "auto" class weights
JAX_RUN_LOG, JAX_WEIGHTS_LINE = ROOT / "docs" / "runs" / "synthkitti20_r5.log", 43
TRAINER_SCENES = dict(train=8, test=4)
# The JAX run's weights are those of scout scenes with a few points labelled
# otherwise: its 3-decimal weights imply label counts that differ from the
# generator's by whole points, 1-5 at the least of the scout's 4 * 2^17 in 8
# of the 20 classes, which moves those weights by up to 0.003
# (tests/test_torch_data.py::test_jax_scout_class_weights_against_the_r5_log
# pins the gaps).  The generator is unchanged since the run: the JAX package
# at that run's commit prints the port's weights on the CPU test host, and
# so does this card's host.  That run read its scout scenes from an
# LNT_SCENE_CACHE directory filled earlier, on a host and numpy the repo does
# not record.
CLASS_WEIGHT_ATOL = 5e-3
TRAINER_EPOCHS = 2
STREAM_CONFIG = ROOT / "config" / "ln_eval_stream.cfg"
CHUNK_ABLATION_LOG = ROOT / "docs" / "runs" / "eval_chunk_ablation.log"
KITTI_SCANS, KITTI_POINTS = dict(train=4, test=3), 1 << 17
EVAL_CHUNK = KITTI_POINTS // 2  # two chunks a scan
# the eval's one-chunk forward is the trainer's test forward on the same
# weights, scans and budget (bf16 convs both)
EVAL_MIOU_ATOL = 1e-3
STREAM_SCENES, STREAM_SCANS, STREAM_HZ = 8, 20, 10.0
NR_CLASSES = 20
KITTI_TRAIN_SCANS = 19130  # one epoch at batch size 1: the schedule's period is 3
TRAIN_STEPS = 10
KERNELS = ("patch_gather", "seg_max", "patch_scatter", "seg_max_bwd", "seg_sum", "take_rows")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the times of each kernel row: PR 4's yardstick (time_ms) and the card alone
# (device_ms), each for the kernel, its plain version and the library call
TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms", "library_device_ms",
         "bound_ms")
SERVE_TOL = dict(logp_max_abs=1e-3, label_agreement=0.999)
CPU_TOL = dict(logp_max_abs=1e-3, label_agreement=0.99)
# f32 atomics (K1-bwd, and K3's plain version's index_add_) and a
# warp-shuffle sum over channels (K2-bwd's d_carry) add in another order than
# the other side: each entry within 1e-4 of itself plus 1e-6 of the largest
# entry
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
DROPOUT = 0.5
# cases built from a recorded K2, K2-bwd or K3 call: edges in no run
# appended, edges added to one vertex's run; and for those and K1-bwd,
# widths with C % 4 != 0 (13; 13 + 8 for K3, whose vector path starts above
# C = 8)
PAD_EDGES = 4096
LONG_RUN = 8192
NARROW_K2B = 13
NARROW_K1B = 13
NARROW_K3 = 13 + 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` back-to-back calls, by CUDA events.
    Where the host takes longer to issue a call than the card to run it,
    this counts the card's idle time between the calls too."""
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


def device_ms(torch, fn, iters=20, warmup=3, sleep_cycles=20_000_000):
    """Mean ms per call on the card alone: ``iters`` calls queued behind a
    kernel that spins while the host issues them, so that the card runs
    them back to back whatever the host's pace.  The sleep grows until it
    outlasts the host's issuing; None where it never does, because the
    calls wait for the card themselves (``segment_reduce`` reads its output
    size back to the host)."""
    for _ in range(warmup):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(3):
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(sleep_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        sleep_cycles *= 4
    return None


def timings(torch, kernel, plain, library=None):
    """``ms``/``plain_ms``/``library_ms`` as :func:`time_ms` reads them, and
    the same three as :func:`device_ms` reads them (``*device_ms``)."""
    row = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        row[key] = None if fn is None else time_ms(torch, fn)
        row[key.replace("ms", "device_ms")] = None if fn is None else device_ms(torch, fn)
    return row


def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )  # fmt: skip
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    import numpy

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"numpy {numpy.__version__}")  # fmt: skip
    from lattice_net_tpu_torch.ops_cuda import _build

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    names = ", ".join(f"csrc/{k}.cu" for k in KERNELS)
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    from lattice_net_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    lib = native_loader.build_native()
    print(f"built the native scan reader {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    return card


def scan(pred, n_points, seed):
    """(positions, values) of one synthetic LiDAR scan, per the config's modes."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud

    positions, values, _ = prepare_cloud(make_scene(n_points, seed=seed), pred.params)
    return positions, values


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables (the head's switches) inside the block."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def segvjp(preclassify="1"):
    return environ(LNT_HEAD_SEGVJP="1", LNT_HEAD_PRECLASSIFY=preclassify)


def default_head():
    return environ(LNT_HEAD_SEGVJP="0", LNT_HEAD_PRECLASSIFY="1")


@contextlib.contextmanager
def recording_kernel_inputs(torch):
    """Records the inputs of every kernel call made inside the block, in call
    order, copied as the caller passed them: yields ``(calls, phase)`` with
    ``calls = {"k1": [(values, table, include_center, role), ...], "k2":
    [...], "k1b": [...], "k2b": [...], "k3": [...], "k4": [...]}``.  K1
    calls made after the caller sets ``phase[0] = "backward"`` alternate
    between the two of each conv's backward: the recomputed patch of the
    weight gradient, then the flipped conv of the value gradient (the order
    of ``ops._ConvFlip.backward``)."""
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.ops_cuda import patch, segment

    calls = dict(k1=[], k2=[], k1b=[], k2b=[], k3=[], k4=[])
    phase = ["forward"]
    k1, k2, k3, k4 = ops.patch_gather, ops.seg_max_carry, ops.seg_sum_sorted_fast, ops.take_rows
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

    def recording_k3(vals, ids, run_end, cap, plain=False):
        calls["k3"].append((vals.detach().clone(), ids.clone(), run_end.clone(), cap))
        return k3(vals, ids, run_end, cap, plain=plain)

    def recording_k4(values, idx, plain=False):
        calls["k4"].append((values.detach().clone(), idx.clone()))
        return k4(values, idx, plain=plain)

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
    ops.seg_sum_sorted_fast, ops.take_rows = recording_k3, recording_k4
    patch.patch_scatter, segment.seg_max_carry_bwd = recording_k1b, recording_k2b
    try:
        yield calls, phase
    finally:
        ops.patch_gather, ops.seg_max_carry = k1, k2
        ops.seg_sum_sorted_fast, ops.take_rows = k3, k4
        patch.patch_scatter, segment.seg_max_carry_bwd = k1b, k2b


def check_k1(torch, calls, dev, where):
    """K1 against its plain version and ``index_select`` on each recorded
    call ``(values, table, include_center, role)``, bit-equal, and timed
    there with its byte bound.  Returns the sums over the calls."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_gather_plain

    tot = dict(calls=len(calls), max_abs_err=0.0, **dict.fromkeys(TIMES, 0.0))
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
            **timings(torch, lambda: patch_gather(v, table, center),
                      lambda: patch_gather_plain(v, table, center),
                      lambda: vz.index_select(0, ids)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
        )  # fmt: skip
        emit(row)
        for key in TIMES:  # None (not measurable) in any call leaves the sum None
            tot[key] = None if None in (tot[key], row[key]) else tot[key] + row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return tot


def k2_cases(torch, args):
    """The recorded K2 call ``(feats, carry, ids, run_end)`` and the cases
    built from it, as ``(name, args, winners)``: ties planted (the values
    rounded to quarters repeat within runs), :func:`extra_cases` (the carry
    rides along as a last column), ties across the 32-row chunk bounds of
    the long run (:func:`chunk_ties`, whose ``winners`` are not None) and
    ``NARROW_K2B`` random columns (the scalar kernel)."""
    feats, carry, ids, run_end = args
    yield "recorded", args, None
    yield "ties planted", (torch.round(feats * 4) / 4, carry, ids, run_end), None
    both = torch.cat([feats, carry[:, None]], 1)
    for name, v, i, r in extra_cases(torch, both, ids, run_end, seed=11):
        case = (v[:, :-1].contiguous(), v[:, -1].contiguous(), i, r)
        yield name, case, None
        if name.startswith("long run"):
            yield chunk_ties(torch, case)
    cols = random_columns(torch, NARROW_K2B, feats.shape[1], 12, feats.device)
    yield f"C={NARROW_K2B} random columns", (feats[:, cols].contiguous(), carry, ids, run_end), None


def chunk_ties(torch, args):
    """A case with a new maximum planted twice in each channel of the
    longest run, on both sides of the edge array's 32-row chunk bounds,
    where the kernel cuts the run into pieces: rows b - 1 and b (channels
    0, 3, ...), b' - 1 and b' (1, 4, ...), and b - 1 and b' + 7 (2, 5, ...),
    with b and b' multiples of 32 five chunks apart.  The later row of each
    pair must win.  Returns ``(name, args, (vertex, winning row of each
    channel))``."""
    feats, carry, ids, run_end = args
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    v0 = int((run_end - prev).argmax())
    start, end = int(prev[v0]) + 1, int(run_end[v0])
    b = (start // 32 + 2) * 32
    b2 = b + 5 * 32
    check(b2 + 7 <= end, f"chunk ties: the run of vertex {v0} ({start}-{end}) is too short")
    feats = feats.clone()
    pairs = [(b - 1, b), (b2 - 1, b2), (b - 1, b2 + 7)]
    rows = [pairs[ch % 3] for ch in range(feats.shape[1])]
    top = feats[start : end + 1].max() + 1
    for ch, pair in enumerate(rows):
        feats[list(pair), ch] = top
    name = f"ties across chunk bounds (vertex {v0}, rows {start}-{end}, b = {b}, b' = {b2})"
    return name, (feats, carry, ids, run_end), (v0, [last for _, last in rows])


def check_k2_case(torch, name, args, dev, where):
    """K2 run twice into NaN-filled blocks: both outputs bit-equal to the
    plain version and to themselves.  Returns the first run's outputs and
    their largest difference from the plain version's."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    feats = args[0]
    cap, c = args[3].shape[0], feats.shape[1]
    runs = []
    for _ in range(2):
        ptrs = nan_blocks(torch, [(cap, c), (cap, c)], dev)
        got = seg_max_carry(*args)
        check(sorted(t.data_ptr() for t in got) == sorted(ptrs),
              f"K2 {where} {name}: outputs off the NaN blocks")  # fmt: skip
        runs.append(got)
    want = seg_max_carry_plain(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(runs[0], want))
    check(all(torch.equal(a, b) for a, b in zip(runs[0], want)),
          f"K2 {where} {name}: kernel != plain (max abs {err})")  # fmt: skip
    check(all(torch.equal(a, b) for a, b in zip(*runs)), f"K2 {where} {name}: two runs differ")
    emit(dict(check=f"K2 {where} {name}", shape=f"M={feats.shape[0]} C={c}", max_abs_err=err))
    return runs[0], err


def check_k2(torch, args, where, dev):
    """K2 against its plain version on one recorded call and the cases built
    from it (:func:`k2_cases`), bit-equal, into NaN-filled blocks; timed on
    the recorded inputs with its byte bound.  Beside it, labelled as a
    reference and not as K2's library call: one ``torch.segment_reduce(...,
    "max", lengths=...)``, which gives the max without the carry."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    err = 0.0
    for name, case, winners in k2_cases(torch, args):
        (_, out_carry), e = check_k2_case(torch, name, case, dev, where)
        err = max(err, e)
        if winners is not None:  # the later row of each tied pair won
            v0, rows = winners
            want = case[1][torch.tensor(rows, device=dev)]
            check(torch.equal(out_carry[v0], want), f"K2 {where} {name}: not the latest winner")
    feats, carry, ids, run_end = args
    # bytes: the rows of edges that lie in some vertex's run, their carry,
    # the run ends, and the two outputs
    (m, c), cap = feats.shape, run_end.shape[0]
    in_runs = int((ids < cap).sum())
    nbytes = (in_runs * (c + 1) + run_end.numel() + 2 * cap * c) * 4
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    lengths = (run_end - prev).long()
    head = feats[:in_runs]
    ref = lambda: torch.segment_reduce(head, "max", lengths=lengths)  # noqa: E731
    maxed = seg_max_carry_plain(feats, carry, ids, run_end)[0]
    present = lengths > 0
    check(torch.equal(ref()[present], maxed[present]), f"K2 {where}: segment_reduce max != plain")
    row = dict(
        kernel="K2 seg_max_carry", where=where, shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs,
        **timings(torch, lambda: seg_max_carry(feats, carry, ids, run_end),
                  lambda: seg_max_carry_plain(feats, carry, ids, run_end)),
        max_only_segment_reduce_ms=time_ms(torch, ref),
        max_only_segment_reduce_device_ms=device_ms(torch, ref),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
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
    return k1, check_k2(torch, calls["k2"][0], "served scan", dev)


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


def launches_per_step(model, segvjp):
    """Every kernel's launches in one train step.  Each head makes one row
    gather and one adjoint: K1 and K1-bwd by default; with the edge-sort
    adjoint K4 forward and K3 backward instead.  The PointNet max-pool is
    one K2 and one K2-bwd."""
    from lattice_net_tpu_torch.nn.modules import SliceFastModule

    heads = sum(isinstance(m, SliceFastModule) for m in model.modules())
    if not segvjp:
        return dict(k1=patch_gathers_per_step(model), k1b=heads, k2=1, k2b=1, k3=0, k4=0)
    return dict(k1=patch_gathers_per_step(model) - heads, k1b=0, k2=1, k2b=1, k3=heads, k4=heads)


def counters():
    from lattice_net_tpu_torch.ops_cuda.gather import take_rows
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_scatter
    from lattice_net_tpu_torch.ops_cuda.segment import (
        seg_max_carry,
        seg_max_carry_bwd,
        seg_sum_sorted_fast,
    )

    return dict(
        k1=patch_gather, k1b=patch_scatter, k2=seg_max_carry, k2b=seg_max_carry_bwd,
        k3=seg_sum_sorted_fast, k4=take_rows,
    )  # fmt: skip


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
        check(
            counts["k1b"] == counts["k2b"] == counts["k3"] == counts["k4"] == 0,
            f"request {i} launched kernels off the serving path: {counts}",
        )
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


def runs_from_ids(torch, ids, cap):
    """``EdgeSort.run_end`` from sorted vertex ids: for each vertex v the last
    position with an id <= v (-1 before the first edge)."""
    v = torch.arange(cap, device=ids.device, dtype=ids.dtype)
    return (torch.searchsorted(ids, v, right=True) - 1).to(torch.int32)


def run_length_stats(torch, run_end, where):
    """Prints the run lengths of one call's ``run_end``: edges in runs,
    non-empty runs, mean, p99 and max, and per log2 bin [2^k, 2^(k+1)) the
    runs and the edges they hold."""
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    n = (run_end - prev).long()
    nz = n[n > 0]
    check(nz.numel() > 0, f"{where}: no edge in any run")
    bins = torch.floor(torch.log2(nz.double())).long()
    runs = torch.bincount(bins).tolist()
    edges = torch.zeros(len(runs), dtype=torch.long, device=n.device).index_add_(0, bins, nz).tolist()
    row = dict(
        run_lengths=where, cap=run_end.shape[0], edges_in_runs=int(nz.sum()),
        nonempty_runs=int(nz.numel()), mean=float(nz.double().mean()),
        p99=float(torch.quantile(nz.double(), 0.99)), max=int(nz.max()),
        log2_bins_runs_edges={f"{1 << k}-{(2 << k) - 1}": [r, e]
                              for k, (r, e) in enumerate(zip(runs, edges)) if r},
    )  # fmt: skip
    emit(row)
    return row


def extra_cases(torch, vals, ids, run_end, seed):
    """Two cases built from one recorded call ``(vals, ids, run_end)``, as
    ``(name, vals, ids, run_end)``: ``PAD_EDGES`` edges with id = cap
    appended after the last run, and ``LONG_RUN`` edges added to the run of
    the vertex at the middle edge.  New rows are normal at the recorded
    values' spread."""
    m, c = vals.shape
    cap = run_end.shape[0]
    check(torch.equal(runs_from_ids(torch, ids, cap), run_end), "recorded run_end != runs of the ids")
    gen = torch.Generator(device=vals.device).manual_seed(seed)

    def rows(n):
        return torch.randn(n, c, generator=gen, device=vals.device) * vals.std()

    yield ("padded tail", torch.cat([vals, rows(PAD_EDGES)]),
           torch.cat([ids, ids.new_full((PAD_EDGES,), cap)]), run_end)  # fmt: skip
    v0 = int(ids[int((ids < cap).sum()) // 2])
    p = int(run_end[v0]) + 1
    ids_l = torch.cat([ids[:p], ids.new_full((LONG_RUN,), v0), ids[p:]])
    vals_l = torch.cat([vals[:p], rows(LONG_RUN), vals[p:]])
    yield f"long run (vertex {v0})", vals_l, ids_l, runs_from_ids(torch, ids_l, cap)


def random_columns(torch, n, c, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(c, generator=gen)[:n].sort().values.to(device)


def nan_blocks(torch, shapes, dev):
    """Leaves the caching allocator a free block of each shape filled with
    NaN, so that outputs of those shapes allocated next land on them: an
    element a kernel fails to write stays NaN.  Returns their pointers, for
    the caller to confirm."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(s, math.nan, device=dev) for s in shapes]
    ptrs = [b.data_ptr() for b in blocks]
    del blocks
    return ptrs


def check_k2b_case(torch, name, args, dev):
    """K2-bwd run twice into NaN-filled blocks: d_vals bit-equal to the
    plain version and to itself, d_carry within ``BWD_TOL`` and bit-equal
    to itself.  Returns the largest difference from the plain version."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_bwd, seg_max_carry_bwd_plain

    m, c = args[0].shape
    runs = []
    for _ in range(2):
        ptrs = nan_blocks(torch, [(m, c), (m,)], dev)
        got = seg_max_carry_bwd(*args)
        check([t.data_ptr() for t in got] == ptrs, f"K2-bwd {name}: outputs off the NaN blocks")
        runs.append(got)
    want = seg_max_carry_bwd_plain(*args)
    torch.cuda.synchronize()
    (d_vals, d_carry), (d_vals2, d_carry2) = runs
    check(torch.equal(d_vals, want[0]), f"K2-bwd {name}: d_vals kernel != plain")
    err, ok = close(torch, d_carry, want[1])
    check(ok, f"K2-bwd {name}: d_carry kernel != plain beyond {BWD_TOL} (max abs {err})")
    same = torch.equal(d_vals, d_vals2) and torch.equal(d_carry, d_carry2)
    check(same, f"K2-bwd {name}: two runs differ")
    emit(dict(check=f"K2-bwd {name}", shape=f"M={m} C={c}", d_carry_max_abs_err=err))
    return err


def k2b_cases(torch, args):
    """The recorded K2-bwd call and the cases built from it, as ``(name,
    args)``: ties planted, :func:`extra_cases` (maxima taken anew) and
    ``NARROW_K2B`` random columns."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_plain

    vals, ids, run_end, maxed, g_max, g_carry = args

    def maxima(v, i, r):
        return seg_max_carry_plain(v, torch.zeros_like(v[:, 0]), i, r)[0]

    yield "recorded", args
    # ties: the same values rounded to quarters repeat within runs, and the
    # maxima are taken anew from them
    vals_q = torch.round(vals * 4) / 4
    yield "ties planted", (vals_q, ids, run_end, maxima(vals_q, ids, run_end), g_max, g_carry)
    for name, v, i, r in extra_cases(torch, vals, ids, run_end, seed=7):
        yield name, (v, i, r, maxima(v, i, r), g_max, g_carry)
    cols = random_columns(torch, NARROW_K2B, vals.shape[1], 8, vals.device)
    yield (f"C={NARROW_K2B} random columns",
           tuple(t[:, cols].contiguous() if t.dim() == 2 else t for t in args))  # fmt: skip


def tied_pairs(torch, vals, ids, run_end, maxed):
    """(vertex, channel) pairs whose run holds more than one winner."""
    cap = run_end.shape[0]
    idc = ids.long().clamp(max=cap - 1)
    hits = ((vals == maxed[idc]) & (ids < cap)[:, None]).float()
    per = torch.zeros(cap + 1, vals.shape[1], device=vals.device)
    return int((per.index_add_(0, ids.long().clamp(max=cap), hits)[:cap] > 1).sum())


def dest_repeat_share(torch, table, cap, window=32):
    """The share of the valid rows of an id table whose destination already
    appears in the same slot among the ``window`` consecutive queries (a
    warp's worth of points): the atomics that aggregating same-destination
    rows inside a warp would save."""
    q, k = table.shape
    valid = (table >= 0) & (table < cap)
    w = torch.arange(q, device=table.device)[:, None] // window
    key = ((w * k + torch.arange(k, device=table.device)) * (cap + 1) + table.long())[valid]
    n = int(valid.sum())
    return (n - int(torch.unique(key).numel())) / max(n, 1)


def k1b_cases(torch, args, k1_calls):
    """The recorded K1-bwd call ``(g, table, cap, include_center)`` and three
    cases built from it, as ``(name, args)``: the centre column on a
    same-level table of the step (the first recorded K1 call with one, with
    a cotangent at the recorded values' spread), ids equal to cap and
    negative ids (which drop), and ``NARROW_K1B`` random columns (scalar
    atomics)."""
    g, table, cap, center = args
    yield "recorded", args
    values, same, _, _ = next(c for c in k1_calls if c[2])
    q, k = same.shape
    gen = torch.Generator(device=g.device).manual_seed(13)
    g_c = torch.randn(q, k + 1, g.shape[2], generator=gen, device=g.device) * g.std()
    yield f"centre column, same-level table (Q={q} K={k})", (g_c, same, values.shape[0], True)
    bad = table.clone()
    bad[::7, 1] = cap
    bad[::11, 2] = -1
    bad[::13, 0] = -cap - 3
    yield "ids = cap and negative ids", (g, bad, cap, center)
    cols = random_columns(torch, NARROW_K1B, g.shape[2], 14, g.device)
    yield f"C={NARROW_K1B} random columns", (g[:, :, cols].contiguous(), table, cap, center)


def check_k1b(torch, args, k1_calls, dev):
    """K1-bwd against its plain version on the recorded call and the cases of
    :func:`k1b_cases`, within ``BWD_TOL``, run twice into NaN-filled blocks
    (the kernel zeroes its output itself); the gap between the two runs (the
    atomics' order) is printed.  Timed on the recorded call with its byte
    bound; library: one ``index_add_`` into a table with a row for the
    dropped ids.  Also printed: the destination-repeat share of the
    recorded table (:func:`dest_repeat_share`), and the card's time for the
    same cotangent into ids drawn uniformly from the vertices the call
    reaches (no hot vertex), which shows what the destinations' skew
    costs."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_scatter, patch_scatter_plain

    err, gap = 0.0, 0.0
    for name, (g_, t_, cap_, center_) in k1b_cases(torch, args, k1_calls):
        outs = []
        for _ in range(2):
            ptrs = nan_blocks(torch, [(cap_, g_.shape[2])], dev)
            outs.append(patch_scatter(g_, t_, cap_, center_))
            check(outs[-1].data_ptr() == ptrs[0], f"K1-bwd {name}: output off the NaN block")
        want = patch_scatter_plain(g_, t_, cap_, center_)
        torch.cuda.synchronize()
        e, ok = close(torch, outs[0], want)
        check(ok, f"K1-bwd {name}: kernel != plain beyond {BWD_TOL} (max abs {e})")
        check(close(torch, outs[1], want)[1], f"K1-bwd {name}: second run != plain beyond {BWD_TOL}")
        run_gap = (outs[0] - outs[1]).abs().max().item()
        emit(dict(check=f"K1-bwd {name}", shape=f"Q={t_.shape[0]} K={t_.shape[1]}"
                  f"{'+centre' if center_ else ''} C={g_.shape[2]} cap={cap_}", max_abs_err=e,
                  two_runs_max_abs_gap=run_gap))  # fmt: skip
        err, gap = max(err, e), max(gap, run_gap)
    g, table, cap, center = args
    (q, kk, c), k = g.shape, table.shape[1]
    check(not center, "K1-bwd runs for the head gather, which has no centre column")
    # yardstick: one index_add_ into a table with a row for the dropped ids
    ids = torch.where((table >= 0) & (table < cap), table, cap).reshape(-1).long()
    g_rows = g[:, :k].reshape(-1, c)
    lib = lambda: torch.zeros(cap + 1, c, device=g.device).index_add_(0, ids, g_rows)  # noqa: E731
    check(close(torch, lib()[:cap], patch_scatter_plain(g, table, cap, center))[1],
          "K1-bwd: library call != plain")  # fmt: skip
    # the destinations' skew: the same cotangent into ids drawn uniformly
    # from the vertices the call reaches
    used = torch.unique(table[(table >= 0) & (table < cap)])
    gen = torch.Generator(device=g.device).manual_seed(15)
    uniform = used[torch.randint(0, used.numel(), table.shape, generator=gen, device=g.device)]
    uniform = uniform.to(table.dtype)
    nbytes = (g.numel() + table.numel() + cap * c) * 4
    row = dict(
        kernel="K1-bwd patch_scatter", shape=f"Q={q} K={k} C={c} cap={cap}",
        **timings(torch, lambda: patch_scatter(g, table, cap, center),
                  lambda: patch_scatter_plain(g, table, cap, center), lib),
        device_ms_uniform_ids=device_ms(torch, lambda: patch_scatter(g, uniform, cap, center)),
        dest_repeat_share_32=dest_repeat_share(torch, table, cap),
        two_runs_max_abs_gap=gap, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def train_step_kernels_vs_plain(torch, run, state, batch, dev):
    """Every kernel against its plain version, and timed, on exactly the
    inputs one train step's forward and backward (the step's own stages)
    give it: K1's forward and backward calls, the forward's K2, K1-bwd and
    K2-bwd."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_bwd, seg_max_carry_bwd_plain
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
    k2 = check_k2(torch, calls["k2"][0], "train step", dev)
    check(len(calls["k1b"]) == 1, f"{len(calls['k1b'])} K1-bwd calls in one step, expected 1")
    check(len(calls["k2b"]) == 1, f"{len(calls['k2b'])} K2-bwd calls in one step, expected 1")

    k1b = check_k1b(torch, calls["k1b"][0], calls["k1"], dev)

    # K2-bwd on the max-pool's inputs and the cases built from them
    vals, ids, run_end, maxed, g_max, g_carry = calls["k2b"][0]
    cap = run_end.shape[0]
    run_length_stats(torch, run_end, "train step, max-pool (K2, K2-bwd)")
    err, ties = 0.0, 0
    for name, args in k2b_cases(torch, calls["k2b"][0]):
        err = max(err, check_k2b_case(torch, name, args, dev))
        if name == "ties planted":
            ties = tied_pairs(torch, *args[:4])
    check(ties > 0, "the tie-planted K2-bwd case has no tie")
    (m, c) = vals.shape
    in_runs = int((ids < cap).sum())
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    present = int((run_end > prev).sum())
    nbytes = (in_runs * c + cap + 3 * present * c + m * c + m) * 4
    k2b = dict(
        kernel="K2-bwd seg_max_carry_bwd", shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs, vertices_with_runs=present, tied_pairs_planted=ties,
        **timings(torch, lambda: seg_max_carry_bwd(vals, ids, run_end, maxed, g_max, g_carry),
                  lambda: seg_max_carry_bwd_plain(vals, ids, run_end, maxed, g_max, g_carry)),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(k2b)
    return k1, k2, k1b, k2b


def all_finite(torch, tensors):
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def train(torch, run, state, batch):
    """The main training path: ``TRAIN_STEPS`` steps of ``make_train_step``."""
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy

    model = run.model
    expected = launches_per_step(model, segvjp=False)
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


def train_card_vs_cpu(torch, dev, what="train step"):
    from lattice_net_tpu_torch.train.setup import TrainSetup

    small = dict(conv_dtype=torch.float32, seed=1)
    gpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, **small)
    cpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device="cpu", **small)
    batch_g, batch_c = (train_batch(torch, d, 6000, 1 << 13, seed=11) for d in (dev, "cpu"))
    loss_g, grads_g = loss_and_grads(torch, gpu.loss_fn(), gpu.model.state_dict(), batch_g)
    loss_c, grads_c = loss_and_grads(torch, cpu.loss_fn(), cpu.model.state_dict(), batch_c)
    worst, name = compare_grads(torch, grads_g, grads_c, TRAIN_CPU_GRAD_REL, f"{what}, card vs CPU")
    emit(dict(check=f"{what}, card vs CPU plain path, f32, 6000 points", loss=loss_g,
              loss_abs_diff=abs(loss_g - loss_c), worst_grad_rel_l2=worst, worst_param=name,
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_CPU_GRAD_REL)))  # fmt: skip
    check(abs(loss_g - loss_c) <= LOSS_ATOL, f"card vs CPU loss {loss_g} vs {loss_c}")


# ---------------------------------------------------------------------------
# the edge-sort head adjoint (K3, K4) and dropout
# ---------------------------------------------------------------------------


def check_k4(torch, args, where):
    """K4 against its plain version on one recorded call ``(values, idx)``,
    bit-equal, and timed there with its byte bound.  Library: one
    ``index_select`` on the clamped ids (the clamp made beforehand)."""
    from lattice_net_tpu_torch.ops_cuda.gather import take_rows, take_rows_plain

    values, idx = args
    (cap, c), m = values.shape, idx.shape[0]
    got = take_rows(values, idx)
    want = take_rows_plain(values, idx)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"K4 {where}: kernel != plain (max abs {err})")
    idc = idx.long().clamp(0, cap - 1)
    check(torch.equal(values.index_select(0, idc), got), f"K4 {where}: library")
    # bytes: each row some id references, read once; the ids; the output
    rows_read = int(torch.unique(idc).numel())
    nbytes = rows_read * c * values.element_size() + m * 4 + got.numel() * got.element_size()
    row = dict(
        kernel="K4 take_rows", where=where, shape=f"cap={cap} C={c} m={m}",
        dtype=str(values.dtype).removeprefix("torch."), rows_read=rows_read,
        **timings(torch, lambda: take_rows(values, idx), lambda: take_rows_plain(values, idx),
                  lambda: values.index_select(0, idc)),
        library="index_select of the clamped ids", bytes=nbytes,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def check_k3(torch, args, where):
    """K3 against its plain version (an ``index_add_``, atomics on the card)
    on one recorded call ``(vals, ids, run_end, cap)`` and the cases built
    from it (:func:`extra_cases`, ``NARROW_K3`` random columns), within
    ``BWD_TOL``; twice each, into NaN-filled blocks, bit-equal to itself;
    timed on the recorded call with its byte bound.  Library: one
    ``torch.segment_reduce(..., "sum", lengths=...)`` over the edges in runs
    with each vertex's run length (both made beforehand)."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_sum_sorted_fast, seg_sum_sorted_plain

    vals, ids, run_end, cap = args
    m, c = vals.shape
    dev = vals.device
    run_length_stats(torch, run_end, f"{where}, K3")

    def case(name, v, i, r):
        outs = []
        for _ in range(2):
            ptrs = nan_blocks(torch, [(cap, v.shape[1])], dev)
            outs.append(seg_sum_sorted_fast(v, i, r, cap))
            check(outs[-1].data_ptr() == ptrs[0], f"K3 {where} {name}: output off the NaN block")
        want = seg_sum_sorted_plain(v, i, cap)
        torch.cuda.synchronize()
        e, ok = close(torch, outs[0], want)
        check(ok, f"K3 {where} {name}: kernel != plain beyond {BWD_TOL} (max abs {e})")
        check(torch.equal(outs[0], outs[1]), f"K3 {where} {name}: two runs differ")
        emit(dict(check=f"K3 {where} {name}", shape=f"M={v.shape[0]} C={v.shape[1]}", max_abs_err=e))
        return e, want

    err, want = case("recorded", vals, ids, run_end)
    cols = random_columns(torch, NARROW_K3, c, 9, dev)
    narrow = (f"C={NARROW_K3} random columns", vals[:, cols].contiguous(), ids, run_end)
    for name, v, i, r in [*extra_cases(torch, vals, ids, run_end, seed=10), narrow]:
        err = max(err, case(name, v, i, r)[0])
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    lengths = (run_end - prev).long()
    in_runs = int(lengths.sum())
    head = vals[:in_runs].float()
    lib = lambda: torch.segment_reduce(head, "sum", lengths=lengths)  # noqa: E731
    check(close(torch, lib(), want)[1], f"K3 {where}: library call != plain")
    nbytes = (in_runs * c + cap + cap * c) * 4
    row = dict(
        kernel="K3 seg_sum", where=where, shape=f"M={m} C={c} cap={cap}", edges_in_runs=in_runs,
        vertices_with_runs=int((lengths > 0).sum()),
        **timings(torch, lambda: seg_sum_sorted_fast(vals, ids, run_end, cap),
                  lambda: seg_sum_sorted_plain(vals, ids, cap), lib),
        library="segment_reduce sum over the edges in runs",
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def segvjp_kernels_vs_plain(torch, run, state, batch):
    """K3 and K4 on exactly the inputs one segvjp train step gives them, with
    the default preclassified head and with ``LNT_HEAD_PRECLASSIFY=0``."""
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    rows = {}
    for pre in ("1", "0"):
        where = f"segvjp step, LNT_HEAD_PRECLASSIFY={pre}"
        with segvjp(pre), recording_kernel_inputs(torch) as (calls, _):
            leaves, loss, _ = forward_loss(run.loss_fn(), state.params, batch)
            gradients(loss, leaves)
        n = {k: len(v) for k, v in calls.items()}
        check(n["k3"] == n["k4"] == 1 and n["k1b"] == 0, f"{where}: kernel calls {n}")
        rows[pre] = check_k4(torch, calls["k4"][0], where), check_k3(torch, calls["k3"][0], where)
    return rows


def train_segvjp(torch, run, state, batch):
    """``TRAIN_STEPS`` segvjp steps from ``state``, each right after a step of
    the default head from its own copy of ``state``: both step medians from
    interleaved runs.  Returns the segvjp run's launch totals."""
    model = run.model
    heads = dict(default=(default_head, launches_per_step(model, segvjp=False)),
                 segvjp=(segvjp, launches_per_step(model, segvjp=True)))  # fmt: skip
    step = run.train_step()
    states = dict.fromkeys(heads, state)
    times = {k: [] for k in heads}
    losses = {k: [] for k in heads}
    totals = dict.fromkeys(heads["segvjp"][1], 0)
    for i in range(TRAIN_STEPS):
        for name, (env, expected) in heads.items():
            with env():
                zero_counts()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                states[name], metrics = step(states[name], batch)
                stop.record()
                stop.synchronize()
                counts = read_counts()
            times[name].append(start.elapsed_time(stop))
            losses[name].append(float(metrics["loss"]))
            emit(dict(head=name, step=i, step_ms=times[name][-1], loss=losses[name][-1],
                      launches=counts))  # fmt: skip
            check(counts == expected, f"{name} step {i}: launches {counts}, expected {expected}")
            check(math.isfinite(losses[name][-1]), f"{name} step {i}: loss {losses[name][-1]}")
            if name == "segvjp":
                for k in totals:
                    totals[k] += counts[k]
    check(all_finite(torch, states["segvjp"].params.values()), "segvjp: non-finite parameters")
    summary = {}
    for name in heads:
        steady = sorted(times[name][1:])
        first, last = sum(losses[name][:3]) / 3, sum(losses[name][-3:]) / 3
        summary[name] = dict(steady_median_ms=steady[len(steady) // 2], steady_min_ms=steady[0],
                             steady_max_ms=steady[-1], loss_first3=first, loss_last3=last)  # fmt: skip
        check(last < first, f"{name}: loss did not fall: first 3 steps {first}, last 3 {last}")
    emit(dict(training="segvjp vs default head, interleaved", steps=TRAIN_STEPS,
              expected_launches={k: v[1] for k, v in heads.items()}, **summary))  # fmt: skip
    return totals


def faulty_k3_grads(torch, loss_fn, params, batch, pick):
    """Gradients with the kernels, but with K3 summing the runs of the
    vertices ``pick(out, run_end)`` chooses into their next vertex's row."""
    from lattice_net_tpu_torch.lattice import ops

    k3 = ops.seg_sum_sorted_fast
    picked = []

    def faulty(vals, ids, run_end, cap, plain=False):
        out = k3(vals, ids, run_end, cap, plain=plain).clone()
        v = pick(out, run_end)
        out[v + 1] += out[v]
        out[v] = 0.0
        picked.append(int(v.numel()))
        return out

    ops.seg_sum_sorted_fast = faulty
    try:
        _, grads = loss_and_grads(torch, loss_fn, params, batch)
    finally:
        ops.seg_sum_sorted_fast = k3
    check(len(picked) == 1, f"the faulty K3 ran {len(picked)} times in one step")
    return grads, picked[0]


def segvjp_gradients(torch, run, state, batch, dev):
    """One segvjp step against the default head, against its plain versions
    and (f32) against the CPU; and two planted K3 faults."""
    loss_fn = run.loss_fn()
    with default_head():
        loss_d, grads_d = loss_and_grads(torch, loss_fn, state.params, batch)
    with segvjp():
        loss_s, grads_s = loss_and_grads(torch, loss_fn, state.params, batch)
        zero_counts()
        loss_p, grads_p = loss_and_grads(torch, loss_fn, state.params, batch, plain=True)
        check(not any(read_counts().values()), "the plain segvjp step launched kernels")

        def largest(out, run_end):
            return out.norm(dim=1)[:-1].argmax()[None]

        def one_percent(out, run_end):
            prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
            with_runs = torch.nonzero(run_end[:-1] > prev[:-1]).flatten()
            return with_runs[::100]

        faults = {name: faulty_k3_grads(torch, loss_fn, state.params, batch, pick)
                  for name, pick in (("one_vertex", largest), ("one_percent", one_percent))}  # fmt: skip
    fault_rel = {k: worst_rel_l2(torch, g, grads_s)[0] for k, (g, _) in faults.items()}
    vs_default, vs_default_name = worst_rel_l2(torch, grads_s, grads_d)
    vs_plain, vs_plain_name = worst_rel_l2(torch, grads_s, grads_p)
    emit(dict(check="segvjp train step, bf16 convs", loss=loss_s,
              loss_abs_diff_default=abs(loss_s - loss_d), loss_abs_diff_plain=abs(loss_s - loss_p),
              vs_default_rel_l2=vs_default, vs_default_param=vs_default_name,
              vs_plain_rel_l2=vs_plain, vs_plain_param=vs_plain_name,
              planted_k3_fault_rel_l2=fault_rel,
              planted_k3_fault_vertices={k: n for k, (_, n) in faults.items()},
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_PLAIN_GRAD_REL)))  # fmt: skip
    compare_grads(torch, grads_s, grads_d, TRAIN_PLAIN_GRAD_REL, "segvjp vs default head")
    compare_grads(torch, grads_s, grads_p, TRAIN_PLAIN_GRAD_REL, "segvjp kernels vs plain")
    check(abs(loss_s - loss_d) <= LOSS_ATOL, f"segvjp vs default loss {loss_s} vs {loss_d}")
    check(abs(loss_s - loss_p) <= LOSS_ATOL, f"segvjp kernels vs plain loss {loss_s} vs {loss_p}")
    for name, rel in fault_rel.items():
        check(
            rel > TRAIN_PLAIN_GRAD_REL,
            f"K3 summing runs into the next vertex ({name}) moved the gradients by only {rel}: "
            f"the tolerance {TRAIN_PLAIN_GRAD_REL} would pass it",
        )
    with segvjp():
        train_card_vs_cpu(torch, dev, "segvjp train step")


def dropout_step(torch, run, state, batch, dev):
    """One train step of the model with ``dropout_last_layer = DROPOUT`` (the
    same weights), its masks drawn from a Philox generator on the card."""
    import dataclasses

    from lattice_net_tpu_torch.models.lnn import LNN
    from lattice_net_tpu_torch.nn.modules import channel_keep_mask
    from lattice_net_tpu_torch.parallel.data_parallel import (
        forward_loss,
        make_loss_fn,
        make_train_step,
    )

    mp = dataclasses.replace(run.model.params, dropout_last_layer=DROPOUT)
    model = LNN(mp, torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(state.params)
    step = make_train_step(model, run.tx, run.sigma, mp.nr_downsamples, run.capacities)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    c = model.SliceFastModule_0.classify_kernel.shape[1]
    masks = [channel_keep_mask(c, DROPOUT, gen(s), dev) for s in (5, 5, 6)]
    check(torch.equal(masks[0], masks[1]), "one seed gave two keep masks")
    loss_fn = make_loss_fn(model, run.sigma, mp.nr_downsamples, run.capacities)
    with default_head():
        new, metrics = step(state, batch, gen(5))
        dropped = [forward_loss(loss_fn, state.params, batch, gen(5))[1].item() for _ in range(2)]
        plain_loss = forward_loss(run.loss_fn(), state.params, batch)[1].item()
    loss = float(metrics["loss"])
    emit(dict(check="train step with channel dropout", dropout=DROPOUT, channels=c,
              kept=int(masks[0].sum()), seeds_5_6_masks_differ=not torch.equal(masks[0], masks[2]),
              loss=loss, loss_without_dropout=plain_loss,
              same_seed_loss_diff=abs(dropped[0] - dropped[1])))  # fmt: skip
    check(math.isfinite(loss), f"dropout step: loss {loss}")
    check(all_finite(torch, new.params.values()), "dropout step: non-finite parameters")
    check(abs(dropped[0] - dropped[1]) <= LOSS_ATOL, f"one seed gave losses {dropped}")


class _Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.copy.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def trainer_probe(records):
    """Records the trainer's steps and epochs by wrapping ``StateCallback``'s
    hooks: every forward's loss and kernel launches (the counts are set to 0
    when an epoch starts and after each forward), and every epoch's loss,
    mIoU, samples, seconds and median step period (the wall time from one
    forward's loss read to the next, the first from the epoch's start)."""
    from lattice_net_tpu_torch.train.callbacks import StateCallback

    orig = {k: getattr(StateCallback, k) for k in ("epoch_started", "after_forward_pass", "epoch_ended")}
    t0, last, step_ms = [0.0], [0.0], []

    def epoch_started(self, phase=None, **kw):
        orig["epoch_started"](self, phase=phase, **kw)
        zero_counts()
        t0[0] = last[0] = time.perf_counter()
        step_ms.clear()

    def after_forward_pass(self, phase=None, loss=0.0, **kw):
        orig["after_forward_pass"](self, phase=phase, loss=loss, **kw)  # reads the loss: a sync
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        records["steps"].append(dict(phase=phase.name, loss=float(loss), launches=read_counts()))
        zero_counts()

    def epoch_ended(self, phase=None, **kw):
        n = phase.samples_processed_this_epoch
        seconds = time.perf_counter() - t0[0]
        records["epochs"].append(dict(
            phase=phase.name, epoch=phase.epoch_nr, loss=phase.loss_acum_per_epoch / max(n, 1),
            miou=phase.scores.avg_class_iou(), samples=n, seconds=seconds, samples_per_s=n / seconds,
            step_ms_median=statistics.median(step_ms) if step_ms else None,
        ))  # fmt: skip
        orig["epoch_ended"](self, phase=phase, **kw)

    StateCallback.epoch_started, StateCallback.after_forward_pass = epoch_started, after_forward_pass
    StateCallback.epoch_ended = epoch_ended
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(StateCallback, k, fn)


def jax_run_class_weights():
    lines = JAX_RUN_LOG.read_text().splitlines()
    line = lines[JAX_WEIGHTS_LINE - 1]
    check(line.startswith("class weights: "), f"{JAX_RUN_LOG.name}:{JAX_WEIGHTS_LINE} is {line[:60]!r}")
    return json.loads(line[len("class weights: "):])


def printed_class_weights(text):
    found = [json.loads(l[len("class weights: "):]) for l in text.splitlines()
             if l.startswith("class weights: ")]  # fmt: skip
    check(len(found) == 1, f"the trainer printed {len(found)} class-weight lines")
    return found[0]


def trainer_run(torch, config, records, **kw):
    """One ``ln_train.run`` on the card, its output kept; returns the final
    state and the printed text."""
    from lattice_net_tpu_torch.train.ln_train import run

    tee = _Tee(sys.stdout)
    with trainer_probe(records), contextlib.redirect_stdout(tee):
        state = run(config, **kw)
    torch.cuda.synchronize()
    return state, tee.copy.getvalue()


def states_equal(torch, a, b):
    """Bit equality of two train states: step, parameters, optimizer state."""
    def same(x, y):
        return x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y))

    if a.step != b.step or a.opt_state["count"] != b.opt_state["count"]:
        return False
    if set(a.opt_state) != set(b.opt_state):
        return False
    pairs = [(a.params, b.params)] + [(a.opt_state[k], b.opt_state[k]) for k in ("mu", "nu", "nu_max")]
    if "plateau" in a.opt_state:
        pairs.append((a.opt_state["plateau"], b.opt_state["plateau"]))
    return all(set(x) == set(y) and all(same(x[k], y[k]) for k in x) for x, y in pairs)


def trainer_cli(torch, dev):
    """Phase 14: the training CLI on the card, two epochs, then a resume."""
    import os

    from lattice_net_tpu_torch.train.checkpoint import load_checkpoint
    from lattice_net_tpu_torch.train.setup import TrainSetup

    steps_per_epoch = TRAINER_SCENES["train"]
    run = TrainSetup.from_config(SYNTH_CONFIG, NR_CLASSES, steps_per_epoch, device=dev)
    expected_step = launches_per_step(run.model, segvjp=False)
    expected_test = dict(k1=patch_gathers_per_scan(run.model), k1b=0, k2=1, k2b=0, k3=0, k4=0)
    plateau_tx = run.tx.plateau
    del run
    want_weights = jax_run_class_weights()
    totals = dict.fromkeys(counters(), 0)
    with tempfile.TemporaryDirectory() as tmp, environ(LNT_SCENE_CACHE=os.path.join(tmp, "scenes")):
        overrides = [
            f"loader_synth_kitti.nr_samples={TRAINER_SCENES['train']}",
            f"loader_synth_kitti.nr_samples_test={TRAINER_SCENES['test']}",
            f"train.checkpoint_path={tmp}/ckpt",
        ]
        first, second = dict(steps=[], epochs=[]), dict(steps=[], epochs=[])
        t0 = time.perf_counter()
        state1, text1 = trainer_run(torch, str(SYNTH_CONFIG), first, max_epochs=TRAINER_EPOCHS,
                                    eval_every=1, overrides=overrides)  # fmt: skip
        first_s = time.perf_counter() - t0
        got_weights = printed_class_weights(text1)
        check(len(got_weights) == len(want_weights), f"{len(got_weights)} class weights printed")
        diffs = [abs(a - b) for a, b in zip(got_weights, want_weights)]
        emit(dict(check="trainer class weights vs the JAX run's", printed=got_weights,
                  jax_run=want_weights, log=f"{JAX_RUN_LOG.relative_to(ROOT)}:{JAX_WEIGHTS_LINE}",
                  equal_to_3_decimals=sum(round(a, 3) == round(b, 3)
                                          for a, b in zip(got_weights, want_weights)),
                  max_abs_diff=max(diffs), tolerance=CLASS_WEIGHT_ATOL))  # fmt: skip
        check(max(diffs) <= CLASS_WEIGHT_ATOL,
              f"class weights {max(diffs)} from the JAX run's, over {CLASS_WEIGHT_ATOL}")  # fmt: skip
        ckpts = sorted(p.name for p in Path(tmp, "ckpt").glob("*.ckpt"))
        check("last.ckpt" in ckpts and any(n.startswith("model_e_") for n in ckpts),
              f"checkpoints after the first run: {ckpts}")  # fmt: skip
        loaded = load_checkpoint(Path(tmp, "ckpt", "last.ckpt"), state1)
        check(state1.step == TRAINER_EPOCHS * steps_per_epoch, f"first run ended at step {state1.step}")
        check(states_equal(torch, loaded, state1), "last.ckpt does not load bit-equal to the saved state")
        t0 = time.perf_counter()
        state2, text2 = trainer_run(torch, str(SYNTH_CONFIG), second, max_epochs=TRAINER_EPOCHS + 1,
                                    eval_every=1, overrides=overrides,
                                    resume=str(Path(tmp, "ckpt", "last.ckpt")))  # fmt: skip
        second_s = time.perf_counter() - t0
    resumed = f"at step {TRAINER_EPOCHS * steps_per_epoch} (epoch ~{TRAINER_EPOCHS})"
    check(resumed in text2, f"the second run did not resume {resumed}")
    check(state2.step == (TRAINER_EPOCHS + 1) * steps_per_epoch, f"resumed run ended at step {state2.step}")
    check(state2.opt_state["count"] == state2.step, f"AdamW count {state2.opt_state['count']}")
    # the saved plateau state carried through the resumed epoch's step losses
    plateau = dict(loaded.opt_state["plateau"])
    for rec in second["steps"]:
        if rec["phase"] == "train":
            loss = torch.tensor(rec["loss"], dtype=torch.float32, device=dev)
            plateau = plateau_tx.update(plateau, loss)
    carried = all(torch.equal(plateau[k], state2.opt_state["plateau"][k]) for k in plateau)
    emit(dict(check="plateau state across the resume",
              saved={k: v.item() for k, v in loaded.opt_state["plateau"].items()},
              final={k: v.item() for k, v in state2.opt_state["plateau"].items()},
              carried_from_saved=carried))  # fmt: skip
    check(carried, "the resumed run's plateau state does not follow from the saved one")
    for run_name, rec, seconds in (("first", first, first_s), ("resumed", second, second_s)):
        for e in rec["epochs"]:
            emit(dict(trainer_run=run_name, **e))
            where = f"{run_name} run, {e['phase']} epoch {e['epoch']}"
            check(math.isfinite(e["loss"]), f"{where}: loss {e['loss']}")
        for i, st in enumerate(rec["steps"]):
            check(math.isfinite(st["loss"]), f"{run_name} run, forward {i}: loss {st['loss']}")
            want = expected_step if st["phase"] == "train" else expected_test
            where = f"{run_name} run, {st['phase']} forward {i}"
            check(st["launches"] == want, f"{where}: launches {st['launches']}, expected {want}")
            for k in totals:
                totals[k] += st["launches"][k]
        emit(dict(trainer_run=run_name, seconds=seconds, forwards=len(rec["steps"])))
    emit(dict(trainer_launches=totals, per_train_step=expected_step, per_test_forward=expected_test))
    return totals


# ---------------------------------------------------------------------------
# SemanticKITTI evaluation and the sensor-rate stream
# ---------------------------------------------------------------------------


def captured(torch, fn, *args, **kw):
    """``fn(*args, **kw)`` with its printed output kept; returns the result
    and the text."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, tee.copy.getvalue()


def plain_labels(torch, predictor, positions, values):
    logp, _ = predictor.forward(positions, values, plain=True)
    return torch.argmax(logp, dim=-1)[: len(positions)].cpu().numpy()


def eval_run(torch, dev, kitti, ckpt, out, budget, k1_per_scan):
    """One ``ln_eval.run`` from ``ckpt`` writing into ``out``, with its
    checks; returns its row."""
    import numpy as np

    from lattice_net_tpu_torch.data.semantic_kitti import LEARNING_MAP_INV
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.misc.prepare_submission_semantickitti import prepare_submission
    from lattice_net_tpu_torch.train import ln_eval

    overrides = [f"loader_semantic_kitti.dataset_path={kitti}", f"eval.output_predictions_path={out}"]
    zero_counts()
    miou, text = captured(torch, ln_eval.run, str(CONFIG), str(ckpt), True, overrides, budget)
    counts = read_counts()
    line = [l for l in text.splitlines() if l.startswith("evaluated ")]
    check(len(line) == 1, f"ln_eval printed {len(line)} 'evaluated' lines")
    words = line[0].split()
    scans, chunks, points, seconds = int(words[1]), int(words[4]), int(words[7]), float(words[10])
    setup = ln_eval.setup_predictor(str(CONFIG), str(ckpt), overrides, budget, device=dev)
    bins = sorted(Path(kitti, "sequences", "11", "velodyne").glob("*.bin"))
    check(scans == len(bins) == KITTI_SCANS["test"], f"{scans} scans evaluated, {len(bins)} test scans")
    want_chunks = sum(-(-(b.stat().st_size // 16) // setup.n_points) for b in bins)
    check(chunks == want_chunks and points == setup.n_points, f"{chunks} chunks of {points} points")
    want = dict(k1=k1_per_scan * chunks, k1b=0, k2=chunks, k2b=0, k3=0, k4=0)
    check(counts == want, f"ln_eval at budget {points}: launches {counts}, expected {want}")
    lut = np.zeros(max(LEARNING_MAP_INV) + 1, np.uint32)
    for k, v in LEARNING_MAP_INV.items():
        lut[k] = v
    agree = total = 0
    for i, b in enumerate(bins):
        f = Path(out, "sequences", "11", "predictions", f"{b.stem}.label")
        check(f.exists(), f"no prediction file {f.relative_to(out)}")
        got, n_raw = np.fromfile(f, np.uint32), b.stat().st_size // 16  # xyzi float32 a point
        check(len(got) == n_raw, f"{f.name}: {len(got)} labels for {n_raw} points")
        off_map = set(np.unique(got).tolist()) - set(LEARNING_MAP_INV.values())
        check(not off_map, f"{f.name}: raw ids off the map {sorted(off_map)}")
        prepared = prepare_cloud(setup.loader.get_cloud(i), setup.predictor.params)
        plain = ln_eval.predict_cloud_chunked(
            lambda p, v: plain_labels(torch, setup.predictor, p, v), prepared, setup.n_points
        )
        agree += int((lut[plain] == got).sum())
        total += len(got)
    files = len(list(Path(out).rglob("*.label")))
    check(files == len(bins), f"{files} label files written for {len(bins)} scans")
    n_files, n_checked = prepare_submission(out, kitti, Path(out).with_suffix(".zip"))
    check(n_files == n_checked == len(bins), f"prepare_submission: {n_files} files, {n_checked} checked")
    row = dict(eval_budget=points, scans=scans, chunks=chunks, seconds=seconds,
               seconds_per_scan=seconds / scans, scans_per_s=scans / seconds, miou=miou, launches=counts,
               labels_vs_plain=agree / total, tolerance=SERVE_TOL["label_agreement"])  # fmt: skip
    emit(row)
    check(agree / total >= SERVE_TOL["label_agreement"], f"eval labels vs plain {agree / total}")
    return row


def stream_runs(torch, dev, k1_per_scan):
    """``ln_eval_stream`` for each wire, with its checks; returns the K1 and
    K2 launches."""
    import os

    import numpy as np

    from lattice_net_tpu_torch.train import ln_eval, ln_eval_stream

    overrides = [f"loader_synth_kitti.nr_samples={STREAM_SCENES}", "eval.checkpoint_path="]
    launches = dict(k1=0, k2=0)
    forwards = 1 + ln_eval_stream.COMPUTE_ITERS + STREAM_SCANS  # warm-up, timing, stream
    with environ(LNT_SCENE_CACHE=os.path.abspath("scenes")):
        setup = ln_eval.setup_predictor(str(STREAM_CONFIG), "", overrides, device=dev)
        want_labels = []
        for k in range(STREAM_SCANS):
            b = ln_eval_stream._prep_np(setup.loader.get_cloud(k % STREAM_SCENES), setup.predictor.params,
                                        setup.n_points)  # fmt: skip
            n = int(b["n_valid"])
            want_labels.append(setup.predictor.predict(b["positions"][:n], b["values"][:n]))
        del setup
        for wire in ("f32", "f16", "i16"):
            zero_counts()
            res, _ = captured(torch, ln_eval_stream.run, str(STREAM_CONFIG), "", STREAM_HZ, STREAM_SCANS,
                              overrides, wire=wire, device=dev)  # fmt: skip
            counts = read_counts()
            want = dict(k1=k1_per_scan * forwards, k1b=0, k2=forwards, k2b=0, k3=0, k4=0)
            check(counts == want, f"stream wire {wire}: launches {counts}, expected {want}")
            launches["k1"] += counts["k1"]
            launches["k2"] += counts["k2"]
            lat = res.latency_ms
            check(len(lat) == STREAM_SCANS and bool(np.isfinite(lat).all()),
                  f"stream wire {wire}: latencies {lat}")  # fmt: skip
            same = [float(np.mean(a == b)) for a, b in zip(res.labels, want_labels)]
            emit(dict(stream_wire=wire, scans=len(lat), rate_hz=STREAM_HZ, compute_only_ms=res.compute_ms,
                      h2d_ms=res.h2d_ms, mb_per_scan=res.bytes_per_scan / 1e6,
                      e2e_p50_ms=float(np.percentile(lat, 50)), e2e_p95_ms=float(np.percentile(lat, 95)),
                      e2e_max_ms=float(lat.max()), misses=res.misses,
                      sustained_scans_per_s=res.scans_per_s, labels_vs_predict_min=min(same),
                      labels_vs_predict_mean=float(np.mean(same)), launches=counts))  # fmt: skip
            if wire == "f32":
                check(min(same) == 1.0, f"f32 stream labels differ from Predictor.predict: {same}")
    return launches


def kitti_eval(torch, dev, k1_per_scan):
    """Phase 15: a KITTI-format directory, one epoch of the trainer on it,
    ``ln_eval`` from its checkpoint at two budgets, and the stream."""
    from lattice_net_tpu_torch.data.synth_kitti import write_kitti_dir
    from lattice_net_tpu_torch.train.setup import TrainSetup

    run = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_SCANS["train"], device=dev)
    expected_step = launches_per_step(run.model, segvjp=False)
    expected_test = dict(k1=k1_per_scan, k1b=0, k2=1, k2b=0, k3=0, k4=0)
    del run
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        kitti = write_kitti_dir(Path(tmp, "kitti"), KITTI_SCANS["train"], KITTI_SCANS["test"], KITTI_POINTS,
                                seed=0, classes=NR_CLASSES)  # fmt: skip
        emit(dict(kitti_dir=KITTI_SCANS, points=KITTI_POINTS, seconds=time.perf_counter() - t0))
        records = dict(steps=[], epochs=[])
        overrides = [f"loader_semantic_kitti.dataset_path={kitti}", f"train.checkpoint_path={tmp}/ckpt"]
        t0 = time.perf_counter()
        _, text = trainer_run(torch, str(TRAIN_CONFIG), records, max_epochs=1, overrides=overrides)
        readers = sorted({l for l in text.splitlines() if l.startswith("semantickitti reader:")})
        tb = [l for l in text.splitlines() if l.startswith("tensorboard:")]
        test = [e for e in records["epochs"] if e["phase"] == "test"]
        check(len(test) == 1, f"{len(test)} test epochs")
        for e in records["epochs"]:
            emit(dict(kitti_trainer=e["phase"], **e))
            check(math.isfinite(e["loss"]), f"KITTI trainer {e['phase']} loss {e['loss']}")
        for st in records["steps"]:
            want = expected_step if st["phase"] == "train" else expected_test
            check(st["launches"] == want,
                  f"KITTI trainer {st['phase']}: launches {st['launches']}, expected {want}")  # fmt: skip
        totals = {k: sum(st["launches"][k] for st in records["steps"]) for k in expected_step}
        emit(dict(kitti_trainer_seconds=time.perf_counter() - t0, readers=readers, tensorboard=tb,
                  forwards=len(records["steps"]), launches=totals))  # fmt: skip
        check(readers and all(r.startswith("semantickitti reader: native") for r in readers),
              f"the native reader did not run: {readers}")  # fmt: skip
        ckpt = Path(tmp, "ckpt", "last.ckpt")
        check(ckpt.exists(), "the trainer wrote no last.ckpt")
        whole = eval_run(torch, dev, kitti, ckpt, Path(tmp, "pred_whole"), 0, k1_per_scan)
        chunked = eval_run(torch, dev, kitti, ckpt, Path(tmp, "pred_chunked"), EVAL_CHUNK, k1_per_scan)
        check(whole["chunks"] == KITTI_SCANS["test"] and chunked["chunks"] == 2 * KITTI_SCANS["test"],
              f"chunks {whole['chunks']} and {chunked['chunks']}")  # fmt: skip
        gap = abs(whole["miou"] - test[0]["miou"])
        ablation = [l for l in CHUNK_ABLATION_LOG.read_text().splitlines() if l.startswith("RESULT")]
        emit(dict(check="eval mIoU vs the trainer's test phase", eval_miou=whole["miou"],
                  trainer_test_miou=test[0]["miou"], abs_diff=gap, tolerance=EVAL_MIOU_ATOL,
                  chunk_ablation_card=dict(whole=whole["miou"], two_chunks=chunked["miou"],
                                           gap=chunked["miou"] - whole["miou"]),
                  chunk_ablation_cpu_log=ablation))  # fmt: skip
        check(gap <= EVAL_MIOU_ATOL, f"eval mIoU {whole['miou']} vs the trainer's {test[0]['miou']}")
        eval_launches = {k: whole["launches"][k] + chunked["launches"][k] for k in ("k1", "k2")}
        stream = stream_runs(torch, dev, k1_per_scan)
    return dict(eval=eval_launches, stream=stream, trainer=totals)


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

    with default_head():  # phases 2-9: the default head, whatever the caller's environment
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
    k34 = segvjp_kernels_vs_plain(torch, run, state, batch)  # phase 10
    seg_trained = train_segvjp(torch, run, state, batch)  # phase 11
    seg_per_step = launches_per_step(run.model, segvjp=True)
    segvjp_gradients(torch, run, state, batch, dev)  # phase 12
    dropout_step(torch, run, state, batch, dev)  # phase 13
    del run, state, batch
    with default_head():
        trainer = trainer_cli(torch, dev)  # phase 14
        kitti = kitti_eval(torch, dev, k1_per_scan)  # phase 15

    def both(key):
        ev, st, kt = kitti["eval"].get(key, 0), kitti["stream"].get(key, 0), kitti["trainer"][key]
        return dict(launches=launches.get(key, 0) + trained[key] + trainer[key] + kt + ev + st,
                    launches_serving=launches.get(key, 0), launches_training=trained[key],
                    launches_trainer_cli=trainer[key] + kt, launches_eval=ev, launches_stream=st)  # fmt: skip

    def per_train_step(t):
        return {f"{k}_per_step": t[k] for k in TIMES}

    def own(t):
        return {k: t[k] for k in TIMES}

    rows = [
        dict(
            name="patch_gather", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_gather.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:133", **both("k1"),
            launches_per_scan=k1_per_scan, launches_per_step=per_step["k1"],
            max_abs_err=max(k1["max_abs_err"], k1_step["max_abs_err"]), **own(k1),
            bound_by="bytes", **per_train_step(k1_step),
            timed_as=f"ms: sum over the {k1_per_scan} gathers of one served scan; ms_per_step: "
            f"sum over the {k1_step['calls']} gathers of one train step; each on its own inputs",
        ),
        dict(
            name="seg_max_carry", route="cuda", source="lattice_net_tpu_torch/csrc/seg_max.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:413", **both("k2"),
            launches_per_scan=1, launches_per_step=per_step["k2"],
            max_abs_err=max(k2["max_abs_err"], k2_step["max_abs_err"]), **own(k2),
            bound_by="bytes", **per_train_step(k2_step),
            max_only_segment_reduce_ms=k2["max_only_segment_reduce_ms"],
            max_only_segment_reduce_ms_per_step=k2_step["max_only_segment_reduce_ms"],
            timed_as="ms: the max-pool of one served scan; ms_per_step: that of one train step; "
            "max_only_segment_reduce: a reference without the carry, not the library call",
        ),
        dict(
            name="patch_scatter", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_scatter.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:252", **both("k1b"),
            launches_per_step=per_step["k1b"], max_abs_err=k1b["max_abs_err"], **own(k1b),
            bound_by="bytes", dest_repeat_share_32=k1b["dest_repeat_share_32"],
            device_ms_uniform_ids=k1b["device_ms_uniform_ids"],
            two_runs_max_abs_gap=k1b["two_runs_max_abs_gap"],
            timed_as="the head gather's adjoint in one train step",
        ),
        dict(
            name="seg_max_carry_bwd", route="cuda",
            source="lattice_net_tpu_torch/csrc/seg_max_bwd.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:488", **both("k2b"),
            launches_per_step=per_step["k2b"], max_abs_err=k2b["max_abs_err"], **own(k2b),
            bound_by="bytes", timed_as="the max-pool's adjoint in one train step",
        ),
    ]  # fmt: skip
    for key, name, src, site, pick in (
        ("k3", "seg_sum", "seg_sum.cu", "segment.py:142", 1),
        ("k4", "take_rows", "take_rows.cu", "gather.py:52", 0),
    ):
        main_row, wide_row = k34["1"][pick], k34["0"][pick]
        rows.append(dict(
            name=name, route="cuda", source=f"lattice_net_tpu_torch/csrc/{src}",
            replaces=f"lattice_net_tpu/ops_tpu/{site}",
            launches=seg_trained[key] + trainer[key] + kitti["trainer"][key],
            launches_training_segvjp=seg_trained[key],
            launches_trainer_cli=trainer[key] + kitti["trainer"][key],
            launches_per_step=seg_per_step[key],
            max_abs_err=max(main_row["max_abs_err"], wide_row["max_abs_err"]),
            **own(main_row), bound_by="bytes", library=main_row["library"],
            **{f"{k}_preclassify0": v for k, v in own(wide_row).items()},
            timed_as=f"ms: the call of one LNT_HEAD_SEGVJP=1 train step ({main_row['shape']}); "
            f"*_preclassify0: that call with LNT_HEAD_PRECLASSIFY=0 ({wide_row['shape']})",
        ))  # fmt: skip
    print(card)
    emit({"kernels": rows})
    name = torch.cuda.get_device_name(0)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
