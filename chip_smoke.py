#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lattice_net_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no ``"ok"`` line):

1. environment: the card's name and power limit, torch and CUDA versions,
   and the time to build ``csrc/*.cu`` (one nvcc per source, in parallel);
2. every hand-written kernel against its plain PyTorch version on the card,
   on exactly the inputs of each of its calls in one served scan (recorded
   during that forward; K2 also with ties planted): bit equality required;
   kernel, plain and library times by CUDA events;
3. serving: ``Predictor.from_config`` on the SemanticKITTI eval config at
   full width (seeded random weights) answers five 2^17-point scans and one
   of 100000 points padded with a point mask; per request the latency, the
   per-level occupancy and the kernel launch counts, which must equal the
   model's 15 patch gathers and 1 max-pool;
4. the same scan with the kernels and with their plain versions (bf16 convs
   both): labels agree on >= 99.9% of points, log-probabilities to 1e-3;
5. a small scan in f32 on the card against the plain path on the CPU (the
   path the CPU tests hold against the JAX package): log-probabilities to
   1e-3, labels on >= 99%.

The next-to-last lines are the card (``nvidia-smi`` name, power limit) and
one JSON object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
NR_CLASSES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SERVE_TOL = dict(logp_max_abs=1e-3, label_agreement=0.999)
CPU_TOL = dict(logp_max_abs=1e-3, label_agreement=0.99)


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
    _build.build_all(["patch_gather", "seg_max"])
    print(f"built csrc/patch_gather.cu and csrc/seg_max.cu in {time.perf_counter() - t0:.2f} s")
    return card


def scan(pred, n_points, seed):
    """(positions, values) of one synthetic LiDAR scan, per the config's modes."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud

    positions, values, _ = prepare_cloud(make_scene(n_points, seed=seed), pred.params)
    return positions, values


def record_kernel_inputs(torch, pred, pos, vals):
    """The inputs of every kernel call of one served forward, in call order:
    ``{"k1": [(values, table, include_center), ...], "k2": [(vals, carry,
    ids, run_end)]}``, copied as the forward passed them."""
    from lattice_net_tpu_torch.lattice import ops

    calls = dict(k1=[], k2=[])
    k1, k2 = ops.patch_gather, ops.seg_max_carry

    def recording_k1(values, neighbors, include_center):
        calls["k1"].append((values.clone(), neighbors.clone(), include_center))
        return k1(values, neighbors, include_center)

    def recording_k2(*args):
        calls["k2"].append(tuple(t.clone() for t in args))
        return k2(*args)

    ops.patch_gather, ops.seg_max_carry = recording_k1, recording_k2
    try:
        pred.forward(pos, vals)
    finally:
        ops.patch_gather, ops.seg_max_carry = k1, k2
    return calls


def kernels_vs_plain(torch, pred, dev):
    """Each kernel against its plain version, and timed, on exactly the
    inputs one served 2^17-point scan (seed 0) gives it."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_gather_plain
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    pos, vals = scan(pred, 1 << 17, seed=0)
    calls = record_kernel_inputs(torch, pred, pos, vals)
    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    k1["per_scan"] = len(calls["k1"])
    for v, table, center in calls["k1"]:
        (cap, c), (q, k) = v.shape, table.shape
        label = f"cap={cap} C={c} Q={q} K={k}{'+centre' if center else ''}"
        got = patch_gather(v, table, center)
        want = patch_gather_plain(v, table, center)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"K1 {label}: kernel != plain (max abs {err})")
        # yardstick: one index_select on the table with a zero row appended
        ids = torch.where((table >= 0) & (table < cap), table, cap)
        if center:
            ids = torch.cat([ids, torch.arange(q, device=dev, dtype=ids.dtype)[:, None]], 1)
        ids = ids.reshape(-1).long()
        vz = torch.cat([v, v.new_zeros(1, c)])
        check(torch.equal(vz.index_select(0, ids).reshape(got.shape), got), f"K1 {label}: library")
        # bytes this call needs: each value row that some id (or the centre
        # column) references, read once; the id table; the patch, written once
        rows_read = int(torch.unique(ids[ids < cap]).numel())
        nbytes = rows_read * c * v.element_size() + table.numel() * 4
        nbytes += got.numel() * got.element_size()
        row = dict(
            kernel="K1 patch_gather", shape=label, dtype=str(v.dtype).removeprefix("torch."),
            rows_read=rows_read,
            ms=time_ms(torch, lambda: patch_gather(v, table, center)),
            plain_ms=time_ms(torch, lambda: patch_gather_plain(v, table, center)),
            library_ms=time_ms(torch, lambda: vz.index_select(0, ids)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
        )  # fmt: skip
        emit(row)
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            k1[key] += row[key]
        k1["max_abs_err"] = max(k1["max_abs_err"], err)

    # K2 on the PointNet max-pool's inputs, then once more with ties planted:
    # the same values rounded to quarters repeat within runs
    check(len(calls["k2"]) == 1, f"{len(calls['k2'])} max-pools in one forward, expected 1")
    feats, carry, ids, run_end = calls["k2"][0]
    err = 0.0
    for v in (feats, torch.round(feats * 4) / 4):
        got = seg_max_carry(v, carry, ids, run_end)
        want = seg_max_carry_plain(v, carry, ids, run_end)
        torch.cuda.synchronize()
        err = max([err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"K2: kernel != plain ({err})")
    # bytes: the rows of edges that lie in some vertex's run, their carry,
    # the run ends, and the two outputs
    (m, c), cap = feats.shape, run_end.shape[0]
    in_runs = int((ids < cap).sum())
    nbytes = (in_runs * (c + 1) + run_end.numel() + 2 * got[0].numel()) * 4
    k2 = dict(
        kernel="K2 seg_max_carry", shape=f"M={m} C={c} cap={cap}", edges_in_runs=in_runs,
        ms=time_ms(torch, lambda: seg_max_carry(feats, carry, ids, run_end)),
        plain_ms=time_ms(torch, lambda: seg_max_carry_plain(feats, carry, ids, run_end)),
        library_ms=None, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err,
    )  # fmt: skip
    emit(k2)
    return k1, k2


def patch_gathers_per_scan(model):
    """K1 launches one forward must make: one per lattice conv module, plus
    the head's per-point gather."""
    from lattice_net_tpu_torch.nn.modules import ConvIm2Row, _CrossLevelConv

    convs = sum(isinstance(m, (ConvIm2Row, _CrossLevelConv)) for m in model.modules())
    return convs + 1


def serve(torch, pred, k1_per_scan):
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry

    requests = [(1 << 17, s) for s in range(5)] + [(100000, 5)]
    totals = dict(k1=0, k2=0)
    latencies = []
    for i, (n, seed) in enumerate(requests):
        pos, vals = scan(pred, n, seed)
        patch_gather.launches = 0
        seg_max_carry.launches = 0
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
        k1, k2 = patch_gather.launches, seg_max_carry.launches
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
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry

    pos, vals = scan(pred, 1 << 17, seed=0)
    logp_k, _ = pred.forward(pos, vals)
    patch_gather.launches = 0
    seg_max_carry.launches = 0
    logp_p, _ = pred.forward(pos, vals, plain=True)
    check(patch_gather.launches == 0 and seg_max_carry.launches == 0, "plain run launched kernels")
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
    k1_per_scan = k1["per_scan"]
    check(
        k1_per_scan == patch_gathers_per_scan(pred.model),
        f"one forward made {k1_per_scan} patch gathers, the model has "
        f"{patch_gathers_per_scan(pred.model)} convs and a head",
    )
    launches = serve(torch, pred, k1_per_scan)
    kernels_vs_plain_end_to_end(torch, pred)
    card_vs_cpu(torch, dev)

    rows = [
        dict(
            name="patch_gather", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_gather.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:133", launches=launches["k1"],
            launches_per_scan=k1["per_scan"], max_abs_err=k1["max_abs_err"], ms=k1["ms"],
            plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"], bound_by="bytes",
            library_ms=k1["library_ms"],
            timed_as=f"sum over the {k1_per_scan} gathers of one scan, each on its own inputs",
        ),
        dict(
            name="seg_max_carry", route="cuda", source="lattice_net_tpu_torch/csrc/seg_max.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:413", launches=launches["k2"],
            launches_per_scan=1, max_abs_err=k2["max_abs_err"], ms=k2["ms"],
            plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"], bound_by="bytes",
            library_ms=None, timed_as="one max-pool of one scan",
        ),
    ]  # fmt: skip
    print(card)
    emit({"kernels": rows})
    name = torch.cuda.get_device_name(0)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
