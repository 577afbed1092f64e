"""The cell on the 6-D lattice (``scannet_xyzrgb_eval_5m``) on the CPU at a
tiny size, and the reader of its sort and scan metric on a hand-made trace."""

import pytest

from port_bench import run, trace

ROOMS = {"scene_points": 2048, "points": 2048, "budget": 2048, "variants": 4, "check_from": 2, "trace_items": 2,
         "warmup": 1}  # fmt: skip


def _xyzrgb(f32=False):
    config = {"lattice_serve": {"hash_table_capacity": 16384}}
    return {"config": dict(config, conv_dtype="float32") if f32 else config, "traffic": ROOMS}


def _metrics(cell, trace_on):
    return {m["name"] for m in run.metrics_for(run.spec(), cell, trace_on)}


@pytest.mark.parametrize("trace_on", [False, True])
def test_xyzrgb_cell_runs_and_is_correct(trace_on):
    out = run.run_cell("scannet_xyzrgb_eval_5m", 2**31 + 606, 1.0, trace_on, "cpu", _xyzrgb())
    assert out["correct"], out["compared"]
    got = set(out["metrics"])
    if trace_on:  # the device's metrics read nothing off the card
        assert got == {"eval.build_ms", "eval.model_ms", "host.aten_ops.rooms"}
        assert "eval.sort_device_ms" in _metrics("scannet_xyzrgb_eval_5m", True)
    else:
        assert got == _metrics("scannet_xyzrgb_eval_5m", False) == {"rooms_per_s", "peak_mem_gib", "setup_s"}


def test_xyzrgb_cell_equals_the_reference_in_f32():
    out = run.run_cell("scannet_xyzrgb_eval_5m", 2**33 + 6, 1.0, False, "cpu", _xyzrgb(f32=True))
    numbers = {k: v["value"] for k, v in out["compared"].items() if k != "clouds_compared"}
    assert numbers == dict.fromkeys(numbers, 0.0)


def _reading(events, items):
    ev = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)  # noqa: E731
    data = {"traceEvents": [ev("user_annotation", trace.ITEM, 0, 1000)] + [ev("kernel", *e) for e in events]}
    return {"layer": {"trace": trace.read(data)}, "traffic": {"trace_items": items}, "e2e": {}}


def test_sort_reader_reads_its_kernels():
    events = [
        ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<Policy, false, long>", 0, 100),
        ("void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<Policy, false, long>", 100, 20),
        ("void at::native::tensor_kernel_scan_innermost_dim_with_indices<long, Max>", 120, 30),
        ("void at_cuda_detail::cub::DeviceScanKernel<Policy, long*, long*>", 150, 6),
        ("void at::native::(anonymous namespace)::searchsorted_cuda_kernel<long, long>(long*, long const*)", 156, 4),
        ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long)", 160, 40),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 200, 400),
        ("ncclDevKernel_Broadcast_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 600, 50),
        ("gather_rows16_uint4", 650, 300),
    ]
    reading = _reading(events, items=2)
    assert run.reader("eval.sort_device_ms").read(reading) == (100 + 20 + 30 + 6 + 4) / 1e3 / 2
    off = {"layer": {"trace": None}, "traffic": {"trace_items": 2}, "e2e": {}}
    assert run.reader("eval.sort_device_ms").read(off) is None
