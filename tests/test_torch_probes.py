"""The port's measuring tools on the CPU (``misc/prim_cost_chip``,
``op_census``, ``parse_trace``, ``cache_key_probe``, ``profile_build
--only-lookup``), at 2^12 points or fewer.

* Each cost-model row's formulation equals the JAX tool's row
  (``lattice_net_tpu/misc/prim_cost_chip.py:105-167``) on the same numpy
  inputs: exactly, but the scatter-add (1e-5).
* The census counts a kernel once a wrapper call, its counts equal the
  wrappers' ``.launches`` deltas where the CPU branch counts a launch, its
  classes sum to its total, and its host syncs are the build's
  ``_read_count`` calls.
* ``parse_trace`` sums a written trace per name and per stream exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.misc import (
    cache_key_probe,
    op_census,
    parse_trace,
    prim_cost_chip,
    profile_build,
    profile_forward,
)
from lattice_net_tpu_torch.ops_cuda import _build
from lattice_net_tpu_torch.ops_cuda import gather as k_gather
from lattice_net_tpu_torch.ops_cuda import norm as k_norm
from lattice_net_tpu_torch.ops_cuda import patch as k_patch
from lattice_net_tpu_torch.ops_cuda import segment as k_segment

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
M, CAP = 1 << 12, 1 << 10


def _jax_rows(a):
    """The JAX tool's rows (its ``bench`` lambdas) on the numpy inputs
    ``a``, each in the layout of the port row's outputs."""
    A = jnp.arange(M, dtype=jnp.int32)
    perm, rand_ids, mono_ids = (jnp.asarray(a[k]) for k in ("perm", "rand_ids", "mono_ids"))
    key1, key2 = jnp.asarray(a["key1"]), jnp.asarray(a["key2"])
    x_m, x_m32, tab32 = jnp.asarray(a["x_m"]), jnp.asarray(a["x_m32"]), jnp.asarray(a["tab32"])

    def sort2():
        k1, k2, payload = jax.lax.sort((key1, key2, A), num_keys=2)
        return jnp.stack([k1, k2], 1), payload

    sorted_gather = jax.lax.gather(
        tab32, mono_ids[:, None], jax.lax.GatherDimensionNumbers((1,), (0,), (0,)), (1, 32),
        indices_are_sorted=True, mode=jax.lax.GatherScatterMode.CLIP,
    )  # fmt: skip
    return {
        "noop (x ^ 1)": lambda: (key1 ^ 1,),
        "sort 2^19 x 2ops (key+payload)": lambda: jax.lax.sort((key1, A), num_keys=1),
        "sort 2^19 x 3ops": sort2,
        "take (M,) f32 by perm": lambda: (jnp.take(x_m, perm),),
        "row gather (CAP,32) by (M,) rand ids": lambda: (jnp.take(tab32, rand_ids, axis=0),),
        "row gather (CAP,32) by (M,) sorted ids+flag": lambda: (sorted_gather,),
        "scatter-set (M,) by perm (inverse perm)": lambda: (jnp.zeros((M,), jnp.int32).at[perm].set(A, mode="drop"),),
        "inverse perm via 2-op sort": lambda: (jax.lax.sort((perm, A), num_keys=1)[1],),
        "scatter-max (CAP+1,) from M sorted ids": lambda: (
            jnp.full((CAP + 1,), -1, jnp.int32).at[mono_ids].max(A, mode="drop"),),
        "scatter-add (CAP,32) from (M,32) rand ids": lambda: (
            jnp.zeros((CAP, 32), jnp.float32).at[rand_ids].add(x_m32, mode="drop"),),
        "cummax (M,) i32": lambda: (jax.lax.cummax(key1, axis=0),),
        "cumsum (M,) i32": lambda: (jnp.cumsum(key1 & 1),),
        None: lambda: (jnp.cumsum(x_m),),  # _cumsum_f32: XLA's CPU order of jnp.cumsum
        "searchsorted CAP queries in (M,) sorted": lambda: (jnp.searchsorted(mono_ids, jnp.arange(CAP, dtype=jnp.int32)),),
        "segment_max (M,32)->CAP sorted ids (XLA)": lambda: (
            jax.ops.segment_max(x_m32, mono_ids, num_segments=CAP, indices_are_sorted=True),),
    }  # fmt: skip


@pytest.fixture(scope="module")
def prim_outputs():
    a = prim_cost_chip.numpy_inputs(M, CAP)
    jax_rows = _jax_rows(a)
    want = {row.name: [np.asarray(x) for x in jax_rows[row.jax_row]()] for row in prim_cost_chip.ROWS}
    return prim_cost_chip.outputs("cpu", M, CAP), want


@pytest.mark.parametrize("row", prim_cost_chip.ROWS, ids=[r.name for r in prim_cost_chip.ROWS])
def test_prim_cost_row_matches_the_jax_row(prim_outputs, row):
    got, want = prim_outputs[0][row.name], prim_outputs[1][row.name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if row.exact:
            np.testing.assert_array_equal(g.numpy().astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def test_prim_cost_run_prints_every_row(capsys):
    rows = prim_cost_chip.run(iters=1, repeats=1, m=1 << 10, cap=1 << 8, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows and rows[0]["device"] == "cpu"
    assert [r["name"] for r in rows[1:]] == [r.name for r in prim_cost_chip.ROWS]
    assert all(r["marginal_ms"] == (r["t3_ms"] - r["t1_ms"]) / 2 for r in rows[1:])


# the wrappers' CPU branches and the wrapper whose counter a launch raises
_PLAIN = (
    (k_patch, "patch_gather_plain", k_patch.patch_gather),
    (k_patch, "patch_scatter_plain", k_patch.patch_scatter),
    (k_segment, "seg_max_carry_plain", k_segment.seg_max_carry),
    (k_segment, "seg_max_carry_bwd_plain", k_segment.seg_max_carry_bwd),
    (k_segment, "seg_sum_sorted_plain", k_segment.seg_sum_sorted_fast),
    (k_gather, "take_rows_plain", k_gather.take_rows),
    (k_norm, "group_norm_act_plain", k_norm.group_norm_act),
)


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_census_kernels_equal_launch_deltas(monkeypatch, train):
    # the CPU branches count a launch, as the kernels do on the card
    for mod, name, wrapper in _PLAIN:
        def counted(*args, _fn=getattr(mod, name), _w=wrapper):
            _w.launches += 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    fn, _ = op_census.programs(1024, train, torch.bfloat16, "cpu", capacities=(4096, 2048, 1024))
    out = op_census.census(fn)
    kernels = {cls.split(":", 1)[1]: row["count"] for cls, row in out["classes"].items() if cls.startswith("kernel:")}
    assert kernels == {k: v for k, v in out["launches"].items() if v}
    want = dict(patch_gather=43, patch_scatter=1, seg_max_carry=1, seg_max_carry_bwd=1) if train else dict(
        patch_gather=15, seg_max_carry=1, group_norm_act=16)  # fmt: skip
    assert kernels == want
    assert out["total"] == sum(r["count"] for r in out["classes"].values()) > 0
    assert set(out["classes"]) <= set(op_census.CLASSES) | {f"kernel:{k}" for k in kernels}


@pytest.mark.parametrize("canonical", [False, True], ids=["default", "canonical"])
def test_census_host_syncs_are_the_builds_reads(monkeypatch, canonical):
    reads = []
    read = st._read_count
    monkeypatch.setattr(st, "_read_count", lambda t: reads.append(1) or read(t))
    pos = torch.from_numpy((np.random.default_rng(0).normal(size=(1024, 3)) * 10).astype(np.float32))
    if canonical:
        pos = pos[st.canonical_point_order(pos, 0.6)]

    def build():
        st.build_hierarchy(pos, 0.6, 2, (4096, 2048, 1024), canonical_points=canonical)

    syncs = op_census.census(build)["classes"].get("host_sync", {}).get("count", 0)
    n_reads = len(reads)
    with st.static_general_branches():
        general = op_census.census(build)["classes"].get("host_sync", {}).get("count", 0)
    assert len(reads) == n_reads >= 1
    assert syncs - general == n_reads


def test_census_run_prints_its_table(capsys):
    out = op_census.run(per_op=True, n_points=512, device="cpu", capacities=(2048, 1024, 512))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == out["setup"] and lines[0]["conv_dtype"] == "torch.bfloat16"
    assert lines[-1]["total"] == out["total"] == sum(x["count"] for x in lines[1:-2])
    assert {x["class"] for x in lines[1:-2]} == set(out["classes"]) and all("ops" in x for x in lines[1:-2])
    assert lines[-2]["functions"] == out["functions"] and sum(out["functions"].values()) == out["total"]
    assert out["functions"]["lattice/ops.py:_cumsum_f32"] > 0 and "(outside the port)" not in out["functions"]


def _kernel(name, tid, ts, dur):
    return dict(ph="X", cat="kernel", name=name, pid=0, tid=tid, ts=ts, dur=dur)


def test_parse_trace_sums_per_name_and_stream(tmp_path, capsys):
    events = [
        dict(ph="M", name="process_name", pid=0, args=dict(name="GPU 0")),
        dict(ph="M", name="thread_name", pid=0, tid=7, args=dict(name="stream 7")),
        dict(ph="M", name="thread_name", pid=0, tid=13, args=dict(name="stream 13")),
        _kernel("k_a", 7, 0, 1.5), _kernel("k_a", 7, 10, 2.25), _kernel("k_b", 7, 20, 4.0),
        _kernel("k_a", 13, 0, 8.0), dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", pid=0, tid=13, ts=30, dur=0.5),
        dict(ph="X", cat="cpu_op", name="aten::add", pid=1, tid=1, ts=0, dur=100.0),
    ]  # fmt: skip
    (tmp_path / "old.json").write_text(json.dumps(dict(traceEvents=[_kernel("old", 7, 0, 1.0)])))
    os.utime(tmp_path / "old.json", (0, 0))
    (tmp_path / "t.pt.trace.json").write_text(json.dumps(dict(traceEvents=events)))
    out = parse_trace.run(tmp_path)
    assert out["trace"].endswith("t.pt.trace.json")
    lines = {ln["line"]: ln for ln in out["lines"]}
    assert set(lines) == {"GPU 0 / stream 7", "GPU 0 / stream 13"}
    s7, s13 = lines["GPU 0 / stream 7"], lines["GPU 0 / stream 13"]
    assert s7["events"] == 3 and s7["total_ms"] == 7.75e-3 and s13["total_ms"] == 8.5e-3
    assert {(t["name"], t["calls"], t["ms"]) for t in s7["top"]} == {("k_a", 2, 3.75e-3), ("k_b", 1, 4e-3)}
    assert s7["top"][0]["name"] == "k_b" and s7["top"][0]["share"] == 4.0 / 7.75
    assert out["device_total_ms"] == 7.75e-3 + 8.5e-3
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed[-1] == dict(device_total_ms=out["device_total_ms"], lines=2)
    only = parse_trace.summarize(tmp_path / "t.pt.trace.json", top=1, line_filter="stream 13")
    assert [ln["line"] for ln in only["lines"]] == ["GPU 0 / stream 13"] and only["device_total_ms"] == 8.5e-3
    assert len(only["lines"][0]["top"]) == 1


def test_cpu_trace_has_no_device_time(tmp_path):
    rows = profile_forward.run(n_points=256, cap=1024, iters=1, device="cpu", trace=tmp_path, trace_only=True)
    assert len(rows) == 2 and rows[1]["trace"] == str(tmp_path / profile_forward.TRACE_NAME)
    assert rows[1]["device_ms"] is None
    out = parse_trace.summarize(tmp_path)
    assert out["lines"] == [] and out["device_total_ms"] == 0


def test_cache_keys_are_the_targets_and_stable_across_processes():
    out = cache_key_probe.run(children=2, device="cpu")
    names = [_build._target(n).name for n in _build.SOURCES]
    assert [k["target"] for k in out["keys"]] == names
    assert all(k["nvcc"] == _build.toolkit_version() for k in out["keys"])
    assert out["keys_agree"] and [c["pythonhashseed"] for c in out["children"]] == ["0", "1"]
    assert [[k["target"] for k in c["keys"]] for c in out["children"]] == [names, names]


def test_build_key_includes_the_toolkit(monkeypatch):
    before = _build._target("take_rows")
    monkeypatch.setattr(_build, "_toolkit", ["Cuda compilation tools, release 12.8"])
    assert _build._target("take_rows") != before
    assert _build.key_parts("take_rows")["nvcc"] == "Cuda compilation tools, release 12.8"


def test_profile_build_only_lookup():
    rows = profile_build.run(n_points=512, cap=2048, iters=1, device="cpu", only_lookup=True)
    stages = [r["stage"] for r in rows[1:]]
    assert len(stages) == 2 and stages[0].startswith("same-level lookup") and stages[1].startswith("coarsen lookup")
