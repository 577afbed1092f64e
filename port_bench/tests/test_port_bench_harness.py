"""The harness on the CPU at tiny sizes: the result line, the imports, the
yardstick's counts and the discovery of new files."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import run, trace, yardstick
from port_bench.tests.conftest import TINY, tiny

ROOT = Path(__file__).resolve().parents[2]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_result_line_has_its_keys_in_order(cell):
    bench = run.spec(ROOT)
    out = run.run_cell(cell, 2**31 + 12345, 1.0, False, "cpu", tiny(cell), bench=bench)
    line = json.loads(json.dumps(out))
    assert list(line) == RESULT_KEYS
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    expected = {m["name"] for m in run.metrics_for(bench, cell, False)}
    assert set(line["metrics"]) == expected
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["compared"].values())


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)  # fmt: skip
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_the_harness_or_the_reference():
    code = ("from port_bench import run, calibrate\n"
            "from port_bench.tests.conftest import tiny\n"
            "run.run_cell('kitti_serve_10hz', 7, 0.5, False, 'cpu', tiny('kitti_serve_10hz'))")  # fmt: skip
    tops = {m.split(".", 1)[0] for m in _modules_after(code)}
    assert not tops & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import torch\nfrom port_bench.reference import api, lnn\n"
        "model = dict(pointnet_channels_per_layer=[16, 32], nr_downsamples=2, nr_blocks_down_stage=[1, 1],"
        " nr_blocks_bottleneck=1, nr_blocks_up_stage=[1, 1])\n"
        "mp = lnn.ModelParams(nr_classes=20, **{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})\n"
        "weights = lnn.LNN(mp, torch.Generator().manual_seed(0), device='cpu').state_dict()\n"
        "net = api.make_model(model, 20, weights, 'cpu')\n"
        "p, v, mask = torch.randn(512, 3) * 5, torch.zeros(512, 1), torch.ones(512, dtype=torch.bool)\n"
        "logp, _ = api.forward(net, p, v, mask, 0.6, (4096, 2048, 1024))\nassert logp.shape == (512, 20)\n"
    )
    mods = _modules_after(code)
    assert not [m for m in mods if m.split(".", 1)[0] in ("lattice_net_tpu_torch",) + run.FORBIDDEN]


def test_flop_count_equals_a_hand_count():
    model = dict(pointnet_channels_per_layer=[4], pointnet_start_nr_channels=8, nr_downsamples=1,
                 nr_blocks_down_stage=[1], nr_blocks_bottleneck=1, nr_blocks_up_stage=[1],
                 nr_levels_down_with_normal_resnet=1, nr_levels_up_with_normal_resnet=0,
                 compression_factor=1.0)  # fmt: skip
    v0, v1, n, k, classes = 10, 3, 6, 9, 5
    hand = (
        2 * n * 4 * (3 + 1) * 4  # PointNet's layer over 4 edges a point, in = d + 1 value
        + 2 * v0 * k * 8 * 8  # PointNet's conv, 2 * 4 -> 8
        + 2 * (2 * v0 * k * 8 * 8)  # one resnet block at level 0, C = 8
        + 2 * v1 * k * 8 * 16  # coarsen 8 -> 16 onto level 1
        + (2 * v1 * 16 * 4 + 2 * v1 * k * 4 * 4 + 2 * v1 * 4 * 16)  # bottleneck at level 1, C = 16
        + 2 * v0 * k * 16 * 8  # finefy 16 -> 8 onto level 0
        + (2 * v0 * 16 * 4 + 2 * v0 * k * 4 * 4 + 2 * v0 * 4 * 16)  # up block at level 0, C = 8 + 8
        + 2 * v0 * (16 * 16 + 16 * 8 + 8 * 8)  # the head's three 1x1 layers
        + 2 * v0 * 16 * classes  # the per-vertex classifier
        + 2 * n * 4 * 9 + 2 * n * 4 * classes  # the offsets and the slice
    )
    assert yardstick.lnn_forward_flops(model, classes, 3, 1, [v0, v1], n) == hand


def test_k1_bytes_equal_a_hand_count():
    nbr = torch.tensor([[0, 1, 7], [1, 9, -1]], dtype=torch.int32)  # 9 and -1 are outside a 8-row table
    # rows referenced: 0, 1, 7 and, with the centre column at row0 = 4, rows 4 and 5
    assert yardstick.k1_call_bytes(8, 16, 2, nbr, True, 4) == 5 * 32 + 6 * 4 + 2 * 4 * 32
    assert yardstick.k1_call_bytes(8, 16, 2, nbr, False, 0) == 3 * 32 + 6 * 4 + 2 * 3 * 32


def test_trace_reading_on_a_hand_made_trace():
    ev = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)  # noqa: E731
    data = {"traceEvents": [
        ev("user_annotation", trace.ITEM, 0, 100), ev("user_annotation", trace.ITEM, 200, 100),
        ev("kernel", "gather_rows16", 10, 20), ev("kernel", "other", 20, 20), ev("gpu_memcpy", "copy", 250, 30),
        ev("cpu_op", "aten::sort", 35, 30), ev("kernel", "late", 150, 10),
    ]}  # fmt: skip
    tr = trace.read(data)
    assert tr["items_us"] == 200 and tr["window_us"] == 300
    assert tr["busy_in_items_us"] == 30 + 30  # [10, 40] and [250, 280]; the kernel between items is outside
    assert tr["busy_us"] == 70
    assert trace.k1_device_us(tr, yardstick.K1_KERNEL_NAMES) == 20
    assert tr["gaps"]["aten::sort"] == 60  # [40, 100], the sort started at 35
    assert sum(tr["gaps"].values()) == 200 - 60


def _write(path: Path, obj):
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration of another lattice dimension (xyz+intensity, d = 4), a
    Poisson mix in bursts, a training mix of two clouds a step, a new loop,
    each cell's limits and a per-layer metric, all dropped in as new files
    beside a copy of the harness and named in its ``BENCHMARK.json``: each
    cell runs, reports its metrics and comes out correct (the port in f32)."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.spec(ROOT)
    pb = tmp_path / "port_bench"
    cfg = json.loads((pb / "configs" / "semantickitti_tiny.json").read_text())
    cfg.update(name="semantickitti_xyzi", model=dict(cfg["model"], positions_mode="xyz+intensity"))
    _write(pb / "configs" / "semantickitti_xyzi.json", cfg)
    serve = json.loads((pb / "traffic" / "lidar_10hz.json").read_text())
    _write(pb / "traffic" / "lidar_fleet.json", dict(serve, arrivals="poisson", burst=2, rate_hz=5))
    train = json.loads((pb / "traffic" / "lidar_train.json").read_text())
    _write(pb / "traffic" / "lidar_train_b2.json", dict(train, batch=2))
    label = json.loads((pb / "traffic" / "room_label_5m.json").read_text())
    _write(pb / "traffic" / "lidar_label.json", dict(label, driver="label_again", scene="lidar_sweep"))
    _write(pb / "loops" / "label_again.py", (pb / "loops" / "label_closed_loop.py").read_text())
    _write(pb / "metrics" / "serve.points_per_scan.py",
           'UNIT = "points"\n\n\ndef read(reading):\n    return reading["traffic"]["points_max"]\n')  # fmt: skip
    cells = {"kitti4_fleet": ("semantickitti_xyzi", "lidar_fleet", "kitti_serve_10hz"),
             "kitti4_train_b2": ("semantickitti_xyzi", "lidar_train_b2", "kitti_train"),
             "kitti_label": ("semantickitti_tiny", "lidar_label", "scannet_eval_5m")}  # fmt: skip
    bench["configs"].append(dict(name="semantickitti_xyzi", source="test", reduced=[], why="test",
                                 file="port_bench/configs/semantickitti_xyzi.json"))  # fmt: skip
    for name, (config, traffic, like) in cells.items():
        bench["workloads"].append(dict(name=name, config=config, traffic=traffic, chips=1, why="test"))
        _write(pb / "limits" / f"{name}.json", (pb / "limits" / f"{like}.json").read_text())
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    bench["per_layer"].append(dict(name="serve.points_per_scan", unit="points", better="higher",
                                   source="program_counter", layer="test", moves="serve_p95_ms",
                                   workloads=["kitti4_fleet"]))  # fmt: skip
    _write(tmp_path / "BENCHMARK.json", bench)
    tiny_of = {name: tiny(like, f32=True) for name, (_, _, like) in cells.items()}
    tiny_of["kitti_label"]["config"] = tiny("kitti_serve_10hz", f32=True)["config"]
    code = (
        "import json, sys\nfrom port_bench import run\n"
        f"tiny = json.loads({json.dumps(json.dumps(tiny_of))})\n"
        "for name, trace in (('kitti4_fleet', True), ('kitti4_train_b2', False), ('kitti_label', False)):\n"
        "    r = run.run_cell(name, 5, 1.0, trace, 'cpu', tiny[name])\n"
        "    print(json.dumps(dict(name=name, correct=r['correct'], metrics=r['metrics'])))\n"
        "print(run.__file__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=900)  # fmt: skip
    assert out.returncode == 0, out.stderr[-3000:]
    *lines, where = out.stdout.strip().splitlines()[-4:]
    assert where.startswith(str(tmp_path))
    results = {r["name"]: r for r in map(json.loads, lines)}
    assert all(r["correct"] for r in results.values()), results
    assert results["kitti4_fleet"]["metrics"]["serve.points_per_scan"]["value"] == 4096
    assert {"serve.build_ms", "serve.model_ms", "host.aten_ops.serve"} <= set(results["kitti4_fleet"]["metrics"])
    assert set(results["kitti4_train_b2"]["metrics"]) == {"peak_mem_gib", "setup_s"}
    assert set(results["kitti_label"]["metrics"]) == {"rooms_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_reference_equals_the_port_in_f32(cell):
    """With the port's convs in f32 on the CPU the reference computes what
    the port computes, bit for bit: every number compared is 0, but the
    gradients, which the harness recovers from the optimizer's first moment
    (``(mu1 - b1 mu0) / (1 - b1)``, a few roundings)."""
    out = run.run_cell(cell, 2**33 + 5, 1.0, False, "cpu", tiny(cell, f32=True))
    numbers = {k: v["value"] for k, v in out["compared"].items() if k != "clouds_compared"}
    assert numbers.pop("grad_gap", 0.0) < 1e-6
    assert numbers.pop("win_grad_gap", 0.0) < 1e-6
    assert numbers == dict.fromkeys(numbers, 0.0)
