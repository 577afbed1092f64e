"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA cards.
``BENCHMARK.json`` names the cell's configuration (``port_bench/configs/
<config>.json``) and traffic mix (``port_bench/traffic/<traffic>.json``,
parameters that the general generator ``inputs.py`` reads, and the name of
the loop that drives the port, ``port_bench/loops/<driver>.py``), and the
metrics; each per-layer metric is read by ``port_bench/metrics/<name>.py``.
Every file is found by its name: adding a cell, a configuration, a mix, a
loop or a per-layer metric adds files and entries and edits none.

The run makes the weights and the inputs from ``--seed``, builds or finds
the port's kernels (``lattice_net_tpu_torch/build/``), warms the cell's
shapes, measures for ``--seconds`` and then holds what the window produced
against the plain reference (``reference/``).  With ``--trace 0`` it reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones (the
window then times each stage, and a short profiled segment and an aten-op
count follow it).  Its last stdout line is one JSON object; the numbers
compared, each beside its limit, are its last key and the last lines of
stderr.  Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result; if ``jax``, ``jaxlib``, ``flax``, ``optax``
or ``lattice_net_tpu`` were loaded, it exits 3 and prints none.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lattice_net_tpu")
CACHE = ROOT / ".port_bench_cache"  # fixed paths inside the checkout


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    try:
        start_ticks = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = process_age_s()
T_IMPORT = time.perf_counter()


def since_start() -> float:
    return T_PROCESS + time.perf_counter() - T_IMPORT


def load_json(path: Path):
    return json.loads(path.read_text())


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(bench: dict, name: str):
    """(cell, configuration, traffic) of the cell ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT / config["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def limits_of(name: str) -> dict:
    """The cell's limits of ``correct``, ``limits/<cell>.json``: {number:
    limit}."""
    return load_json(HERE / "limits" / f"{name}.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    mod_name = f"port_bench.{folder}._" + "".join(c if c.isalnum() else "_" for c in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The module ``metrics/<name>.py``: ``UNIT`` and ``read(reading)``."""
    return _load("metrics", name)


def loop(driver: str):
    """The module ``loops/<driver>.py``: ``run(env)``."""
    return _load("loops", driver)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Env:
    """What a loop gets: the configuration, the traffic, the seed's
    generator, the window's length, the device, the program and the
    weights; and where it reports set-up's stages, the window's start and
    the memory's peak."""

    def __init__(self, cfg, traffic, seed, seconds, trace, device, program):
        self.cfg, self.traffic, self.seconds, self.trace = cfg, traffic, float(seconds), bool(trace)
        self.device, self.program, self.seed = device, program, int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.control = False  # the calibration's control run (``calibrate.py``)
        self.limits = {}  # {number compared: its limit}, ``limits/<cell>.json``
        self.stages = {}  # set-up's stages: seconds since process start at each end

    def stage(self, name):
        self.stages[name] = since_start()

    def start_window(self):
        self.setup_s = since_start()
        self.stages["warm-up"] = self.setup_s

    def read_memory(self):
        import torch

        if torch.device(self.device).type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def note(self, text):
        print(text, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", overrides=None,
             bench: dict | None = None, control: bool = False, details: dict | None = None) -> dict:  # fmt: skip
    """One run of the cell: the result object (its last key ``compared``).
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) resizes a cell
    for the CPU tests; the command line passes none.  ``details``, if given,
    receives the numbers computed but not compared (``info``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from port_bench import program

    bench = bench or spec()
    cell, cfg, traffic = cell_files(bench, name)
    cfg = merged(cfg, (overrides or {}).get("config"))
    traffic = merged(traffic, (overrides or {}).get("traffic"))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    env = Env(cfg, traffic, seed, seconds, trace, device, program)
    env.control = control
    env.limits = limits_of(name)
    env.stage("imports")
    program.build_kernels(device)
    env.stage("kernels")
    model = program.make_model(cfg, device)
    env.weights = program.seeded_weights(model, seed, device)
    del model
    env.stage("weights")
    out = loop(traffic["driver"]).run(env)
    e2e = dict(out["e2e"], setup_s=env.setup_s, peak_mem_gib=env.memory_peak_bytes / 2**30)
    metrics, reading = {}, dict(layer=out["layer"], e2e=e2e, cfg=cfg, traffic=traffic)
    for m in metrics_for(bench, name, trace):
        if trace:
            value = reader(m["name"]).read(reading)
            if value is None:
                continue
        else:
            value = e2e[m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    chk = out["check"]
    compared = {k: {"value": v, "limit": chk["limits"][k]} for k, v in chk["numbers"].items()}
    compared["clouds_compared"] = {"value": chk["compared"], "limit": chk["expected"]}
    correct = (
        out["failed"] == 0 and chk["compared"] == chk["expected"]
        and all(v <= chk["limits"][k] for k, v in chk["numbers"].items())
    )  # fmt: skip
    dev = dict(platform="gpu" if cuda else "cpu", kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=env.memory_peak_bytes)  # fmt: skip
    result = dict(correct=bool(correct), attempted=int(out["attempted"]), failed=int(out["failed"]),
                  metrics=metrics, device=dev)  # fmt: skip
    tr = out["layer"].get("trace")
    if trace and tr is not None:
        from port_bench.trace import breakdown

        dev.update(busy_s=tr["busy_us"] / 1e6, window_s=tr["window_us"] / 1e6)
        result["breakdown"] = breakdown(tr)
    result["compared"] = compared
    print(f"set-up stages, seconds since the process started: {env.stages}", file=sys.stderr)
    if chk["info"]:
        print(f"numbers not compared: {chk['info']}", file=sys.stderr)
    if details is not None:
        details["info"] = chk["info"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)  # one process, few threads: the host is the bottleneck and is shared
    bench = spec()
    cell, _, _ = cell_files(bench, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {a.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)  # fmt: skip
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0", bench=bench)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules loaded that the port may not use: {found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
