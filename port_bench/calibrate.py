"""Readings that set the limits of ``correct``: the compared numbers of the
program on many seeds and of the control (the reference in fp8, in the
program's place) on a few, each a whole run of the cell with a short
window, in one process.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 3]
        [--fault unchanged_state --fault-seeds 7,8,9]

``--fault`` plants one of ``faults.FAULTS`` in the port for the runs of
``--fault-seeds``.  Prints one JSON line a run: ``{"seed", "control",
"fault", "numbers", "correct", "metrics"}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from port_bench import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--fault-seeds", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = lambda text: [int(s) for s in text.split(",") if s]  # noqa: E731
    plan = [(s, False, None) for s in seeds(a.seeds)] + [(s, True, None) for s in seeds(a.control_seeds)]
    plan += [(s, False, a.fault) for s in seeds(a.fault_seeds)]
    for seed, control, fault in plan:
        with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
            details = {}
            r = run.run_cell(a.workload, seed, a.seconds, False, "cuda:0", control=control, details=details)
        numbers = dict({k: v["value"] for k, v in r["compared"].items()}, **details["info"])
        print(json.dumps(dict(workload=a.workload, seed=seed, control=control, fault=fault, numbers=numbers,
                              correct=r["correct"], metrics={k: v["value"] for k, v in r["metrics"].items()})),
              flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
