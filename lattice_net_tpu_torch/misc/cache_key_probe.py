"""Is the kernels' build cache stable across processes?  (The JAX package's
``misc/cache_key_probe.py``, which asks the same of JAX's persistent
compile cache.)

    python -m lattice_net_tpu_torch.misc.cache_key_probe [--children N]
        [--device cuda|cpu]

The port builds each ``csrc/<name>.cu`` into ``build/<name>-<key>.so``,
``<key>`` a hash of the source, the nvcc flags and the toolkit's ``nvcc
--version`` text (``ops_cuda/_build.py``).  For each source it prints the
key's components (the source's sha256, the flags, the toolkit's version
text, "" without nvcc), the target path and whether the target exists.

With ``--children N`` it runs itself in N fresh processes, one after the
other, under ``PYTHONHASHSEED`` 0, 1, ... and reports whether their keys
agree.  On the card each child also builds every kernel into one fresh
temporary build directory, so the first child builds them all; the report
says which kernels each child built (the second must build none) and each
child's seconds from the start of its run to the end of its first kernel
call.  On the CPU
(``--device cpu``) the children only report their keys.  Prints JSON
lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.ops_cuda import _build

ROOT = Path(__file__).resolve().parents[2]


def keys() -> list:
    """One record a source: the key's components, its target and whether
    the target exists."""
    out = []
    for name in _build.SOURCES:
        target = _build._target(name)
        out.append(dict(source=f"csrc/{name}.cu", **_build.key_parts(name), target=target.name, exists=target.exists()))
    return out


def first_kernel_call(device) -> None:
    """One K4 launch on the card, waited for."""
    from lattice_net_tpu_torch.ops_cuda.gather import take_rows

    values = torch.arange(64, dtype=torch.float32, device=device).reshape(16, 4)
    take_rows(values, torch.arange(16, dtype=torch.int32, device=device))
    torch.cuda.synchronize(device)


def child(device, build_dir) -> dict:
    """This process's keys for ``build_dir`` and, on the card, which kernels
    it built and its seconds to the end of its first kernel call."""
    t0 = time.perf_counter()
    _build.BUILD = Path(build_dir)
    rec = dict(pythonhashseed=os.environ.get("PYTHONHASHSEED"), pid=os.getpid(), keys=keys())
    if device.type == "cuda":
        missing = [k["source"] for k in rec["keys"] if not k["exists"]]
        _build.build_all(_build.SOURCES)
        first_kernel_call(device)
        rec.update(built=missing, seconds_to_first_kernel=time.perf_counter() - t0)
    return rec


def run(children=0, device=None) -> dict:
    """Prints this process's keys and, with ``children``, each child's
    record and the verdict; returns them."""
    device = resolve_device(device)
    own = keys()
    for rec in own:
        print(json.dumps(rec), flush=True)
    out = dict(keys=own, children=[])
    if not children:
        return out
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(children):
            env = dict(os.environ, PYTHONHASHSEED=str(i), PYTHONPATH=str(ROOT))
            cmd = [sys.executable, "-m", "lattice_net_tpu_torch.misc.cache_key_probe", "--child",
                   "--device", str(device), "--build-dir", tmp]  # fmt: skip
            r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"cache_key_probe child {i} failed:\n{r.stderr}")
            out["children"].append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(out["children"][-1]), flush=True)
    names = [[(k["source"], k["target"]) for k in c["keys"]] for c in out["children"]]
    out["keys_agree"] = all(n == names[0] for n in names)
    verdict = dict(children=children, keys_agree=out["keys_agree"])
    if device.type == "cuda":
        out["later_children_built"] = [c["built"] for c in out["children"][1:]]
        verdict.update(later_children_built=out["later_children_built"],
                       seconds_to_first_kernel=[c["seconds_to_first_kernel"] for c in out["children"]])  # fmt: skip
    print(json.dumps(verdict), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--children", type=int, default=0, help="fresh processes to compare (e.g. 2)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build-dir", help=argparse.SUPPRESS)  # a child's
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(resolve_device(a.device), a.build_dir)), flush=True)
    else:
        run(a.children, a.device)


if __name__ == "__main__":
    main()
