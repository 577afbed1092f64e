"""The port stands alone: no JAX, no flax, nothing of the JAX package, and it
imports on a host without CUDA, where its entry points refuse to run
without ``device='cpu'``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lattice_net_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lattice_net_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _run(code, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_without_cuda_or_jax():
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    parallel = {f"lattice_net_tpu_torch.parallel.{m}" for m in ("mesh", "lattice_sharded", "data_parallel", "dryrun")}
    assert parallel <= set(mods)
    tools = ("profiling", "profile_train", "profile_forward", "profile_build", "batch_scaling_probe",
             "lnn_grad_check", "compute_class_frequency", "lnn_check_lattice_size", "lnn_make_teaser",
             "parse_trace", "op_census", "prim_cost_chip", "cache_key_probe")  # fmt: skip
    assert {f"lattice_net_tpu_torch.misc.{m}" for m in tools} <= set(mods)
    code = (
        "import importlib, sys, torch\n"
        "assert not torch.cuda.is_available()\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    from lattice_net_tpu_torch import resolve_device
    from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
    from lattice_net_tpu_torch.serve import Predictor

    cfg = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
    with pytest.raises(RuntimeError):
        Predictor.from_config(cfg, nr_classes=20)
    with pytest.raises(RuntimeError):
        LNN(ModelParams(nr_downsamples=1, nr_blocks_down_stage=(1,), nr_blocks_up_stage=(1,)),
            torch.Generator().manual_seed(0))  # fmt: skip
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    from lattice_net_tpu_torch.misc import lnn_grad_check

    monkeypatch.setattr(sys, "argv", ["lnn_grad_check"])
    with pytest.raises(RuntimeError):
        lnn_grad_check.main()


def test_chip_smoke_fails_without_a_card(tmp_path):
    # in the repo, and alone in a directory without the package
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONPATH", None)
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=300,
        )  # fmt: skip
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
