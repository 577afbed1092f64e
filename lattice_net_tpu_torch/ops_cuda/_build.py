"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/<name>-<hash>.so`` (``<hash>`` of the source, the flags and
the toolkit's ``nvcc --version`` text, so neither an edited source nor
another toolkit ever loads a stale library).  The build happens at first
use, on the machine with the card; a missing ``nvcc`` or a failed build
raises.  :func:`build_all` starts every build at once, one nvcc per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))  # the kernels' sources, by name
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip

_loaded: dict = {}
_toolkit: list = []  # the toolkit's version text, read once a process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")
    return path


def toolkit_version() -> str:
    """``nvcc --version``'s text, or "" on a host without nvcc; read once a
    process."""
    if not _toolkit:
        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
            _toolkit.append(out.stdout if out.returncode == 0 else "")
        except RuntimeError:
            _toolkit.append("")
    return _toolkit[0]


def key_parts(name: str) -> dict:
    """The components of ``csrc/<name>.cu``'s build key."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return dict(source_sha256=hashlib.sha256(src).hexdigest(), flags=" ".join(NVCC_FLAGS), nvcc=toolkit_version())


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode() + toolkit_version().encode()
    return BUILD / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the target path."""
    target = _target(name)
    if target.exists():
        return None, target
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), target


def _finish(name: str, started, target: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names) -> None:
    """Compile the named sources in parallel (one nvcc each)."""
    jobs = [(name, *_start(name)) for name in names]
    for name, started, target in jobs:
        _finish(name, started, target)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        started, target = _start(name)
        _finish(name, started, target)
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib


def device_type(t, what: str) -> str:
    """``"cpu"`` or ``"cuda"``, the devices a kernel wrapper serves; any other
    raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")
    return t.device.type


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
