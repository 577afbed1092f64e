"""ctypes bridge to the native threaded cloud reader
(``lattice_net_tpu_torch/native/cloud_loader.cpp``, the port's copy of the
JAX package's ``native/cloud_loader.cpp``).

Reader threads decode scans into a bounded queue while the card computes;
Python drains them as numpy arrays.  The source is built with ``g++`` at
first use into ``lattice_net_tpu_torch/build/libcloud_loader-<hash>.so``
(``<hash>`` of the source and the flags, those of ``native/Makefile``), so
an edited source never loads a stale library.  A failed build raises from
:func:`build_native`; :func:`native_available` returns False and keeps the
compiler's message for :func:`build_error`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "cloud_loader.cpp"
BUILD = _PKG / "build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

FORMAT_KITTI_BIN = 0
FORMAT_SHAPENET_PTS = 1

_state: dict = {}  # "lib": the loaded library, "error": why the build failed


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()
    return BUILD / f"libcloud_loader-{digest[:16]}.so"


def build_native() -> Path:
    """The shared library's path, compiled first if it is missing; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native reader cannot be built on this host")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load():
    lib = _state.get("lib")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build_native()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
    ]  # fmt: skip
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.loader_free_sample.restype = None
    lib.loader_free_sample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]  # fmt: skip
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _state["lib"] = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads; the reason it does not is kept
    for :func:`build_error` (and the build is not tried again)."""
    if "error" in _state:
        return False
    try:
        _load()
    except (RuntimeError, OSError) as e:
        _state["error"] = str(e)
        return False
    return True


def build_error() -> str:
    """Why :func:`native_available` returned False ("" if it did not)."""
    return _state.get("error", "")


class NativeCloudLoader:
    """Iterator over ``(xyz (N, 3) f32, extra (N,) f32, labels (N,) i32)``
    numpy arrays, decoded off-thread, each file once (with ``shuffle``, in
    an order drawn from ``seed``); ``close`` stops the threads."""

    def __init__(
        self,
        files,
        label_files=None,
        fmt: int = FORMAT_KITTI_BIN,
        n_threads: int = 4,
        queue_capacity: int = 8,
        shuffle: bool = False,
        seed: int = 0,
    ):
        lib = _load()
        self._lib = lib
        files = [str(f) for f in files]
        c_files = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        c_labels = None
        if label_files is not None:
            lf = [str(x) if x else "" for x in label_files]
            c_labels = (ctypes.c_char_p * len(files))(*[x.encode() for x in lf])
        self._h = lib.loader_create(
            c_files, c_labels, len(files), fmt, n_threads, queue_capacity, int(shuffle), seed, 0
        )  # the last argument: no loop over the files
        if not self._h:
            raise OSError("loader_create failed")

    def next(self):
        """Blocking pop: one decoded scan, or None at the end of the data."""
        xyz = ctypes.POINTER(ctypes.c_float)()
        extra = ctypes.POINTER(ctypes.c_float)()
        labels = ctypes.POINTER(ctypes.c_int)()
        n = ctypes.c_int()
        refs = (ctypes.byref(xyz), ctypes.byref(extra), ctypes.byref(labels), ctypes.byref(n))
        if not self._lib.loader_next(self._h, *refs):
            return None
        count = n.value
        # copies owned by numpy, then the C buffers are freed
        out = (
            np.ctypeslib.as_array(xyz, shape=(count, 3)).copy(),
            np.ctypeslib.as_array(extra, shape=(count,)).copy(),
            np.ctypeslib.as_array(labels, shape=(count,)).copy(),
        )
        self._lib.loader_free_sample(xyz, extra, labels)
        return out

    def __iter__(self):
        while (s := self.next()) is not None:
            yield s

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
