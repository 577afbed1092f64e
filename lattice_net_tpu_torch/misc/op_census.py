"""Op census of the served scan and of one train step: what the program
asks of the device, counted per op class (the JAX package's
``misc/hlo_census.py``, which counts the ops of the two programs' HLO).

    python -m lattice_net_tpu_torch.misc.op_census [--train] [--per-op]
        [--n-points N] [--f32] [--device cuda|cpu]

The programs are ``hlo_census``'s at its settings, with the port's model:
its ``ModelParams`` (20 classes, PointNet (16, 32), 2 downsamples, one
block a stage), sigma 0.6, capacities 65536/32768/8192, ``--n-points``
Gaussian points (scale 10, seed 0) with zero values.  The served scan is
the build and the forward with its argmax (under ``no_grad``); ``--train``
censuses one ``make_train_step`` step instead (build, forward, loss, backward, AdamW
with cosine warm restarts, lr 1e-3, weight decay 1e-4).  The convs run in
bf16 on either device, the card's dtype (``hlo_census`` forces it too);
``--f32`` censuses the f32 path.

One call (warmed on the card) runs under a ``TorchDispatchMode`` that files each aten
op under a class: ``sort``, ``gather``, ``scatter``, ``scan``, ``matmul``,
``reduce``, ``copy`` or ``other``, with its count and result bytes.  Two
more classes:

* ``kernel:<wrapper>``: one count a call of one of the eight CUDA kernels'
  wrappers (their dispatch points in ``ops_cuda``); the aten ops inside a
  call (on the CPU its plain version, on the card its output allocation)
  are not counted, so a CPU census counts what the card launches.  On the
  card the counts are held against the wrappers' ``.launches`` deltas.
* ``host_sync``: the ops that make the host wait for the device:
  ``_local_scalar_dense`` (``.item()``, ``int()``, ``float()``, ``bool()``
  of a tensor), ``nonzero``, ``masked_select``, ``unique*``, ``equal``,
  ``is_nonzero``, indexing by a boolean mask (a ``nonzero`` inside), and
  copies from the device to a CPU destination.

Each count is also filed under the port's function that issued it (the
innermost frame in ``lattice_net_tpu_torch``, e.g.
``lattice/ops.py:_cumsum_f32``, or an autograd ``Function``'s
``backward``).  Autograd runs the backward of CUDA tensors on a thread of
its own, where no frame of the port is: those ops count under ``(autograd
thread)``; on the CPU they run on the calling thread, under the function
that called ``torch.autograd.grad``.  Prints JSON lines: the setup, one a class (``count``,
``result_mb``; with ``--per-op`` its ops with their counts and result MB),
the functions by count, and the total.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import threading
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.ops_cuda import gather as k_gather
from lattice_net_tpu_torch.ops_cuda import lookup as k_lookup
from lattice_net_tpu_torch.ops_cuda import norm as k_norm
from lattice_net_tpu_torch.ops_cuda import patch as k_patch
from lattice_net_tpu_torch.ops_cuda import segment as k_segment

# hlo_census.py's model and settings
MODEL = ModelParams(
    nr_classes=20, pointnet_channels_per_layer=(16, 32), pointnet_start_nr_channels=32, nr_downsamples=2,
    nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
)  # fmt: skip
SIGMA = 0.6
CAPACITIES = (1 << 16, 1 << 15, 1 << 13)

CLASS_OPS = {
    "sort": {"sort", "argsort", "topk", "msort"},
    "gather": {"index_select", "index", "gather", "take_along_dim", "embedding", "take"},
    "scatter": {"index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_", "scatter", "scatter_",
                "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"},
    "scan": {"cumsum", "cumsum_", "cummax", "_cummax_helper"},
    "matmul": {"mm", "bmm", "addmm", "linear", "matmul", "baddbmm", "addmv", "mv"},
    "reduce": {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "var", "std", "var_mean",
               "std_mean", "norm", "linalg_vector_norm", "argmax", "argmin", "logsumexp", "aminmax"},
    "copy": {"copy_", "_to_copy", "clone", "_copy_from", "_copy_from_and_resize"},
}  # fmt: skip
SYNC_OPS = {"_local_scalar_dense", "item", "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
            "unique_consecutive", "unique_dim_consecutive", "equal", "is_nonzero"}  # fmt: skip
CLASSES = (*CLASS_OPS, "host_sync", "other")
_PREFIX = str(Path(__file__).resolve().parents[1]) + "/"
_SELF = str(Path(__file__).resolve())
# the kernels' dispatch points: (module, attribute, the wrapper whose .launches counts the launch)
KERNEL_SITES = (
    (k_patch, "_gather", "patch_gather"),
    (k_patch, "patch_scatter", "patch_scatter"),
    (k_segment, "_seg_max", "seg_max_carry"),
    (k_segment, "seg_max_carry_bwd", "seg_max_carry_bwd"),
    (k_segment, "_seg_sum", "seg_sum_sorted_fast"),
    (k_gather, "_take_rows", "take_rows"),
    (k_norm, "_group_norm_act", "group_norm_act"),
    (k_lookup, "lookup2", "lookup2"),
)


def _is_cpu(x) -> bool:
    return torch.device(x).type == "cpu"


def op_class(name: str, args, kwargs) -> str:
    """The class of one aten op (its overload packet's name)."""
    if name in SYNC_OPS or name.startswith("unique"):
        return "host_sync"
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8) for t in indices):
            return "host_sync"
    if name == "_to_copy":
        dst = kwargs.get("device")
        if dst is not None and _is_cpu(dst) and not _is_cpu(args[0].device):
            return "host_sync"
    if name in ("copy_", "_copy_from", "_copy_from_and_resize"):
        dst, src = (args[0], args[1]) if name == "copy_" else (args[1], args[0])
        if _is_cpu(dst.device) and not _is_cpu(src.device):
            return "host_sync"
    for cls, ops in CLASS_OPS.items():
        if name in ops:
            return cls
    return "other"


def _result_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out) if isinstance(t, torch.Tensor))


def _caller(thread: int) -> str:
    """``<file in the package>:<function>`` of the innermost frame of the
    port outside the census's own machinery; else ``"(autograd thread)"``
    off the census's ``thread``, ``"(outside the port)"`` on it."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        own = code.co_filename == _SELF and code.co_name in ("__torch_dispatch__", "__call__")
        if code.co_filename.startswith(_PREFIX) and not own:
            return f"{code.co_filename[len(_PREFIX):]}:{code.co_name}"
        f = f.f_back
    return "(outside the port)" if threading.get_ident() == thread else "(autograd thread)"


class Census(TorchDispatchMode):
    """Counts every aten op dispatched inside the mode, by class and op
    (``rows[(class, op)] = [count, result bytes]``) and by the port's
    function that issued it (``functions``), except inside a kernel
    wrapper's call, which counts once as ``kernel:<wrapper>``."""

    def __init__(self):
        super().__init__()
        self.rows = collections.defaultdict(lambda: [0, 0])
        self.functions = collections.Counter()
        self.thread = threading.get_ident()
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted:
            name = func.overloadpacket.__name__
            row = self.rows[(op_class(name, args, kwargs), name)]
            row[0] += 1
            row[1] += _result_bytes(out)
            self.functions[_caller(self.thread)] += 1
        return out


class _Site:
    """A kernel's dispatch point while a census runs: counts the call and
    mutes the census inside it.  ``launches`` reads and writes the
    wrapper's counter, which the dispatch point may increment through its
    module's name for itself."""

    def __init__(self, fn, census: Census, name: str, counter):
        self.fn, self.census, self.name, self.counter = fn, census, name, counter

    def __call__(self, *args, **kwargs):
        self.census.rows[(f"kernel:{self.name}", self.name)][0] += 1
        self.census.functions[_caller(self.census.thread)] += 1
        self.census.muted += 1
        try:
            out = self.fn(*args, **kwargs)
        finally:
            self.census.muted -= 1
        self.census.rows[(f"kernel:{self.name}", self.name)][1] += _result_bytes(out)
        return out

    @property
    def launches(self):
        return self.counter.launches

    @launches.setter
    def launches(self, value):
        self.counter.launches = value


@contextlib.contextmanager
def _kernel_sites(census: Census):
    """The kernels' dispatch points replaced by :class:`_Site` inside the block."""
    saved = []
    try:
        for mod, attr, wrapper in KERNEL_SITES:
            fn = getattr(mod, attr)
            counter = fn if attr == wrapper else getattr(mod, wrapper)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _Site(fn, census, wrapper, counter))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def launch_counts() -> dict:
    """``{wrapper: .launches}`` of the kernel wrappers."""
    return {wrapper: getattr(mod, wrapper).launches for mod, _, wrapper in KERNEL_SITES}


def census(fn) -> dict:
    """Runs ``fn()`` once under a :class:`Census`: ``{"classes": {class:
    {"count", "result_bytes", "ops": {op: [count, bytes]}}}, "total",
    "result_bytes", "functions": {function: count}, "launches": {wrapper:
    .launches delta}}``."""
    before = launch_counts()
    mode = Census()
    with _kernel_sites(mode), mode:
        fn()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    classes = {}
    for (cls, op), (count, nbytes) in sorted(mode.rows.items()):
        row = classes.setdefault(cls, dict(count=0, result_bytes=0, ops={}))
        row["count"] += count
        row["result_bytes"] += nbytes
        row["ops"][op] = [count, nbytes]
    return dict(
        classes=classes, total=sum(r["count"] for r in classes.values()),
        result_bytes=sum(r["result_bytes"] for r in classes.values()),
        functions=dict(mode.functions.most_common()), launches=launches,
    )  # fmt: skip


def programs(n_points: int, train: bool, conv_dtype, device, capacities=CAPACITIES):
    """(the program as a no-argument callable, the model's parameter count
    and its parameter tensors) at ``hlo_census``'s settings."""
    rng = np.random.default_rng(0)
    positions = torch.from_numpy((rng.normal(size=(n_points, 3)) * 10).astype(np.float32)).to(device)
    values = torch.zeros((n_points, 1), dtype=torch.float32, device=device)
    model = LNN(MODEL, torch.Generator().manual_seed(0), device=device, conv_dtype=conv_dtype)
    params = (sum(p.numel() for p in model.parameters()), len(list(model.parameters())))
    nl = MODEL.nr_downsamples
    if not train:
        model.eval()

        def serve():
            # no_grad, not inference_mode: under inference_mode composite ops
            # (``to``, ``reshape``, ``item``) reach the census undecomposed
            with torch.no_grad():
                h = build_hierarchy(positions, SIGMA, nl, capacities, point_feats=values)
                return model(h, positions, values)[0].argmax(-1).to(torch.int32)

        return serve, params
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState, make_train_step
    from lattice_net_tpu_torch.train.optim import make_optimizer

    target = torch.from_numpy(rng.integers(1, 20, n_points).astype(np.int32)).to(device)
    batch = dict(positions=positions[None], values=values[None], target=target[None],
                 point_mask=torch.ones((1, n_points), dtype=torch.bool, device=device))  # fmt: skip
    tx = make_optimizer(1e-3, weight_decay=1e-4, schedule="cosine_warm_restarts", t0_steps=1000)
    step = make_train_step(model, tx, SIGMA, nl, capacities, full_mask=True)
    holder = [TrainState.create(model.state_dict(), tx)]

    def train_step():
        holder[0], metrics = step(holder[0], batch)
        return metrics

    return train_step, params


def run(train=False, per_op=False, n_points=1 << 17, f32=False, device=None, capacities=CAPACITIES) -> dict:
    """Prints the JSON lines of the module docstring; returns the census
    (:func:`census`) with its ``setup``."""
    device = resolve_device(device)
    conv_dtype = torch.float32 if f32 else torch.bfloat16
    fn, params = programs(n_points, train, conv_dtype, device, capacities)
    if device.type == "cuda":
        fn()  # warm: the kernels built and loaded (on the CPU a second call censuses the same ops)
        torch.cuda.synchronize()
    out = census(fn)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["setup"] = dict(
        census="train step" if train else "served scan", points=n_points, sigma=SIGMA, capacities=list(capacities),
        conv_dtype=str(conv_dtype), params=params[0], param_tensors=params[1], device=str(device),
        device_name=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )  # fmt: skip
    print(json.dumps(out["setup"]), flush=True)
    for cls, row in sorted(out["classes"].items(), key=lambda kv: -kv[1]["count"]):
        line = {"class": cls, "count": row["count"], "result_mb": row["result_bytes"] / 1e6}
        if cls.startswith("kernel:"):
            line["launches"] = out["launches"][cls.split(":", 1)[1]]
        if per_op:
            line["ops"] = {op: dict(count=c, result_mb=b / 1e6) for op, (c, b) in sorted(row["ops"].items())}
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(functions=out["functions"])), flush=True)
    print(json.dumps(dict(total=out["total"], result_mb=out["result_bytes"] / 1e6)), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train", action="store_true", help="census one train step (default: the served scan)")
    ap.add_argument("--per-op", action="store_true", help="list each class's ops")
    ap.add_argument("--n-points", type=int, default=1 << 17)
    ap.add_argument("--f32", action="store_true", help="f32 convs (default: bf16, the card's)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    run(a.train, a.per_op, a.n_points, a.f32, a.device)


if __name__ == "__main__":
    main()
