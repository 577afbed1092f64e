"""Cost model of the lattice build's primitives on the card (the JAX
package's ``misc/prim_cost_chip.py``): each primitive's marginal time at
KITTI scale, in the torch formulation that ``lattice/structure.py`` and
``lattice/ops.py`` use.

    python -m lattice_net_tpu_torch.misc.prim_cost_chip [--iters 10]
        [--repeats 3] [--m 524288] [--cap 65536] [--device cuda|cpu]

``--m`` edges (2^19: 131072 points x 4 corners) into ``--cap`` vertex rows
(2^16), the inputs drawn from one seeded numpy generator in the JAX tool's
order.  Each row is one primitive, named with the JAX row it stands for:
the no-op; the stable sort of one int64 packed key column with its payload
(``structure._sort_packed``) and of two columns (d > 3: two stable
argsorts); the take by a permutation; row gathers (CAP, 32) by random and
by sorted ids; the inverse permutation by a scatter (the build's
point -> vertex map) and by a sort; the scatter-max into (CAP+1,); the
scatter-add (CAP, 32) (``ops.segment_sum``);
cummax and cumsum; ``ops._cumsum_f32`` (no JAX row: it stands for
``jnp.cumsum``'s order); ``searchsorted`` of CAP queries (the one-column
lookup); the segment max (``scatter_reduce`` amax).

The time is the JAX tool's marginal ``(t(k=3) - t(k=1)) / 2``: a step
applies the primitive k times, each application feeding back into the
first operand by an XOR of bit 0 of its outputs' first elements, so that
no application can be skipped; the feedback and the per-step overhead
subtract out.  ``t(k)`` is the ms a step over ``--iters`` chained steps
after a warm-up (CUDA events on the card, ``time.perf_counter`` on the
CPU), the smallest of ``--repeats``.  Prints JSON lines: the setup, then
one a row (``name``, ``jax_row``, ``marginal_ms``, ``t1_ms``, ``t3_ms``).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, NamedTuple

import numpy as np
import torch

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import _cumsum_f32
from lattice_net_tpu_torch.lattice.structure import _sort_packed
from lattice_net_tpu_torch.misc.profiling import Marks

M = 1 << 19  # the KITTI-scale edge stream: 131072 points x 4 corners
CAP = 1 << 16  # level-0 vertex capacity


class Row(NamedTuple):
    name: str
    jax_row: str | None  # the JAX tool's row it stands for
    operand: str  # the input it chains through (its first operand)
    apply: Callable  # (first operand, inputs) -> tuple of outputs
    exact: bool  # its outputs equal on every device (else float sums, by 1e-5)


ROWS = (
    Row("noop (x ^ 1)", "noop (x ^ 1)", "key1", lambda o, c: (o ^ 1,), True),
    Row("sort one int64 key column + payload (_sort_packed)", "sort 2^19 x 2ops (key+payload)", "key64",
        lambda o, c: _sort_packed(o), True),
    Row("sort two int64 key columns, d > 3 (_sort_packed: 2 stable argsorts)", "sort 2^19 x 3ops", "key2col",
        lambda o, c: _sort_packed(o), True),
    Row("take (M,) f32 by perm", "take (M,) f32 by perm", "perm", lambda o, c: (c["x_m"][o],), True),
    Row("row gather (CAP,32) by (M,) random ids", "row gather (CAP,32) by (M,) rand ids", "rand_ids",
        lambda o, c: (c["tab32"][o],), True),
    Row("row gather (CAP,32) by (M,) sorted ids", "row gather (CAP,32) by (M,) sorted ids+flag", "mono_ids",
        lambda o, c: (c["tab32"][o],), True),
    Row("scatter-set (M,) by perm (the build's inverse perm)", "scatter-set (M,) by perm (inverse perm)", "perm64",
        lambda o, c: (torch.empty_like(c["A"]).scatter_(0, o, c["A"]),), True),
    Row("sort of (M,) perm (inverse perm)", "inverse perm via 2-op sort", "perm64",
        lambda o, c: (torch.sort(o)[1],), True),
    Row("scatter-max (CAP+1,) from M sorted ids", "scatter-max (CAP+1,) from M sorted ids",
        "mono64", lambda o, c: (c["ends0"].scatter_reduce(0, o, c["A"], "amax"),), True),
    Row("scatter-add (CAP,32) from (M,32) random ids (index_add)", "scatter-add (CAP,32) from (M,32) rand ids",
        "rand64", lambda o, c: (torch.zeros_like(c["tab32"]).index_add_(0, o, c["x_m32"]),), False),
    Row("cummax (M,) i32", "cummax (M,) i32", "key1", lambda o, c: (torch.cummax(o, 0)[0],), True),
    Row("cumsum (M,) i32", "cumsum (M,) i32", "key1", lambda o, c: (torch.cumsum(o & 1, 0, dtype=torch.int32),),
        True),
    Row("_cumsum_f32 (M,) f32 (ops.py:128)", None, "x_m_bits", lambda o, c: (_cumsum_f32(o.view(torch.float32)),),
        True),
    Row("searchsorted CAP queries in (M,) sorted int64", "searchsorted CAP queries in (M,) sorted", "mono64",
        lambda o, c: (torch.searchsorted(o, c["queries"]),), True),
    Row("segment max (M,32)->CAP by sorted ids (scatter_reduce amax)", "segment_max (M,32)->CAP sorted ids (XLA)",
        "mono64", lambda o, c: (c["segmax0"].scatter_reduce(0, o[:, None].expand(-1, 32), c["x_m32"], "amax"),),
        True),
)  # fmt: skip


def numpy_inputs(m: int = M, cap: int = CAP, seed: int = 0) -> dict:
    """The JAX tool's inputs, drawn in its order from one generator."""
    rng = np.random.default_rng(seed)
    out = dict(perm=rng.permutation(m).astype(np.int32), rand_ids=rng.integers(0, cap, m).astype(np.int32))
    out["mono_ids"] = np.sort(out["rand_ids"])
    out["key1"] = rng.integers(-(1 << 30), 1 << 30, m).astype(np.int32)
    out["key2"] = rng.integers(-(1 << 30), 1 << 30, m).astype(np.int32)
    out["fcols"] = [rng.normal(size=m).astype(np.float32) for _ in range(8)]  # drawn for JAX's payload rows
    out["x_m"] = rng.normal(size=(m,)).astype(np.float32)
    out["x_m8"] = rng.normal(size=(m, 8)).astype(np.float32)
    out["x_m32"] = rng.normal(size=(m, 32)).astype(np.float32)
    out["tab32"] = rng.normal(size=(cap, 32)).astype(np.float32)
    return out


def inputs(device, m: int = M, cap: int = CAP, seed: int = 0) -> dict:
    """Every row's operand and constant as tensors on ``device``."""
    a = numpy_inputs(m, cap, seed)
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items() if k != "fcols"}
    t.update(
        key64=t["key1"].to(torch.int64), key2col=torch.stack([t["key1"], t["key2"]], 1).to(torch.int64),
        perm64=t["perm"].to(torch.int64), mono64=t["mono_ids"].to(torch.int64),
        rand64=t["rand_ids"].to(torch.int64), x_m_bits=t["x_m"].view(torch.int32),
        A=torch.arange(m, dtype=torch.int32, device=device),
        ends0=torch.full((cap + 1,), -1, dtype=torch.int32, device=device),
        queries=torch.arange(cap, dtype=torch.int64, device=device),
        segmax0=torch.full((cap, 32), float("-inf"), device=device),
    )  # fmt: skip
    return t


def chained(row: Row, inp: dict, k: int):
    """A step applying ``row`` k times, each application's outputs fed back
    into its operand by an XOR of bit 0."""

    def step(cur):
        for _ in range(k):
            fb = torch.zeros((), dtype=torch.int32, device=cur.device)
            for leaf in row.apply(cur, inp):
                fb = fb ^ leaf.reshape(-1)[0].to(torch.int32)
            cur = cur ^ (fb & 1).to(cur.dtype)
        return cur

    return step


def time_step(step, operand, device, iters: int, repeats: int) -> float:
    """The smallest of ``repeats`` means of ms a step over ``iters``
    chained steps, after one warm-up step."""
    warm = Marks(device)
    step(operand)
    warm.mark()
    warm.ms()  # waits for the warm-up step
    best = float("inf")
    for _ in range(repeats):
        marks = Marks(device)
        cur = operand
        marks.mark()
        for _ in range(iters):
            cur = step(cur)
        marks.mark()
        best = min(best, marks.ms()[0] / iters)
    return best


def outputs(device, m: int = M, cap: int = CAP, seed: int = 0) -> dict:
    """``{row name: its outputs (on the CPU)}`` of one application to the
    rows' inputs."""
    inp = inputs(device, m, cap, seed)
    with torch.no_grad():
        return {row.name: tuple(t.cpu() for t in row.apply(inp[row.operand], inp)) for row in ROWS}


def run(iters=10, repeats=3, m=M, cap=CAP, device=None) -> list:
    """Prints the JSON lines of the module docstring; returns the rows."""
    device = resolve_device(device)
    inp = inputs(device, m, cap)
    setup = dict(m=m, cap=cap, iters=iters, repeats=repeats, device=str(device),
                 device_name=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")  # fmt: skip
    print(json.dumps(setup), flush=True)
    out = [setup]
    with torch.no_grad():
        for row in ROWS:
            t1, t3 = (time_step(chained(row, inp, k), inp[row.operand], device, iters, repeats) for k in (1, 3))
            out.append(dict(name=row.name, jax_row=row.jax_row, marginal_ms=(t3 - t1) / 2, t1_ms=t1, t3_ms=t3))
            print(json.dumps(out[-1]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--m", type=int, default=M, help="edges (default 2^19)")
    ap.add_argument("--cap", type=int, default=CAP, help="vertex rows (default 2^16)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    run(a.iters, a.repeats, a.m, a.cap, a.device)


if __name__ == "__main__":
    main()
