"""The port against the JAX package at each side of JAX's A/B switches, on
the CPU.  The port has one formulation where JAX has two; JAX's switches
pick its side.

* ``LNT_INVPERM_SORT``, ``LNT_ENDS_SORT``, ``LNT_MERGE_FF`` (JAX reads them
  once at import, so its module constants are patched before a fresh
  trace): every table of a hierarchy, unmasked for the inverse permutation
  (JAX's sort runs there only), masked for the others, at d = 3 (one key
  column) and d = 4 (two: JAX's merged lookup against the port's binary
  search), bit-equal to the port's one build at either value.
* ``LNT_FLIP_VJP``: the value and weight gradients of a same-level conv and
  of the coarsen and finefy convs, with their paired tables (the port's
  flip-neighbours adjoint), against ``jax.grad`` at either value (values
  1e-5; weights 1e-5 relative L2, an f32 sum over the rows); JAX's "0" runs
  its scatter adjoint.
* The seven switches whose second side the port dropped appear nowhere in
  the port or in ``chip_smoke.py``.
* ``LNT_FAST_OPS``: the three gathers' values against JAX's at the same
  value, the plain route under "0" (the wrappers are called with
  ``plain=True``), and the CLIs' conv dtype against JAX's policy for every
  pair of ``LNT_FAST_OPS`` and ``LNT_CONV_DTYPE``.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.lattice import structure as ts

torch.set_num_threads(2)

SIGMA, CAPS = 0.6, (4096, 2048, 1024)
SWITCHES = {"LNT_INVPERM_SORT": "_INVPERM_SORT", "LNT_ENDS_SORT": "_ENDS_SORT", "LNT_MERGE_FF": "_MERGE_FF"}
RETIRED = ("LNT_ENDS_SORT", "LNT_INVPERM_SORT", "LNT_MERGED_LOOKUP", "LNT_CARRY_FEATS", "LNT_FLIP_VJP", "LNT_LOVASZ",
           "LNT_HEAD_PRECLASSIFY")  # fmt: skip
ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _cloud(d, n=1024):
    c = make_scene(n, seed=7, max_range=15.0)
    pos = np.concatenate([c.V, c.I], axis=1)[:, :d].astype(np.float32)
    return pos, np.arange(n) < n - 100


def _tables(h):
    out = [s.keys for s in h.structures] + [s.nr_verts for s in h.structures]
    out += list(h.neighbors_same) + list(h.neighbors_coarsen) + list(h.neighbors_finefy)
    return out + [h.splat_idx, h.edges.perm, h.edges.vertex, h.edges.ends]


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("d", [3, 4])
def test_build_switch_matches_jax(d, switch, value, monkeypatch):
    pos, mask = _cloud(d)
    monkeypatch.setattr(js, SWITCHES[switch], value == "1")
    # JAX's sort-based inverse permutation runs for unmasked builds only
    for m in (None,) if switch == "LNT_INVPERM_SORT" else (mask,):
        # a fresh function: JAX reads the constant when it traces
        build = jax.jit(lambda p, pm: js.build_hierarchy(p, SIGMA, 2, CAPS, point_mask=pm))
        hj = build(jnp.asarray(pos), None if m is None else jnp.asarray(m))
        ht = ts.build_hierarchy(torch.from_numpy(pos), SIGMA, 2, CAPS,
                                point_mask=None if m is None else torch.from_numpy(m))  # fmt: skip
        for i, (a, b) in enumerate(zip(_tables(hj), _tables(ht), strict=True)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{switch}={value} table {i}")


@pytest.fixture(scope="module")
def hier():
    pos, _ = _cloud(3)
    hj = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=2, capacities=CAPS))(jnp.asarray(pos))
    return hj, ts.build_hierarchy(torch.from_numpy(pos), SIGMA, 2, CAPS)


CONVS = {"same": (0, True), "coarsen": (0, False), "finefy": (1, False)}


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("kind", list(CONVS))
def test_flip_vjp_matches_jax(hier, kind, value, monkeypatch):
    hj, ht = hier
    monkeypatch.setenv("LNT_FLIP_VJP", value)  # JAX reads it at each call
    monkeypatch.setenv("LNT_FAST_OPS", "0")  # JAX on the CPU: f32, its XLA gathers
    lvl, same = CONVS[kind]
    if kind == "same":
        nj, ntj, nt, ntt = hj.neighbors_same[0], None, ht.neighbors_same[0], None
    elif kind == "coarsen":
        nj, ntj, nt, ntt = hj.neighbors_coarsen[0], hj.neighbors_finefy[0], ht.neighbors_coarsen[0], ht.neighbors_finefy[0]
    else:
        nj, ntj, nt, ntt = hj.neighbors_finefy[0], hj.neighbors_coarsen[0], ht.neighbors_finefy[0], ht.neighbors_coarsen[0]
    cap_src = CAPS[lvl]
    extent = nt.shape[1] + (1 if same else 0)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(cap_src, 6)).astype(np.float32)
    w = (rng.normal(size=(extent * 6, 5)) * 0.2).astype(np.float32)
    g = rng.normal(size=(nt.shape[0], 5)).astype(np.float32)

    def f(vv, ww):
        return jnp.sum(jops.conv_im2row(vv, nj, ww, same, neighbors_t=ntj) * g)

    dv_j, dw_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(w))
    vt, wt = torch.from_numpy(v).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = tops.conv_im2row(vt, nt, wt, same, torch.float32, neighbors_t=ntt)
    dv_t, dw_t = torch.autograd.grad(out, (vt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), rtol=1e-5, atol=1e-5)
    # the weight gradient sums thousands of f32 rows in another order: L2
    assert np.linalg.norm(dw_t.numpy() - np.asarray(dw_j)) <= 1e-5 * np.linalg.norm(np.asarray(dw_j))


@pytest.mark.parametrize("name", RETIRED)
def test_retired_switch_is_not_read(name):
    sources = sorted((ROOT / "lattice_net_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert not [p.relative_to(ROOT) for p in sources if name in p.read_text()]


@pytest.mark.parametrize("value", ["0", "1"])
def test_fast_ops_gathers_match_jax(hier, value, monkeypatch):
    hj, ht = hier
    monkeypatch.setenv("LNT_FAST_OPS", value)
    calls = []

    def spy(fn):
        def call(*args, plain=False, **kw):
            calls.append(plain)
            return fn(*args, plain=plain, **kw)

        return call

    monkeypatch.setattr(tops, "patch_gather", spy(tops.patch_gather))
    monkeypatch.setattr(tops, "take_rows", spy(tops.take_rows))
    rng = np.random.default_rng(4)
    v = rng.normal(size=(CAPS[0], 7)).astype(np.float32)
    vt = torch.from_numpy(v)
    nbr_j, nbr_t = hj.neighbors_same[0], ht.neighbors_same[0]
    cases = [
        (jops.gather_rows(jnp.asarray(v), nbr_j), tops.gather_rows(vt, nbr_t)),
        (jops.gather_neighbor_values(jnp.asarray(v), nbr_j, True), tops.gather_neighbor_values(vt, nbr_t, True)),
        (jops.gather_rows_clustered(jnp.asarray(v), hj.splat_idx), tops.gather_rows_clustered(vt, ht.splat_idx)),
    ]
    for want, got in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == [value == "0"] * 3


@pytest.mark.parametrize("conv_dtype", [None, "f32", "bf16"])
@pytest.mark.parametrize("fast_ops", [None, "0", "1"])
def test_conv_dtype_policy_matches_jax(fast_ops, conv_dtype, monkeypatch):
    for name, value in (("LNT_FAST_OPS", fast_ops), ("LNT_CONV_DTYPE", conv_dtype)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    want = jops._maybe_bf16(jnp.zeros((2, 2), jnp.float32)).dtype  # JAX on the CPU
    assert tops.default_conv_dtype("cpu") == {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(want)]
    # on the card the fast ops run unless LNT_FAST_OPS=0
    card = tops.default_conv_dtype("cuda")
    expect = conv_dtype == "bf16" or (conv_dtype != "f32" and fast_ops != "0")
    assert card == (torch.bfloat16 if expect else torch.float32)
