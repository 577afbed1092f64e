"""K1's semantics at the row widths its two card layouts split on.

The patch gather kernel (``csrc/patch_gather.cu``) copies rows of a multiple
of 16 bytes in one layout and every other row (odd widths, the ScanNet
head's 29 f32 channels, tables off a 16-byte boundary) in a staged one.
Here, on the CPU: the plain version the card run holds the kernel against
equals the JAX package bit for bit at those widths (its XLA formulation,
its Pallas kernel in interpret mode, and the head's row gather), with ids
equal to cap and negative; and the launch plan the wrapper hands the kernel
is sound for every width 1-512 in both dtypes: a 16-byte tile takes whole
queries, a staged tile fits the block's shared memory and spans a multiple
of 16 bytes of the output.

The JAX package never emits negative ids (its invalid id is ``cap``), and
its XLA gathers would clamp one to a row; the port reads a zero row for
any id outside [0, cap), so on the JAX side a negative id becomes ``cap``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.lattice import ops as jops
from lattice_net_tpu.ops_tpu import patch as jpatch
from lattice_net_tpu_torch.lattice import ops as tops
from lattice_net_tpu_torch.ops_cuda import patch as tpatch

CAP = Q = 256
K = 8
WIDTHS = [("float32", 1), ("float32", 13), ("float32", 29), ("bfloat16", 7), ("bfloat16", 29)]


def _monotone_ids(seed, q=Q, k=K, cap=CAP):
    """(Q, K) int32 columns nondecreasing over their valid ids (as the
    lattice's neighbour tables are), ~10% ids equal to cap and ~5% negative."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(np.clip(np.arange(q) + rng.integers(-8, 9, q), 0, cap - 1)) for _ in range(k)]
    ids = np.stack(cols, 1).astype(np.int32)
    ids[rng.random((q, k)) < 0.10] = cap
    ids[rng.random((q, k)) < 0.05] = -1 - rng.integers(0, 3)
    return ids


def _values(seed, dtype, c, cap=CAP):
    vals = np.random.default_rng(seed).normal(size=(cap, c)).astype(np.float32)
    return jnp.asarray(vals, getattr(jnp, dtype)), torch.from_numpy(vals).to(getattr(torch, dtype))


def _jax_ids(ids, cap=CAP):
    return jnp.asarray(np.where(ids < 0, cap, ids))


def _bits(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("include_center", [False, True])
@pytest.mark.parametrize("dtype,c", WIDTHS)
def test_plain_matches_xla_at_odd_widths(dtype, c, include_center):
    ids = _monotone_ids(c)
    vj, vt = _values(c + 1, dtype, c)
    ref = jops.gather_neighbor_values_xla(vj, _jax_ids(ids), include_center)
    got = tpatch.patch_gather_plain(vt, torch.from_numpy(ids), include_center)
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


@pytest.mark.parametrize(
    "dtype,c,include_center",
    [(d, c, center) for (d, c), center in zip(WIDTHS, [True, False, True, True, False])],
)
def test_plain_matches_pallas_interpret_at_odd_widths(dtype, c, include_center):
    ids = _monotone_ids(100 + c)
    vj, vt = _values(101 + c, dtype, c)
    w = jpatch.window_width(CAP, Q)
    jids, ws, ok, _ = jpatch._prepare(_jax_ids(ids), CAP, w)
    assert bool(ok), "the test table should be window-coverable"
    out = jpatch._patch_gather_pallas(vj.T, jids, ws, include_center, w, interpret=True)
    ref = out.transpose(2, 0, 1)[:Q]
    got = tpatch.patch_gather_plain(vt, torch.from_numpy(ids), include_center)
    np.testing.assert_array_equal(_bits(ref), got.float().numpy())


def test_head_gather_matches_at_29_channels():
    # the ScanNet head: (N, d+1) splat ids into the (cap, 8 + 21) f32 table
    rng = np.random.default_rng(29)
    vals = rng.normal(size=(CAP, 29)).astype(np.float32)
    idx = rng.integers(0, CAP, size=(1000, 4)).astype(np.int32)
    idx[::7, 1] = CAP
    idx[3::11, 2] = -1
    ref = jops.gather_rows_clustered(jnp.asarray(vals), _jax_ids(idx))
    got = tops.gather_rows_clustered(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_plain_row_offset_centre_at_odd_width():
    # a row block past the first appends values[row0 : row0 + Q] as its centre
    ids = _monotone_ids(7, q=64)
    _, vt = _values(8, "bfloat16", 7)
    vals = vt.float().numpy()
    valid = (ids >= 0) & (ids < CAP)
    want = np.where(valid[..., None], vals[np.where(valid, ids, 0)], 0.0)
    want = np.concatenate([want, vals[40:104, None]], 1)
    got = tpatch.patch_gather_plain(vt, torch.from_numpy(ids), True, row0=40)
    np.testing.assert_array_equal(want, got.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_every_width(dtype):
    esize = torch.tensor([], dtype=dtype).element_size()
    for c in range(1, 513):
        row = c * esize
        for k, center in ((4, False), (8, True), (9, False), (1, True)):
            kk = k + center
            for align in (512, 4 if esize == 4 else 2):
                plan = tpatch._plan(row, k, center, align)
                assert plan.smem_bytes <= tpatch.K1_SMEM_LIMIT, (c, k, plan)
                if row % 16 == 0 and align % 16 == 0:
                    # a tile of whole queries, about two chunks a thread
                    chunks = kk * (row // 16)
                    assert plan.word == 16 and plan.ids_off == plan.smem_bytes == 0, (c, plan)
                    n = plan.tile * chunks
                    fill = n / (-(-n // tpatch.K1_TILE_CHUNKS) * tpatch.K1_TILE_CHUNKS)
                    assert plan.tile >= 1 and (n <= 4 * tpatch.K1_TILE_CHUNKS or plan.tile == 1), (c, plan)
                    assert fill >= 0.8 or chunks > tpatch.K1_TILE_CHUNKS, (c, k, plan, fill)
                    continue
                w = plan.word
                assert w in (8, 4, 2) and row % w == 0 and align % w == 0, (c, plan)
                assert all(row % x or align % x for x in (16, 8, 4) if x > w), (c, plan)
                assert plan.tile >= 16 and plan.tile % 16 == 0, (c, plan)
                assert plan.tile * row % 16 == 0  # a full tile's span
                # the rows, then the ids of every query a tile touches, 16-byte aligned
                assert plan.ids_off % 16 == 0 and plan.tile * row <= plan.ids_off < plan.tile * row + 16
                assert plan.smem_bytes >= plan.ids_off + (plan.tile // kk + 2) * k * 4, (c, plan)


def test_check_returns_plan_and_raises_beyond_shared_memory():
    vals = torch.zeros(64, 29)
    nbr = torch.zeros(16, 4, dtype=torch.int32)
    assert tpatch._check(vals, nbr, False) == tpatch._plan(116, 4, False, 16)
    assert tpatch._check(vals[1:], nbr, False).word == 4  # 116 bytes past the start
    assert tpatch._check(torch.zeros(64, 32), nbr, True).word == 16
    off8 = torch.zeros(64 * 32 + 2)[2:].view(64, 32)  # 128-byte rows 8 bytes past the start
    assert tpatch._check(off8, nbr, True).word == 8
    with pytest.raises(ValueError, match="shared memory"):
        tpatch._check(torch.zeros(4, 4001), nbr, False)  # 16 staged rows need 256 KB
    wide_k = torch.zeros(2, 60_000, dtype=torch.int32)
    assert tpatch._check(torch.zeros(4, 4), wide_k, False).smem_bytes == 0  # 16-byte rows
    with pytest.raises(ValueError, match="shared memory"):
        tpatch._check(torch.zeros(4, 29), wide_k, False)  # the staged tile's ids
