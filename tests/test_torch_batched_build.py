"""The batched build's general branches and the canonical build at d > 3,
in the port vs the JAX package, on the CPU.

* ``static_general_branches()``: the build takes the general branch of
  every data-dependent fast path (coarse levels re-splat every point; the
  canonical build sorts every edge) with no host read; every table and the
  edge sort bit-equal to JAX's jitted build under its own
  ``static_general_branches()``, masked and unmasked, and equal to the
  port's default build where JAX's are (a masked build's invalid edge rows
  differ by JAX's rule, ``EdgeSort.perm``).
* ``make_loss_fn``: a batch of 3 clouds against JAX's vmapped loss (the
  loss to 1e-5, every gradient to 1e-4 relative L2, integer metrics
  exactly); ``force_vmap=True`` on a batch of one builds under the context.
* ``canonical_point_order`` and the canonical fast build at d = 4, 5, 6:
  the permutation and every table exactly.

JAX builds are jitted (10x faster than eager on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.data.synth_kitti import make_scene
from lattice_net_tpu.lattice import structure as js
from lattice_net_tpu.models import lnn as jlnn
from lattice_net_tpu.parallel import data_parallel as jdp
from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.lattice import structure as ts
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.parallel import data_parallel as tdp

torch.set_num_threads(2)

SIGMA, CAPS = 0.6, (8192, 4096, 2048)
LOSS_ATOL, GRAD_REL_L2 = 1e-5, 1e-4
MODEL = dict(
    nr_classes=5, values_mode="intensity", pointnet_channels_per_layer=(8,), pointnet_start_nr_channels=8,
    nr_downsamples=2, nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
)  # fmt: skip


def _leaves(h):
    """Every table of a hierarchy, in a fixed order."""
    out = [s.keys for s in h.structures] + [s.nr_verts for s in h.structures] + [s.nr_overflow for s in h.structures]
    out += list(h.neighbors_same) + list(h.neighbors_coarsen) + list(h.neighbors_finefy)
    return out + [h.splat_idx, h.splat_weights, h.edges.perm, h.edges.vertex, h.edges.ends]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(a, b, skip_weights=False):
    la, lb = _leaves(a), _leaves(b)
    for i, (x, y) in enumerate(zip(la, lb, strict=True)):
        if skip_weights and i == len(la) - 4:
            continue  # splat weights: JAX's jitted build rounds them (ROADMAP section 3)
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=str(i))


@functools.lru_cache(maxsize=None)
def _scan(n=2048, seed=4):
    return np.asarray(make_scene(n, seed=seed, max_range=20.0).V, np.float32)


CASES = {"unmasked": None, "masked": 1700}


@pytest.mark.parametrize("case", list(CASES))
def test_static_general_branches_bit_identical_to_jax(case):
    pos = _scan()
    n_real = CASES[case]
    mask = None if n_real is None else np.arange(len(pos)) < n_real
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    with js.static_general_branches():
        hj = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=2, capacities=CAPS))(
            jnp.asarray(pos), point_mask=jmask
        )  # fmt: skip
    with ts.static_general_branches():
        ht = ts.build_hierarchy(torch.from_numpy(pos), SIGMA, 2, CAPS, point_mask=tmask)
    _assert_equal(hj, ht, skip_weights=True)
    # the default build's tables are the same; so is its edge sort where
    # JAX's folded sort leaves the edge index of invalid rows alone
    hd = ts.build_hierarchy(torch.from_numpy(pos), SIGMA, 2, CAPS, point_mask=tmask)
    for i, (x, y) in enumerate(zip(_leaves(ht), _leaves(hd), strict=True)):
        if i == len(_leaves(ht)) - 3 and mask is not None:
            valid = ht.edges.vertex < CAPS[0]
            np.testing.assert_array_equal(x[valid].numpy(), y[valid].numpy())
            assert (y[~valid] == 0).all() and not (x[~valid] == 0).all()
            continue
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=str(i))


def test_static_general_branches_reads_no_overflow(monkeypatch):
    pos = torch.from_numpy(_scan(1024))
    perm = ts.canonical_point_order(pos, SIGMA)

    def refuse(t):
        raise AssertionError("the build read an overflow count back to the host")

    monkeypatch.setattr(ts, "_read_count", refuse)
    with ts.static_general_branches():
        assert ts._STATIC_GENERAL.get()
        ts.build_hierarchy(pos, SIGMA, 2, CAPS)
        ts.build_hierarchy(pos[perm], SIGMA, 2, CAPS, canonical_points=True)
    assert not ts._STATIC_GENERAL.get()
    with pytest.raises(AssertionError, match="host"):
        ts.build_hierarchy(pos, SIGMA, 2, CAPS)  # the fast path reads it
    with pytest.raises(AssertionError, match="host"):
        ts.build_hierarchy(pos[perm], SIGMA, 2, CAPS, canonical_points=True)


def _clouds(b):
    mp = jlnn.ModelParams(**MODEL)
    out = []
    for s in range(b):
        c = make_scene(700 + 150 * s, seed=20 + s, max_range=20.0)
        pos, vals, tgt = jlnn.prepare_cloud(c, mp)
        out.append((pos, vals, tgt % MODEL["nr_classes"]))
    return out


@pytest.fixture(scope="module")
def batch3():
    clouds = _clouds(3)
    batch = jdp.make_batch(clouds, None, 1024, rng=np.random.default_rng(0))
    model = jlnn.LNN(jlnn.ModelParams(**MODEL))
    b0 = {k: v[0] for k, v in batch.items()}
    hj = jax.jit(functools.partial(js.build_hierarchy, sigma=SIGMA, nr_levels=2, capacities=CAPS))(
        b0["positions"], point_mask=b0["point_mask"], point_feats=b0["values"]
    )  # fmt: skip
    params = jax.jit(model.init)(jax.random.PRNGKey(0), hj, b0["positions"], b0["values"])
    lf = jdp.make_loss_fn(model, SIGMA, 2, CAPS)  # b = 3: vmapped under static_general_branches
    (loss, metrics), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params, batch, jax.random.PRNGKey(1))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(batch=as_np(batch), params=as_np(params), loss=float(loss), metrics=as_np(metrics),
                grads=as_np(grads))  # fmt: skip


def test_batch_of_three_matches_jax_vmapped_loss(batch3, monkeypatch):
    model = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
                     conv_dtype=torch.float32)  # fmt: skip
    model.load_state_dict(params_from_flax(batch3["params"]))
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch3["batch"].items()}
    monkeypatch.setattr(ts, "_read_count", lambda t: pytest.fail("a batch of 3 read an overflow count"))
    loss_fn = tdp.make_loss_fn(model, SIGMA, 2, CAPS)
    leaves, loss, metrics = tdp.forward_loss(loss_fn, model.state_dict(), batch)
    grads = tdp.gradients(loss, leaves)
    assert abs(loss.item() - batch3["loss"]) <= LOSS_ATOL
    for k in ("iou_intersection", "iou_union"):
        np.testing.assert_array_equal(metrics[k].numpy(), batch3["metrics"][k], err_msg=k)
    np.testing.assert_allclose(float(metrics["nr_verts_mean"]), float(batch3["metrics"]["nr_verts_mean"]), rtol=1e-6)
    want = {k: v.numpy() for k, v in params_from_flax(batch3["grads"]).items()}
    errs = {k: np.linalg.norm(grads[k].numpy() - w) / max(np.linalg.norm(w), 1e-30) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def test_force_vmap_builds_a_batch_of_one_under_the_context(monkeypatch):
    model = tlnn.LNN(tlnn.ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu",
                     conv_dtype=torch.float32)  # fmt: skip
    batch = tdp.make_batch(_clouds(1), 1024, rng=np.random.default_rng(0), device="cpu")
    reads = []
    monkeypatch.setattr(ts, "_read_count", lambda t: reads.append(int(t)) or int(t))
    params = model.state_dict()
    with torch.no_grad():
        fast, _ = tdp.make_loss_fn(model, SIGMA, 2, CAPS)(params, batch)
        assert len(reads) == 1  # the simplex reps' overflow
        vmapped, _ = tdp.make_loss_fn(model, SIGMA, 2, CAPS, force_vmap=True)(params, batch)
    assert len(reads) == 1
    assert torch.equal(fast, vmapped)


@pytest.mark.parametrize("d", [4, 5, 6])
def test_canonical_order_and_fast_build_match_jax_at_d_gt_3(d):
    rng = np.random.default_rng(10 + d)
    pos = rng.uniform(-1.5, 1.5, size=(1024, d)).astype(np.float32)
    mask = rng.random(1024) > 0.15
    order_j = np.asarray(js.canonical_point_order(jnp.asarray(pos), 0.4, jnp.asarray(mask)))
    order_t = ts.canonical_point_order(torch.from_numpy(pos), 0.4, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(order_t, order_j)
    pos_c, mask_c = pos[order_j], mask[order_j]
    caps = (4096, 2048, 1024)
    build = functools.partial(js.build_hierarchy, sigma=0.4, nr_levels=2, capacities=caps, canonical_points=True)
    hj = jax.jit(build)(jnp.asarray(pos_c), point_mask=jnp.asarray(mask_c))
    ht = ts.build_hierarchy(torch.from_numpy(pos_c), 0.4, 2, caps, point_mask=torch.from_numpy(mask_c),
                            canonical_points=True)  # fmt: skip
    _assert_equal(hj, ht, skip_weights=True)
