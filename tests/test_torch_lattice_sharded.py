"""The port's lattice-sharded mode against the JAX package's on the same
mesh shape, on the CPU.

The JAX side runs ``make_sharded_*`` and ``make_hybrid_lnn_train_step`` on
2 or 4 of conftest's virtual devices; the port's runs in as many gloo ranks
(``mesh.launch``), one launch of 2 ranks and one of 4.  Both get the same
numpy clouds and the same weights (the flax init, ``params_from_flax``), f32
convs, a one-downsample model (its JAX compiles are the file's cost).  The
cloud is a corridor 120 units long at sigma 0.5 (stripes of 138 elev0 units
or more at 4 shards, over the model's 56-unit receptive band), the JAX dry
run's hybrid clouds.

* splat-conv-slice (two convs) and the LNN forward at sp = 2 and 4: each
  rank's outputs within 1e-4 of JAX's stripe, equal labels, equal
  ``nr_verts`` and overflow; the forward against the port's single-device
  forward with the JAX package's own gates (median error < 1e-3, labels >
  0.995: a sharded run sums the local means over another edge order, so
  near-tied max-pool winners flip), and the share of points beyond 2e-3
  within a point of JAX's own share on this cloud (JAX's gate, 5%, is met
  by its denser test cloud; this one reads 4-6% in either package).
* one sharded train step (sp = 2) and one hybrid dp2 x sp2 step: loss within
  1e-5 of JAX's, every gradient within 1e-4 (relative L2); with
  ``remat_blocks`` the sharded step's gradients within 1e-5 of its own (the
  recompute in the backward re-enters the distributed norm); the sharded
  gradients' norm against the single-device gradient of the whole cloud is
  printed (the per-stripe Lovász half makes them differ a little; a psum
  counted twice would make them n-fold).
* on a 4096-point KITTI-like scan (``make_scene``) JAX's sharded forward
  misses its own median and 5% gates against its single-device forward (the
  reference caveat of ROADMAP §3), and the port's forward is JAX's there too.
* both steps' ``plain=True`` gives the same gradients on the CPU, where
  every kernel wrapper runs its plain version.
* a batch whose stripes or clouds differ from the mesh raises, and so does a
  stripe narrower than the receptive band, unless ``check_band=False``.

The spawned ranks import this module, so JAX is imported inside the
reference fixture only.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.interop import params_from_flax
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams
from lattice_net_tpu_torch.parallel import lattice_sharded as tls
from lattice_net_tpu_torch.parallel import mesh as tmesh
from lattice_net_tpu_torch.parallel.data_parallel import TrainState, forward_loss, gradients, make_loss_fn
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

LOGP_ATOL, LOSS_ATOL, GRAD_REL_L2 = 1e-4, 1e-5, 1e-4
MODEL = dict(
    nr_classes=5, pointnet_channels_per_layer=(8, 8), pointnet_start_nr_channels=8, nr_downsamples=1,
    nr_blocks_down_stage=(1,), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1,),
    nr_levels_down_with_normal_resnet=1, nr_levels_up_with_normal_resnet=1,
)  # fmt: skip
SIGMA, CAPS_LOCAL, CAPS_FULL, N = 0.5, (4096, 2048), (8192, 4096), 1024
SCS_CAP, SCS_CONVS, SCS_C = 2048, 2, 4  # splat-conv-slice: the stripes together outgrow one table
LR, IGNORE = 1e-2, 0
KITTI_N, KITTI_SIGMA, KITTI_CAPS = 4096, 0.6, (16384, 8192)  # a KITTI-like scan (make_scene)


def _cloud(seed):
    r = np.random.default_rng(seed)
    p = np.stack([r.uniform(-60, 60, N), r.uniform(-1, 1, N), r.uniform(-1, 1, N)], 1).astype(np.float32)
    v = np.zeros((N, 1), np.float32)
    return p, v, (p[:, 0] > 0).astype(np.int32) + 1


def _kitti_scan():
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud

    p, v, _ = prepare_cloud(make_scene(KITTI_N, seed=0), ModelParams(**MODEL))
    return p, v


def _scs_inputs():
    r = np.random.default_rng(7)
    vals = r.normal(size=(N, SCS_C)).astype(np.float32)
    extent = 9
    weights = [(r.normal(size=(extent * SCS_C, SCS_C)) * 0.1).astype(np.float32) for _ in range(SCS_CONVS)]
    return vals, weights


def _port_model(params_np):
    model = LNN(ModelParams(**MODEL), torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params_np.items()})
    return model


def _striped(cloud, sp, per=None):
    p, v, t = cloud
    pos_s, val_s, mask_s, ids_s, bounds = tls.shard_points_host(p, v, SIGMA, sp, per)
    tgt_s = np.where(ids_s >= 0, t[np.clip(ids_s, 0, None)], IGNORE).astype(np.int32)
    return pos_s, val_s, tgt_s, mask_s, ids_s, bounds


def _raises(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as exc:
        return str(exc)
    return ""


def _rank_sharded(device, world, params_np):
    """Everything the port computes in one launch of ``world`` ranks."""
    out = {}
    mesh = tmesh.Mesh(("sp",), (world,))
    model = _port_model(params_np)
    params = dict(model.state_dict())
    cloud = _cloud(0)
    pos_s, val_s, tgt_s, mask_s, ids_s, bounds = _striped(cloud, world)
    per = pos_s.shape[1]

    vals, weights = _scs_inputs()
    spos, sval, smask, _, sbounds = tls.shard_points_host(cloud[0], vals, SIGMA, world)
    scs = tls.make_sharded_splat_conv_slice(mesh, SIGMA, SCS_CAP, per, nr_convs=SCS_CONVS)
    with torch.no_grad():
        out["scs"] = scs(spos, sval, smask, sbounds, weights)
    out["fwd"] = tls.make_sharded_lnn_forward(mesh, model, SIGMA, 1, CAPS_LOCAL, per)(
        params, pos_s, val_s, mask_s, bounds
    )
    tx = to.make_optimizer(LR)
    state = TrainState.create(params, tx)
    if world == 2:
        kp, kv = _kitti_scan()
        k_s = tls.shard_points_host(kp, kv, KITTI_SIGMA, world)
        out["kitti"] = tls.make_sharded_lnn_forward(mesh, model, KITTI_SIGMA, 1, KITTI_CAPS, k_s[0].shape[1])(
            params, k_s[0], k_s[1], k_s[2], k_s[4]
        )
        cap = to.CapturingOptimizer(tx)
        step = tls.make_sharded_lnn_train_step(mesh, model, cap, SIGMA, 1, CAPS_LOCAL, per, ignore_index=IGNORE)
        new, metrics = step(state, pos_s, val_s, tgt_s, mask_s, bounds)
        out["step"] = (metrics, cap.grads[-1], new.params)
        plain_new, _ = step(state, pos_s, val_s, tgt_s, mask_s, bounds, plain=True)
        out["step_plain"] = (cap.grads[-1], plain_new.params)
        # remat_blocks: the recompute in the backward re-enters the forward's distributed norm
        remat = LNN(dataclasses.replace(model.params, remat_blocks=True), torch.Generator(), device="cpu",
                    conv_dtype=torch.float32)  # fmt: skip
        rstep = tls.make_sharded_lnn_train_step(mesh, remat, cap, SIGMA, 1, CAPS_LOCAL, per, ignore_index=IGNORE)
        rstep(state, pos_s, val_s, tgt_s, mask_s, bounds)
        out["remat_grads"] = cap.grads[-1]
        out["mismatch"] = _raises(step, state, *(np.concatenate([a, a[:1]]) for a in (pos_s, val_s, tgt_s, mask_s)),
                                  bounds)  # fmt: skip
        return out
    # hybrid dp2 x sp2 over the same 4 ranks
    mesh2 = tmesh.Mesh(("dp", "sp"), (2, 2))
    clouds = [_cloud(1), _cloud(2)]
    pos_b, val_b, tgt_b, mask_b, _, bounds_b = tls.shard_clouds_host(clouds, SIGMA, 2, ignore_index=IGNORE)
    cap = to.CapturingOptimizer(tx)
    hstep = tls.make_hybrid_lnn_train_step(mesh2, model, cap, SIGMA, 1, CAPS_LOCAL, pos_b.shape[2],
                                           ignore_index=IGNORE)  # fmt: skip
    new, metrics = hstep(state, pos_b, val_b, tgt_b, mask_b, bounds_b)
    out["hybrid"] = (metrics, cap.grads[-1])
    hstep(state, pos_b, val_b, tgt_b, mask_b, bounds_b, plain=True)
    out["hybrid_plain"] = cap.grads[-1]
    out["hybrid_mismatch"] = _raises(hstep, state, *(np.concatenate([a, a]) for a in (pos_b, val_b, tgt_b, mask_b)),
                                     np.concatenate([bounds_b, bounds_b]))  # fmt: skip
    # a dense cloud: stripes narrower than the band
    r = np.random.default_rng(4)
    dense = r.uniform(-2, 2, (512, 3)).astype(np.float32)
    d_s = tls.shard_points_host(dense, np.zeros((512, 1), np.float32), 0.15, world)
    caps = (2048, 1024)
    strict = tls.make_sharded_lnn_forward(mesh, model, 0.15, 1, caps, d_s[0].shape[1])
    out["band"] = _raises(strict, params, d_s[0], d_s[1], d_s[2], d_s[4])
    approx = tls.make_sharded_lnn_forward(mesh, model, 0.15, 1, caps, d_s[0].shape[1], check_band=False)
    out["approx"] = approx(params, d_s[0], d_s[1], d_s[2], d_s[4])
    return out


@pytest.fixture(scope="module")
def flax_init():
    """The JAX model and its flax init on the corridor cloud."""
    import jax
    import jax.numpy as jnp

    from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
    from lattice_net_tpu.models import LNN as JLNN, ModelParams as JModelParams

    p, v, _ = _cloud(0)
    model = JLNN(JModelParams(**MODEL))
    h = jax.jit(lambda p, v: jbuild(p, SIGMA, 1, CAPS_FULL, point_feats=v))(jnp.asarray(p), jnp.asarray(v))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), h, jnp.asarray(p), jnp.asarray(v))
    numpy_params = {k: x.numpy() for k, x in params_from_flax(jax.tree.map(np.asarray, params)).items()}
    return model, params, h, numpy_params


@pytest.fixture(scope="module")
def port_runs(flax_init):
    """The port's two launches, started in the background: their ranks are
    processes, so they run while the JAX reference compiles."""
    def run():
        params = flax_init[3]
        return {w: tmesh.launch(_rank_sharded, w, params, ranks=tmesh.plan_ranks(w, "cpu")) for w in (2, 4)}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.fixture(scope="module")
def jax_ref(flax_init, port_runs):
    """The JAX package's runs, on its virtual CPU devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from lattice_net_tpu.lattice.structure import build_hierarchy as jbuild
    from lattice_net_tpu.parallel import lattice_sharded as jls
    from lattice_net_tpu.parallel.data_parallel import TrainState as JTrainState
    from lattice_net_tpu.train import make_optimizer

    model, params, h, numpy_params = flax_init
    p, v, _ = _cloud(0)
    capture = optax.GradientTransformation(
        lambda ps: jax.tree.map(jnp.zeros_like, ps), lambda g, s, ps=None: (g, g)
    )
    tx = optax.chain(capture, make_optimizer(LR))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    def grads_of(state):
        return {k: x.numpy() for k, x in params_from_flax(as_np(state.opt_state[0])).items()}

    ref = {"params": numpy_params}
    ref["single"] = np.asarray(jax.jit(model.apply)(params, h, jnp.asarray(p), jnp.asarray(v))[0])
    vals, weights = _scs_inputs()
    for sp in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
        pos_s, val_s, tgt_s, mask_s, _, bounds = _striped(_cloud(0), sp)
        spos, sval, smask, _, sbounds = jls.shard_points_host(p, vals, SIGMA, sp)
        scs = jls.make_sharded_splat_conv_slice(mesh, SIGMA, SCS_CAP, pos_s.shape[1], nr_convs=SCS_CONVS)
        ref[f"scs{sp}"] = as_np(scs(spos, sval, smask, sbounds, tuple(jnp.asarray(w) for w in weights)))
        fwd = jls.make_sharded_lnn_forward(mesh, model, SIGMA, 1, CAPS_LOCAL, pos_s.shape[1])
        ref[f"fwd{sp}"] = as_np(fwd(params, pos_s, val_s, mask_s, bounds))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    kp, kv = _kitti_scan()
    kh = jax.jit(lambda p, v: jbuild(p, KITTI_SIGMA, 1, KITTI_CAPS, point_feats=v))(jnp.asarray(kp), jnp.asarray(kv))
    ref["kitti_single"] = np.asarray(jax.jit(model.apply)(params, kh, jnp.asarray(kp), jnp.asarray(kv))[0])
    k_s = jls.shard_points_host(kp, kv, KITTI_SIGMA, 2)
    kfwd = jls.make_sharded_lnn_forward(mesh, model, KITTI_SIGMA, 1, KITTI_CAPS, k_s[0].shape[1])
    ref["kitti"] = as_np(kfwd(params, k_s[0], k_s[1], k_s[2], k_s[4]))
    pos_s, val_s, tgt_s, mask_s, _, bounds = _striped(_cloud(0), 2)
    step = jls.make_sharded_lnn_train_step(mesh, model, tx, SIGMA, 1, CAPS_LOCAL, pos_s.shape[1],
                                           ignore_index=IGNORE)  # fmt: skip
    new, metrics = step(JTrainState.create(params, tx), pos_s, val_s, tgt_s, mask_s, bounds)
    ref["step"] = (as_np(metrics), grads_of(new))
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    pos_b, val_b, tgt_b, mask_b, _, bounds_b = jls.shard_clouds_host([_cloud(1), _cloud(2)], SIGMA, 2,
                                                                      ignore_index=IGNORE)  # fmt: skip
    hstep = jls.make_hybrid_lnn_train_step(mesh2, model, tx, SIGMA, 1, CAPS_LOCAL, pos_b.shape[2],
                                           ignore_index=IGNORE)  # fmt: skip
    new, metrics = hstep(JTrainState.create(params, tx), pos_b, val_b, tgt_b, mask_b, bounds_b)
    ref["hybrid"] = (as_np(metrics), grads_of(new))
    return ref


@pytest.fixture(scope="module")
def port(port_runs, jax_ref):
    return port_runs.result()


def test_host_striping_is_byte_equal_to_jax():
    from lattice_net_tpu.parallel import lattice_sharded as jls

    for sp, per in ((2, None), (4, None), (4, 300)):
        p, v, _ = _cloud(5)
        want = [np.asarray(x) for x in jls.shard_points_host(p, v, SIGMA, sp, per)]
        got = tls.shard_points_host(p, v, SIGMA, sp, per)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    clouds = [_cloud(1), (lambda c: (c[0][:400], c[1][:400], c[2][:400]))(_cloud(2))]
    want = [np.asarray(x) for x in jls.shard_clouds_host(clouds, SIGMA, 4, ignore_index=IGNORE)]
    got = tls.shard_clouds_host(clouds, SIGMA, 4, ignore_index=IGNORE)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    with pytest.raises(ValueError, match="cannot hold"):
        tls.shard_points_host(p, v, SIGMA, 4, per=10)


def test_receptive_band_and_capacity_checks_match_jax():
    from lattice_net_tpu.models import ModelParams as JModelParams
    from lattice_net_tpu.parallel import lattice_sharded as jls

    for kw in ({}, MODEL, dict(MODEL, nr_downsamples=3, nr_blocks_down_stage=(2, 1, 1),
                                   nr_blocks_up_stage=(1, 2, 1), nr_levels_up_with_normal_resnet=1)):
        assert tls.receptive_band_units(ModelParams(**kw), 3) == jls.receptive_band_units(JModelParams(**kw), 3)
    with pytest.raises(ValueError, match="distinct"):
        tls._check_caps_distinct((512, 256, 256))


@pytest.mark.parametrize("sp", [2, 4])
def test_splat_conv_slice_matches_jax(port, jax_ref, sp):
    out_j, nv_j, ov_j = jax_ref[f"scs{sp}"]
    for r, rank in enumerate(port[sp]):
        out, nv, ov = rank["scs"]
        np.testing.assert_allclose(out, out_j[r], rtol=0, atol=LOGP_ATOL, err_msg=f"rank {r}")
        assert (int(nv), int(ov)) == (int(nv_j[r]), int(ov_j[r]))
    assert int(ov_j.sum()) == 0 and int(nv_j.sum()) > SCS_CAP  # the stripes together outgrow one table


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_forward_matches_jax_and_the_single_device_forward(port, jax_ref, sp):
    logp_j, nv_j, ov_j = jax_ref[f"fwd{sp}"]
    _, _, _, _, ids_s, _ = _striped(_cloud(0), sp)
    got = np.zeros((N, MODEL["nr_classes"]), np.float32)
    for r, rank in enumerate(port[sp]):
        logp, nv, ov = rank["fwd"]
        np.testing.assert_allclose(logp, logp_j[r], rtol=0, atol=LOGP_ATOL, err_msg=f"rank {r}")
        valid = ids_s[r] >= 0
        np.testing.assert_array_equal(logp[valid].argmax(1), logp_j[r][valid].argmax(1))
        assert (int(nv), int(ov)) == (int(nv_j[r]), int(ov_j[r])) and int(ov) == 0
        got[ids_s[r][valid]] = logp[valid]
    # against one device holding the whole cloud: the JAX package's gates on
    # the median and the labels; the share of points beyond 2e-3 (JAX's gate:
    # 5%) is this cloud's, so the port's must be JAX's own share here
    p, v, _ = _cloud(0)
    model = _port_model(jax_ref["params"])
    pt, vt = torch.from_numpy(p), torch.from_numpy(v)
    with torch.no_grad():
        ref, _ = model(build_hierarchy(pt, SIGMA, 1, CAPS_FULL, point_feats=vt), pt, vt, train=False)
    err = np.abs(got - ref.numpy()).max(axis=1)
    jax_got = np.zeros_like(got)
    for r in range(sp):
        valid = ids_s[r] >= 0
        jax_got[ids_s[r][valid]] = logp_j[r][valid]
    jax_loose = float((np.abs(jax_got - jax_ref["single"]).max(axis=1) > 2e-3).mean())
    loose = float((err > 2e-3).mean())
    print(f"sp={sp}: median error {np.median(err):.3g}, beyond 2e-3 {loose:.4f} "
          f"(JAX on its own forward {jax_loose:.4f})")  # fmt: skip
    assert np.median(err) < 1e-3 and abs(loose - jax_loose) <= 0.01
    assert float((got.argmax(1) == ref.numpy().argmax(1)).mean()) > 0.995


def _gate_numbers(got, ref):
    err = np.abs(got - ref).max(axis=1)
    return float(np.median(err)), float((err > 2e-3).mean()), float((got.argmax(1) == ref.argmax(1)).mean())


def test_on_a_kitti_scan_both_packages_miss_the_jax_gates_alike(port, jax_ref):
    # the reference caveat (ROADMAP §3): on a KITTI-like scan each stripe's
    # local-mean prefix sum runs over another edge stream and PointNet's
    # max-pool winners flip, so JAX's sharded forward misses its own gates
    # against its single-device forward; the port's sharded forward is JAX's
    logp_j, nv_j, ov_j = jax_ref["kitti"]
    kp, kv = _kitti_scan()
    ids_s = tls.shard_points_host(kp, kv, KITTI_SIGMA, 2)[3]
    got, jax_got = (np.zeros((KITTI_N, MODEL["nr_classes"]), np.float32) for _ in range(2))
    for r, rank in enumerate(port[2]):
        logp, nv, ov = rank["kitti"]
        np.testing.assert_allclose(logp, logp_j[r], rtol=0, atol=LOGP_ATOL, err_msg=f"rank {r}")
        assert (int(nv), int(ov)) == (int(nv_j[r]), int(ov_j[r])) and int(ov) == 0
        valid = ids_s[r] >= 0
        got[ids_s[r][valid]], jax_got[ids_s[r][valid]] = logp[valid], logp_j[r][valid]
    median, loose, agree = _gate_numbers(jax_got, jax_ref["kitti_single"])
    print(f"JAX sharded vs single device on a {KITTI_N}-point KITTI scan: median {median:.3g}, "
          f"beyond 2e-3 {loose:.4f}, labels {agree:.4f}")  # fmt: skip
    assert median > 1e-3 and loose > 0.05  # JAX's gates: median < 1e-3, < 5% beyond 2e-3 (labels > 0.995)
    model = _port_model(jax_ref["params"])
    pt, vt = torch.from_numpy(kp), torch.from_numpy(kv)
    with torch.no_grad():
        ref, _ = model(build_hierarchy(pt, KITTI_SIGMA, 1, KITTI_CAPS, point_feats=vt), pt, vt, train=False)
    p_median, p_loose, p_agree = _gate_numbers(got, ref.numpy())
    assert abs(p_loose - loose) <= 0.02 and abs(p_agree - agree) <= 0.005 and p_median > 1e-3


def _grad_rel(got, want):
    return max(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30) for k, w in want.items())


def test_sharded_train_step_matches_jax(port, jax_ref):
    m_j, g_j = jax_ref["step"]
    for r, rank in enumerate(port[2]):
        metrics, grads, _ = rank["step"]
        assert abs(float(metrics["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
        assert _grad_rel(grads, g_j) <= GRAD_REL_L2
        for k in ("overflow", "iou_intersection", "iou_union", "nr_verts_mean", "nr_points_mean"):
            np.testing.assert_allclose(np.asarray(metrics[k], np.float64), m_j[k], rtol=1e-6, err_msg=k)
        assert int(metrics["overflow"]) == 0
    new0, new1 = port[2][0]["step"][2], port[2][1]["step"][2]
    assert all(np.array_equal(new0[k], new1[k]) for k in new0)  # every rank applies the same update
    # against one device's gradient of the whole cloud (global Lovász): near, never n-fold
    model = _port_model(jax_ref["params"])
    p, v, t = _cloud(0)
    batch = {"positions": torch.from_numpy(p)[None], "values": torch.from_numpy(v)[None],
             "target": torch.from_numpy(t)[None], "point_mask": torch.ones(1, N, dtype=torch.bool)}  # fmt: skip
    loss_fn = make_loss_fn(model, SIGMA, 1, CAPS_FULL, ignore_index=IGNORE)
    leaves, loss, _ = forward_loss(loss_fn, dict(model.state_dict()), batch)
    single = {k: g.numpy() for k, g in gradients(loss, leaves).items()}
    grads = port[2][0]["step"][1]
    ratio = np.sqrt(sum((grads[k] ** 2).sum() for k in single) / sum((g**2).sum() for g in single.values()))
    print(f"sharded (sp=2) / single-device gradient norm: {ratio:.4f}; loss {float(port[2][0]['step'][0]['loss']):.6f}"
          f" / {loss.item():.6f}")  # fmt: skip
    assert 0.8 < ratio < 1.25


def test_sharded_step_with_remat_blocks_gives_the_same_gradients(port):
    for rank in port[2]:
        grads, remat = rank["step"][1], rank["remat_grads"]
        assert _grad_rel(remat, grads) <= 1e-5


def test_sharded_steps_plain_switch_reaches_the_same_gradients(port):
    # on the CPU every wrapper runs its plain version, so plain=True must give
    # the kernel path's gradients and update bit for bit (the card holds the
    # kernels against it at the stripe shapes)
    for rank in port[2]:
        (_, grads, new), (plain_grads, plain_new) = rank["step"], rank["step_plain"]
        assert all(np.array_equal(grads[k], plain_grads[k]) for k in grads)
        assert all(np.array_equal(new[k], plain_new[k]) for k in new)
    for rank in port[4]:
        grads, plain_grads = rank["hybrid"][1], rank["hybrid_plain"]
        assert all(np.array_equal(grads[k], plain_grads[k]) for k in grads)


def test_hybrid_step_matches_jax(port, jax_ref):
    m_j, g_j = jax_ref["hybrid"]
    for r, rank in enumerate(port[4]):
        metrics, grads = rank["hybrid"]
        assert abs(float(metrics["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
        assert _grad_rel(grads, g_j) <= GRAD_REL_L2
        np.testing.assert_allclose(float(metrics["nr_verts_mean"]), float(m_j["nr_verts_mean"]), rtol=1e-6)


def test_batches_that_differ_from_the_mesh_and_narrow_stripes_raise(port):
    for rank in port[2]:
        assert "3 stripes but the mesh sp axis is 2" in rank["mismatch"]
    for rank in port[4]:
        assert "must equal the mesh (dp=2, sp=2)" in rank["hybrid_mismatch"]
        assert "receptive band 56.0" in rank["band"]
        logp, _, _ = rank["approx"]
        assert np.isfinite(logp).all()
