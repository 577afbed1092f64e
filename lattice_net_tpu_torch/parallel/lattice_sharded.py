"""Lattice-sharded big-cloud mode: one cloud's vertex table striped over a
mesh axis (counterpart of ``lattice_net_tpu/parallel/lattice_sharded.py``).

* Points are range-partitioned by their first elevated coordinate
  (:func:`elev0`; lattice keys inherit it as key[0], so a stripe of points
  maps to a stripe of vertices), on the host (:func:`shard_points_host`).
* Each rank builds a local lattice from its own points plus the boundary-band
  points of its two stripe neighbours, received by one shift each way
  (:meth:`Mesh.shift`): every vertex within the rank's receptive field then
  exists locally with its complete splat set, so the convolutions need no
  further communication.
* GroupNorm moments count owned vertices only and are summed over the axis
  (``nn.modules.norm_stats_distributed``); each rank slices only its own
  points, so every point is predicted once.

Halo width: one 1-hop conv moves information by at most (d+1) * 2^l in
level-0 key units at level l; :func:`receptive_band_units` sums that over the
U-Net.  The halo buffer holds ``halo_budget`` points a direction and drops
what exceeds it (counted in the overflow); a stripe narrower than the band
raises unless ``check_band=False`` (``--sp-approx``).

Each function here runs in every rank of a process group (see
:func:`mesh.launch`).  The step and forward functions take the whole
striped batch, stacked on a leading stripe axis as the host helpers give it
(numpy or tensors), and each rank moves its own stripe to its device; a
batch whose stripe count differs from the mesh raises.

Gradients: the loss is psum'd, and so replicated; the parameters are
replicated.  As in JAX's ``shard_map`` transpose, each rank seeds the
backward with 1/n of the loss's cotangent, every psum's backward psums, and
the parameter gradients are psum'd once over the mesh, so they are those of
the global loss.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from lattice_net_tpu_torch.lattice import ops as lops
from lattice_net_tpu_torch.lattice.permutohedral import _elevation_matrix_np
from lattice_net_tpu_torch.lattice.structure import (
    build_hierarchy,
    build_neighbors_same_level,
    build_structure,
)
from lattice_net_tpu_torch.losses import segmentation_loss
from lattice_net_tpu_torch.nn.modules import norm_stats_distributed
from lattice_net_tpu_torch.parallel.data_parallel import TrainState, apply_update
from lattice_net_tpu_torch.parallel.mesh import Mesh
from lattice_net_tpu_torch.train.callbacks import iou_counts_device


def _e0(d: int) -> np.ndarray:
    return _elevation_matrix_np(d)[0].astype(np.float32)


def elev0_np(positions: np.ndarray, sigma) -> np.ndarray:
    """First elevated coordinate of each (N, d) f32 point, f32, rounded as
    XLA's CPU dot rounds ``(positions / sigma) @ e0``: a fused multiply-add
    chain over the coordinates in order, so stripes and their boundaries are
    byte-equal to the JAX package's."""
    d = positions.shape[-1]
    e0 = _e0(d)
    q = np.asarray(positions, np.float32) / np.broadcast_to(np.asarray(sigma, np.float32), (d,))
    acc = q[..., 0] * e0[0]
    for j in range(1, d):
        acc = (q[..., j].astype(np.float64) * float(e0[j]) + acc).astype(np.float32)
    return acc


def elev0(positions: torch.Tensor, sigma) -> torch.Tensor:
    """:func:`elev0_np` on a tensor, on its device."""
    d = positions.shape[-1]
    e0 = _e0(d)
    sig = torch.as_tensor(np.broadcast_to(np.asarray(sigma, np.float32), (d,)).copy(), device=positions.device)
    q = positions.to(torch.float32) / sig
    acc = q[..., 0] * float(e0[0])
    for j in range(1, d):
        acc = (q[..., j].double() * float(e0[j]) + acc.double()).float()
    return acc


def shard_points_host(positions, values, sigma, n_shards: int, per: int | None = None):
    """Host-side stripe partition: sort by elev0, split into equal chunks.

    Returns numpy ``(pos_s, val_s, mask_s, ids_s, bounds)``: (n_shards,
    per, ...) stripes, their point masks, each slot's original point index
    (-1 = padding) and the (n_shards + 1,) f32 stripe boundaries in elev0
    units.  ``per`` overrides the per-stripe point count (at least
    ceil(n / n_shards)) so that clouds of different sizes share one shape;
    trailing stripes that hold only padding get +inf boundaries, so the
    last real stripe owns every remaining vertex."""
    positions = np.asarray(positions)
    values = np.asarray(values)
    s = elev0_np(positions, sigma)
    order = np.argsort(s, kind="stable")
    n = len(positions)
    per_min = -(-n // n_shards)
    per = per_min if per is None else int(per)
    if per < per_min:
        raise ValueError(f"per={per} cannot hold {n} points over {n_shards} shards")
    pad = per * n_shards - n
    order_p = np.concatenate([order, np.full(pad, -1)])
    mask = order_p >= 0
    order_c = np.where(mask, order_p, 0)

    pos_s = positions[order_c].reshape(n_shards, per, -1)
    val_s = values[order_c].reshape(n_shards, per, -1)
    mask_s = mask.reshape(n_shards, per)
    ids_s = order_p.reshape(n_shards, per)

    s_sorted = s[order]
    bounds = np.full(n_shards + 1, np.inf, np.float32)
    bounds[0] = -np.inf
    for i in range(1, n_shards):
        k = i * per
        if k >= n:
            break  # stripes i.. are padding only: their bounds stay +inf
        bounds[i] = 0.5 * (s_sorted[k - 1] + s_sorted[k])
    return (
        pos_s.astype(np.float32), val_s.astype(np.float32), mask_s, ids_s.astype(np.int32), bounds,
    )  # fmt: skip


def shard_clouds_host(clouds, sigma, n_shards: int, ignore_index: int = -1, per: int | None = None):
    """Stripe-partition a batch of (positions, values, target) clouds to
    numpy ``(pos, val, tgt, mask, ids, bounds)`` of shape (B, n_shards, per,
    ...), every cloud padded to the largest one's per-stripe count (or
    ``per``); pad slots carry ``ignore_index`` targets and False masks;
    ``bounds`` is (B, n_shards + 1)."""
    per_min = max(-(-len(c[0]) // n_shards) for c in clouds)
    per = per_min if per is None else int(per)
    if per < per_min:
        raise ValueError(f"per={per} cannot hold the largest cloud over {n_shards} shards")
    ps, vs, ts, ms, ids, bs = [], [], [], [], [], []
    for positions, values, target in clouds:
        pos_s, val_s, mask_s, ids_s, bounds = shard_points_host(positions, values, sigma, n_shards, per=per)
        tgt_s = np.where(
            ids_s >= 0, np.asarray(target)[np.clip(ids_s, 0, len(target) - 1)], ignore_index
        ).astype(np.int32)
        ps.append(pos_s), vs.append(val_s), ts.append(tgt_s)
        ms.append(mask_s), ids.append(ids_s), bs.append(bounds)
    return tuple(np.stack(x) for x in (ps, vs, ts, ms, ids, bs))


def _pack_rows(rows: torch.Tensor, sel: torch.Tensor, budget: int) -> torch.Tensor:
    """The first ``budget`` rows where ``sel``, in row order, in a
    zero-padded (budget, F) buffer (no host read)."""
    dest = torch.cumsum(sel.to(torch.int64), 0) - 1
    slot = torch.where(sel & (dest < budget), dest, budget)
    out = rows.new_zeros((budget + 1, rows.shape[1]))
    out[slot] = rows  # the dropped rows all land in the spare last row
    return out[:budget]


def receptive_band_units(model_params, d: int) -> float:
    """Halo band width (level-0 elev0 units) covering the LNN's receptive
    field: (d+1) * 2^l for each 1-hop conv at level l (coarsen/finefy
    charged at the coarse level, conservatively), plus (d+1) for a point's
    own simplex and two (d+1) margins."""
    p = model_params
    convs_at_level = [0] * (p.nr_downsamples + 1)
    convs_at_level[0] += 1  # pointnet's 1-hop conv
    for i in range(p.nr_downsamples):
        per_block = 2 if i < p.nr_levels_down_with_normal_resnet else 1
        convs_at_level[i] += p.nr_blocks_down_stage[i] * per_block
        convs_at_level[i + 1] += 1
    convs_at_level[p.nr_downsamples] += p.nr_blocks_bottleneck
    for i in range(p.nr_downsamples):
        lvl = p.nr_downsamples - 1 - i
        convs_at_level[lvl + 1] += 1
        per_block = 2 if i >= p.nr_downsamples - p.nr_levels_up_with_normal_resnet else 1
        convs_at_level[lvl] += p.nr_blocks_up_stage[i] * per_block
    units = sum(c * (1 << l) for l, c in enumerate(convs_at_level))
    return float((units + 3) * (d + 1))


def _halo_concat(pos, val, mask, bounds, sigma, band, halo_budget, mesh: Mesh, axis: str):
    """Exchange boundary-band rows with both stripe neighbours.

    Returns ``((all_pos, all_val, all_mask), halo_overflow)``: own rows
    first, then the left neighbour's right band, then the right neighbour's
    left band.  ``halo_overflow`` counts this rank's band points
    that did not fit ``halo_budget`` (both directions): a nonzero count means
    a neighbour built boundary vertices from incomplete splat sets."""
    i = mesh.axis_index(axis)
    s = elev0(pos, sigma)
    lo, hi = bounds[i], bounds[i + 1]
    feat = torch.cat([pos, val, mask[:, None].to(pos.dtype)], dim=-1)
    sel_right = mask & (s >= hi - band)
    sel_left = mask & (s < lo + band)
    right_rows = _pack_rows(feat, sel_right, halo_budget)
    left_rows = _pack_rows(feat, sel_left, halo_budget)
    halo_overflow = torch.clamp(sel_right.sum() - halo_budget, min=0) + torch.clamp(
        sel_left.sum() - halo_budget, min=0
    )
    from_left = mesh.shift(right_rows, axis, +1)
    from_right = mesh.shift(left_rows, axis, -1)
    all_feat = torch.cat([feat, from_left, from_right], dim=0)
    d = pos.shape[-1]
    return (all_feat[:, :d], all_feat[:, d:-1], all_feat[:, -1] > 0.5), halo_overflow


def _check_caps_distinct(caps_local) -> tuple:
    """Per-level capacities must be distinct: the distributed GroupNorm's
    owned masks are keyed by table capacity."""
    caps_local = tuple(int(c) for c in caps_local)
    if len(set(caps_local)) != len(caps_local):
        raise ValueError(f"sharded mode needs distinct per-level capacities, got {caps_local}")
    return caps_local


def _check_stripe_widths(bounds, band: float, n_shards: int, check_band: bool) -> None:
    """Every interior stripe must be at least as wide (elev0 units) as the
    receptive band, or ghost points two stripes away would be needed and
    never received; ``check_band=False`` accepts the approximation."""
    if not check_band:
        return
    b = np.asarray(bounds, np.float64).reshape(-1, np.shape(bounds)[-1])
    for row in b:
        finite = row[np.isfinite(row)]
        if finite.size < 2:
            continue
        widths = np.diff(finite)
        if widths.size and float(widths.min()) < band:
            raise ValueError(
                f"narrowest interior stripe spans {float(widths.min()):.1f} elev0 "
                f"units < receptive band {band:.1f}: the single-hop halo cannot "
                f"cover the receptive field over {n_shards} shards — use fewer "
                "shards / a coarser sigma, or pass check_band=False to accept "
                "approximate boundaries"
            )


def _check_stripes(stripes: int, n_shards: int, axis: str) -> None:
    if stripes != n_shards:
        raise ValueError(
            f"sharded batch has {stripes} stripes but the mesh {axis} axis is {n_shards}; "
            "each rank takes one stripe, so the batch must match the mesh"
        )


def _take(x, index, device, dtype=None) -> torch.Tensor:
    """``x[index]`` (numpy or tensor) as a tensor on ``device``."""
    t = torch.as_tensor(np.asarray(x[index]) if isinstance(x, np.ndarray) else x[index])
    return t.to(device=device, dtype=dtype or t.dtype)


def make_sharded_splat_conv_slice(
    mesh: Mesh, sigma, cap_local: int, halo_budget: int, nr_convs: int = 1, axis: str = "sp", device=None
) -> Callable:
    """The sharded pipeline splat -> (1-hop conv)^nr_convs -> slice: the
    halo exchange, the per-shard build, convs over ghost vertices and the
    owner-only slice.  Returns ``fn(pos_s, val_s, mask_s, bounds, weights)
    -> (out, nr_verts, overflow)`` of this rank's stripe (f32 convs)."""
    n_shards = mesh.shape[axis]

    def run(pos_s, val_s, mask_s, bounds, weights):
        _check_stripes(len(pos_s), n_shards, axis)
        i = mesh.axis_index(axis)
        pos = _take(pos_s, i, device, torch.float32)
        val = _take(val_s, i, device, torch.float32)
        mask = _take(mask_s, i, device, torch.bool)
        bounds_t = torch.as_tensor(np.asarray(bounds, np.float32), device=pos.device)
        d = pos.shape[-1]
        band = (nr_convs + 3) * (d + 1) * 1.0
        (all_pos, all_val, all_mask), _ = _halo_concat(pos, val, mask, bounds_t, sigma, band, halo_budget, mesh, axis)
        structure, vid, bary, _ = build_structure(
            all_pos, sigma, cap_local, point_mask=all_mask, need_point_maps=True
        )
        lv = lops.splat(all_val, vid, bary, cap_local)
        nbr = build_neighbors_same_level(structure)
        for w in weights:
            lv = lops.conv_im2row(lv, nbr, torch.as_tensor(w, device=pos.device), same_level=True)
        n_own = pos.shape[0]
        sliced = lops.slice_lattice(lv, vid[:n_own], bary[:n_own])
        return sliced, structure.nr_verts, structure.nr_overflow

    return run


def _halo_build_apply(model, params, pos, val, mask, bounds, sigma, nr_levels, caps_local, halo_budget,
                      mesh: Mesh, axis: str, plain=False):  # fmt: skip
    """The per-shard body: halo exchange over ``axis``, the local hierarchy
    over own + ghost points, the U-Net with GroupNorm moments over owned
    vertices summed over the axis.  Returns (logp over own + ghost rows,
    hierarchy, halo overflow, owned level-0 vertices).  No dropout: the
    JAX sharded steps thread no rng."""
    d = pos.shape[-1]
    band = receptive_band_units(model.params, d)
    i = mesh.axis_index(axis)
    (all_pos, all_val, all_mask), halo_ovf = _halo_concat(pos, val, mask, bounds, sigma, band, halo_budget, mesh, axis)
    h = build_hierarchy(all_pos, sigma, nr_levels, caps_local, point_mask=all_mask, point_feats=all_val)
    # a vertex belongs to the stripe holding its first elevated coordinate
    # (level-l keys sit at 2^l spacing in level-0 units): each vertex lands in
    # exactly one stripe
    lo, hi = bounds[i], bounds[i + 1]
    own_masks = {}
    for lvl, s in enumerate(h.structures):
        coord = s.keys[:, 0].to(torch.float32) * float(1 << lvl)
        own_masks[s.capacity] = (coord >= lo) & (coord < hi) & s.occupancy_mask()
    with norm_stats_distributed(mesh, axis, own_masks):
        logp, _ = functional_call(model, params, (h, all_pos, all_val), dict(plain=plain, train=False))
    own_verts0 = own_masks[h.structures[0].capacity].sum()
    return logp, h, halo_ovf, own_verts0


def make_sharded_lnn_forward(
    mesh: Mesh, model, sigma, nr_levels: int, caps_local, halo_budget: int, axis: str = "sp",
    check_band: bool = True,
):  # fmt: skip
    """The full LNN forward with the vertex table striped over ``axis``.

    Returns ``fn(params, pos_s, val_s, mask_s, bounds, plain=False) ->
    (logp, nr_verts, overflow)`` of this rank's stripe (its own points'
    log-probabilities; its level-0 vertices, ghosts included; table plus
    halo overflow), under ``torch.no_grad``.  ``params`` is a ``{name:
    tensor}`` dict on the rank's device."""
    caps_local = _check_caps_distinct(caps_local)
    n_shards = mesh.shape[axis]
    band = receptive_band_units(model.params, 3)

    def fn(params, pos_s, val_s, mask_s, bounds, plain=False):
        _check_stripes(len(pos_s), n_shards, axis)
        _check_stripe_widths(bounds, band, n_shards, check_band)
        dev = next(iter(params.values())).device
        i = mesh.axis_index(axis)
        pos, val = _take(pos_s, i, dev, torch.float32), _take(val_s, i, dev, torch.float32)
        mask = _take(mask_s, i, dev, torch.bool)
        bounds_t = torch.as_tensor(np.asarray(bounds, np.float32), device=dev)
        with torch.no_grad():
            logp, h, halo_ovf, _ = _halo_build_apply(
                model, params, pos, val, mask, bounds_t, sigma, nr_levels, caps_local, halo_budget,
                mesh, axis, plain,
            )  # fmt: skip
            overflow = sum(s.nr_overflow for s in h.structures) + halo_ovf
        return logp[: pos.shape[0]], h.structures[0].nr_verts, overflow

    return fn


def _sharded_loss_terms(model, params, pos, val, tgt, mask, bounds, sigma, nr_levels, caps_local,
                        halo_budget, mesh: Mesh, axis: str, ignore_index: int, plain: bool):  # fmt: skip
    """One stripe's ``(loss_sum, valid_count, metric_sums)``.

    The stripe's loss is weighted by its valid count, so a psum over the
    mesh gives the global per-point mean for the NLL half; the Lovász half
    becomes a per-stripe Lovász average, as the DP trainer's is a per-cloud
    one.  ``metric_sums`` holds additive counts (overflow, correct/valid,
    per-class I/U, owned level-0 vertices, own points)."""
    logp, h, halo_ovf, own_verts0 = _halo_build_apply(
        model, params, pos, val, mask, bounds, sigma, nr_levels, caps_local, halo_budget, mesh, axis, plain
    )
    n_own = pos.shape[0]
    own_valid = mask & (tgt != ignore_index)
    cnt = own_valid.sum().to(torch.float32)
    logp_own = logp[:n_own]
    loss_mean = segmentation_loss(logp_own, tgt, ignore_index, None, mask)
    inter, union = iou_counts_device(logp_own, tgt, logp_own.shape[-1], ignore_index, mask)
    with torch.no_grad():
        metric_sums = {
            "overflow": (sum(s.nr_overflow for s in h.structures) + halo_ovf).to(torch.int64),
            "correct": ((torch.argmax(logp_own, -1) == tgt) & own_valid).sum().to(torch.float32),
            "valid": cnt,
            "iou_intersection": inter,
            "iou_union": union,
            "nr_verts": own_verts0.to(torch.int64),
            "nr_points": mask.sum().to(torch.float32),
        }
    return loss_mean * cnt, cnt, metric_sums


def _metrics_dict(loss, ms, n_clouds: int) -> dict:
    """DP-trainer metrics from the psum'd metric sums; ``overflow`` stays
    the global count, the ``*_mean`` keys are per cloud."""
    ovf = ms["overflow"]
    return {
        "loss": loss.detach(),
        "overflow": ovf,
        "acc": ms["correct"] / torch.clamp(ms["valid"], min=1.0),
        "nr_verts_mean": ms["nr_verts"].to(torch.float32) / n_clouds,
        "nr_overflow_mean": ovf.to(torch.float32) / n_clouds,
        "nr_points_mean": ms["nr_points"] / n_clouds,
        "iou_intersection": ms["iou_intersection"],
        "iou_union": ms["iou_union"],
    }


def _global_step(mesh: Mesh, loss_axes, tx, state: TrainState, loss_terms):
    """The step's shared tail: psum the stripes' loss sums and counts over
    ``loss_axes``, differentiate the replicated loss as JAX's transpose does
    (cotangent 1/n a rank, parameter gradients psum'd once), update.
    Returns (new state, loss, psum'd metric sums)."""
    leaves = {k: p.detach().requires_grad_() for k, p in state.params.items()}
    lsum, cnt, ms = loss_terms(leaves)
    summed = mesh.psum(torch.stack([lsum, cnt]), loss_axes)
    loss = summed[0] / torch.clamp(summed[1], min=1.0)
    ms = mesh.psum_tree(ms, loss_axes)
    seed = torch.full_like(loss, 1.0 / mesh.size(loss_axes))
    grads = torch.autograd.grad(loss, list(leaves.values()), seed, materialize_grads=True)
    grads = mesh.psum_tree(dict(zip(leaves, grads)), mesh.axis_names)
    return apply_update(tx, state, grads, loss), loss, ms


def make_sharded_lnn_train_step(
    mesh: Mesh, model, tx, sigma, nr_levels: int, caps_local, halo_budget: int, ignore_index: int = -1,
    axis: str = "sp", check_band: bool = True,
):  # fmt: skip
    """The sharded train step: one cloud striped over the mesh, replicated
    parameters, gradients of the global masked loss (each own valid point
    counted once; the Lovász half per stripe).

    Returns ``step(state, pos_s, val_s, tgt_s, mask_s, bounds, plain=False)
    -> (new_state, metrics)``, every rank with the same new state;
    ``plain=True`` runs the kernels' plain versions, forward and backward."""
    caps_local = _check_caps_distinct(caps_local)
    n_shards = mesh.shape[axis]
    band = receptive_band_units(model.params, 3)

    def step(state: TrainState, pos_s, val_s, tgt_s, mask_s, bounds, plain=False):
        _check_stripes(len(pos_s), n_shards, axis)
        _check_stripe_widths(bounds, band, n_shards, check_band)
        dev = next(iter(state.params.values())).device
        i = mesh.axis_index(axis)
        pos, val = _take(pos_s, i, dev, torch.float32), _take(val_s, i, dev, torch.float32)
        tgt, mask = _take(tgt_s, i, dev, torch.int64), _take(mask_s, i, dev, torch.bool)
        bounds_t = torch.as_tensor(np.asarray(bounds, np.float32), device=dev)

        def terms(leaves):
            return _sharded_loss_terms(
                model, leaves, pos, val, tgt, mask, bounds_t, sigma, nr_levels, caps_local, halo_budget,
                mesh, axis, ignore_index, plain,
            )  # fmt: skip

        new_state, loss, ms = _global_step(mesh, axis, tx, state, terms)
        return new_state, _metrics_dict(loss, ms, 1)

    return step


def make_hybrid_lnn_train_step(
    mesh: Mesh, model, tx, sigma, nr_levels: int, caps_local, halo_budget: int, ignore_index: int = -1,
    dp_axis: str = "dp", sp_axis: str = "sp", check_band: bool = True,
):  # fmt: skip
    """The hybrid step over a 2-axis mesh: a batch of clouds data-parallel
    over ``dp_axis``, each cloud's vertex table striped over ``sp_axis``.

    The loss is the global per-valid-point mean over the whole batch (one
    psum over both axes), the Lovász half per stripe.  Collectives a step:
    two halo shifts (sp), the GroupNorm moments (sp), the loss and the
    gradients (both axes).  Returns ``step(state, pos_b, val_b, tgt_b,
    mask_b, bounds_b, plain=False) -> (new_state, metrics)`` over (B, n_sp,
    per, ...) blocks with B = the dp axis; ``plain`` as in
    :func:`make_sharded_lnn_train_step`."""
    caps_local = _check_caps_distinct(caps_local)
    n_dp, n_sp = mesh.shape[dp_axis], mesh.shape[sp_axis]
    band = receptive_band_units(model.params, 3)

    def step(state: TrainState, pos_b, val_b, tgt_b, mask_b, bounds_b, plain=False):
        if tuple(pos_b.shape[:2]) != (n_dp, n_sp):
            raise ValueError(
                f"hybrid batch {tuple(pos_b.shape[:2])} must equal the mesh ({dp_axis}={n_dp}, "
                f"{sp_axis}={n_sp}); split the batch into mesh-sized steps"
            )
        _check_stripe_widths(bounds_b, band, n_sp, check_band)
        dev = next(iter(state.params.values())).device
        at = (mesh.axis_index(dp_axis), mesh.axis_index(sp_axis))
        pos, val = _take(pos_b, at, dev, torch.float32), _take(val_b, at, dev, torch.float32)
        tgt, mask = _take(tgt_b, at, dev, torch.int64), _take(mask_b, at, dev, torch.bool)
        bounds_t = torch.as_tensor(np.asarray(bounds_b[at[0]], np.float32), device=dev)

        def terms(leaves):
            return _sharded_loss_terms(
                model, leaves, pos, val, tgt, mask, bounds_t, sigma, nr_levels, caps_local, halo_budget,
                mesh, sp_axis, ignore_index, plain,
            )  # fmt: skip

        new_state, loss, ms = _global_step(mesh, (dp_axis, sp_axis), tx, state, terms)
        return new_state, _metrics_dict(loss, ms, n_dp)

    return step
