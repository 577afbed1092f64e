"""Training CLI on the card:

    python -m lattice_net_tpu_torch.train.ln_train <config.cfg> [--max-epochs N]
        [--n-points N] [--eval-every N] [--resume ckpt] [section.key=value ...]

The JAX package's trainer (``lattice_net_tpu/train/ln_train.py``) in the
port: the same config schema and overrides, loaders (``toy``,
``synthkitti``, ``semantickitti``, ``scannet``, ``shapenet``; the test phase
reads the ``val`` split, or ``test`` where there is none; ScanNet's ``val``
is its train scenes, as in JAX), ``"auto"`` class weights, ``capacity_mode:
"auto"`` (the first four train clouds scouted at the fixed schedule;
``LNT_TRAIN_CAPS`` wins over it), static point budget, phases, callbacks
(TensorBoard scalars with ``train.with_tensorboard``), printed lines,
sanity heuristics, checkpoints and resume, and the same optimizer (cosine
warm restarts for SemanticKITTI, else ``reduce_on_plateau`` over each
epoch's mean step loss).  Each train step is ``make_train_step``'s,
through the CUDA kernels of ``ops_cuda``.

What differs, because it served the TPU runtime and not the training:

* there is no setup subprocess: the weights come from
  ``torch.Generator().manual_seed(0)`` (``TrainSetup``), the capacity scout
  runs in-process on the card, and the first cloud's hierarchy is built
  once on the card for its sanity check;
* the test phase is a ``torch.no_grad()`` forward in eval mode
  (``train=False``) through ``make_loss_fn``.  The JAX trainer runs it
  through its train step with the update scaled by 0, in train mode, so the
  two agree only where the head's dropout is 0, as in every shipped config;
* the loader thread builds host numpy batches only; the copy to the card
  happens on the main thread.

The lattice convs run in bf16 on the card and in f32 on the CPU, the JAX
package's choice on its accelerator and on the CPU.

Parallel training, as JAX's ``--dp``/``--sp``/``--sp-approx``: the run
spawns its ranks (``parallel/mesh.py``; ``--ranks`` and ``--backend``, by
default one rank a visible card over NCCL).  ``--dp`` rounds the batch to
a multiple of the ranks; each rank builds the same host batches and takes
its slice, and the gradients are averaged.  ``--sp N`` stripes each cloud
over N ranks (batch 1; with ``--dp`` one cloud per row of a (ranks / N, N)
mesh) through the sharded steps, whose stripes narrower than the
receptive band raise unless ``--sp-approx``; class weights and dropout are
not applied there, as in JAX, and the test phase runs unsharded on rank 0.
Rank 0 prints, runs the callbacks and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import os
import queue
import threading
from pathlib import Path

import numpy as np
import torch

from lattice_net_tpu_torch.config import (
    LatticeParams,
    TrainParams,
    apply_overrides,
    load_config,
    model_params_from_config,
)
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import check_positions, default_conv_dtype
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.models.lnn import compute_class_weights, prepare_cloud
from lattice_net_tpu_torch.parallel.data_parallel import (
    TrainState,
    _batch_rng,
    make_dp_train_step,
    make_host_batch,
    make_loss_fn,
    make_train_step,
    rank_generator,
    replicate_state,
    shard_batch,
    to_device,
)
from lattice_net_tpu_torch.parallel.lattice_sharded import (
    make_hybrid_lnn_train_step,
    make_sharded_lnn_train_step,
    shard_clouds_host,
)
from lattice_net_tpu_torch.parallel.mesh import BACKENDS, Mesh, launch, plan_ranks
from lattice_net_tpu_torch.train.callbacks import (
    CallbacksGroup,
    CheckpointCallback,
    Phase,
    StateCallback,
    TensorboardCallback,
    TimingCallback,
)
from lattice_net_tpu_torch.train.checkpoint import load_checkpoint
from lattice_net_tpu_torch.train.setup import TrainSetup, capacities_from_config

# the target of a tail-padding cloud: its point mask is cleared before a step
DUMMY_TARGET = -12345
PREFETCH_DEPTH = 2  # host batches made ahead of the step


def create_loader(dataset_name: str, cfg: dict, mode: str):
    """The dataset of a config's ``train.dataset_name``, for ``mode``
    ("train", "val" or "test")."""
    from lattice_net_tpu_torch.data.toy import ToyDataset
    from lattice_net_tpu_torch.data.transforms import TransformParams

    def transformer(loader_cfg, up="z"):
        """The loader section's ``transformer`` block, or None.  The recipe's
        keys are y-up: ``up="z"`` maps them onto the z-up clouds (procedural
        scenes, velodyne scans, ScanNet rooms); ShapeNet's are y-up."""
        if "transformer" not in loader_cfg:
            return None
        return TransformParams.from_config(loader_cfg["transformer"]).for_up_axis(up)

    if dataset_name == "toy":
        l = cfg.get("loader_toy", {})
        return ToyDataset(
            mode=mode,
            nr_samples=int(l.get("nr_samples", 20)),
            n_points=int(l.get("n_points", 2000)),
            do_overfit=bool(l.get("do_overfit", False)),
        )
    if dataset_name == "synthkitti":
        from lattice_net_tpu_torch.data.synth_kitti import SynthKitti

        l = cfg.get("loader_synth_kitti", {})
        nr_samples = int(l.get("nr_samples", 40))
        if mode != "train":  # the held-out split may be sized on its own
            nr_samples = int(l.get("nr_samples_test", nr_samples))
        return SynthKitti(
            mode=mode,
            nr_samples=nr_samples,
            n_points=int(l.get("n_points", 131072)),
            max_range=float(l.get("max_range", 50.0)),
            do_overfit=bool(l.get("do_overfit", False)),
            classes=int(l.get("classes", 6)),
            transform=transformer(l),
        )
    if dataset_name == "semantickitti":
        from lattice_net_tpu_torch.data.semantic_kitti import SemanticKitti

        l = cfg.get("loader_semantic_kitti", {})
        return SemanticKitti(
            dataset_path=l.get("dataset_path", ""),
            mode=mode,
            cap_distance=float(l.get("cap_distance", 60.0)),
            max_nr_points_per_cloud=int(l.get("max_nr_points_per_cloud", 400000)),
            shuffle=bool(l.get("shuffle", True)),
            do_overfit=bool(l.get("do_overfit", False)),
            transform=transformer(l),
        )
    if dataset_name == "scannet":
        from lattice_net_tpu_torch.data.scannet import ScanNet

        l = cfg.get("loader_scannet", {})
        return ScanNet(
            dataset_path=l.get("dataset_path", ""),
            mode=mode,
            max_nr_points_per_cloud=int(l.get("max_nr_points_per_cloud", 400000)),
            shuffle=bool(l.get("shuffle", True)),
            do_overfit=bool(l.get("do_overfit", False)),
            transform=transformer(l),
        )
    if dataset_name == "shapenet":
        from lattice_net_tpu_torch.data.shapenet import ShapeNetPartSeg

        l = cfg.get("loader_shapenet_partseg", {})
        return ShapeNetPartSeg(
            dataset_path=l.get("dataset_path", ""),
            mode=mode,
            restrict_to_object=l.get("restrict_to_object", "motorbike"),
            shuffle=bool(l.get("shuffle", True)),
            do_overfit=bool(l.get("do_overfit", False)),
            normalize=bool(l.get("normalize", False)),
            transform=transformer(l, up="y"),
        )
    raise ValueError(f"unknown dataset {dataset_name}")


def sanity_check(nr_verts: int, nr_points: int, capacity: int, seen: set | None = None) -> None:
    """Warn when sigma looks too big (< 100 vertices) or too small (more
    vertices than points), or the level-0 table is over 90% full.  With
    ``seen``, each kind of warning prints once per epoch."""
    warnings = []
    if nr_verts < 100:
        warnings.append(("few", f"only {nr_verts} vertices — sigma is probably too big"))
    if nr_verts > nr_points:
        warnings.append(("many", f"{nr_verts} vertices > {nr_points} points — sigma too small"))
    if nr_verts > 0.9 * capacity:
        warnings.append(
            (
                "full",
                f"lattice at {nr_verts}/{capacity} (> 90% capacity): "
                "overflow imminent — increase hash_table_capacity",
            )
        )
    for key, msg in warnings:
        if seen is None or key not in seen:
            print(f"WARNING: {msg}")
            if seen is not None:
                seen.add(key)


def batched_clouds(
    loader,
    model_params,
    batch_size: int,
    n_points: int,
    drop_last: bool,
    sigma=None,
    chunk_oversized: bool = False,
):
    """Group the loader's prepared clouds into lists of ``batch_size``;
    yields ``(clouds, real)`` with ``real`` the number of real clouds.

    A partial tail batch is padded by repeating the first cloud with every
    target set to ``DUMMY_TARGET``, whose point mask the trainer clears.
    Each cloud passes ``check_positions`` (with ``sigma``, the packed-key
    bound).  ``chunk_oversized`` (the test phase) splits a cloud larger
    than ``n_points`` into consecutive chunks, one batch slot each, so that
    every point is evaluated once; otherwise the batch subsamples it."""

    def prepared_stream():
        for cloud in loader:
            prepared = prepare_cloud(cloud, model_params)
            check_positions(prepared[0], prepared[1], sigma=sigma)
            if chunk_oversized and prepared[0].shape[0] > n_points:
                p, v, t = prepared
                for start in range(0, p.shape[0], n_points):
                    stop = start + n_points
                    yield p[start:stop], v[start:stop], t[start:stop]
            else:
                yield prepared

    buf = []
    for prepared in prepared_stream():
        buf.append(prepared)
        if len(buf) == batch_size:
            yield buf, len(buf)
            buf = []
    if buf:
        if drop_last and len(buf) < batch_size:
            return
        real = len(buf)
        while len(buf) < batch_size:
            p, v, t = buf[0]
            buf.append((p, v, np.full_like(t, DUMMY_TARGET)))
        yield buf, real


def prefetch_batches(generator, make):
    """``make`` over the generator in a background thread, ``PREFETCH_DEPTH``
    items ahead; an exception there is raised here.  ``make`` must not touch
    the card: the caller copies to it on its own thread."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
    end = object()
    err = []

    def worker():
        try:
            for item in generator:
                q.put(make(item))
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item


def _host_batch(item, n_points: int, canonical=None):
    """A loader-thread batch: host numpy arrays, with the point masks of the
    tail-padding clouds cleared; each cloud in canonical point order where
    ``canonical`` (a sigma) is given."""
    clouds, real = item
    batch = make_host_batch(clouds, n_points, canonical=canonical)
    dummy = batch["target"][:, 0] == DUMMY_TARGET
    batch["point_mask"] = batch["point_mask"] & ~dummy[:, None]
    return batch, real


def _class_weights(cfg: dict, loader, nr_classes: int, ignore_index: int):
    """``train.class_weights``: a list of class frequencies, or ``"auto"``
    for the label frequencies of the first four train clouds."""
    cw_cfg = cfg.get("train", {}).get("class_weights", None)
    if not cw_cfg:
        return None
    if isinstance(cw_cfg, (list, tuple)):
        freqs = np.asarray(cw_cfg, np.float64)
    else:
        counts = np.zeros(nr_classes, np.int64)
        for i in range(min(4, len(loader))):
            lbl = np.asarray(loader.get_cloud(i).L_gt).reshape(-1)
            counts += np.bincount(lbl, minlength=nr_classes)[:nr_classes]
        freqs = counts / max(counts.sum(), 1)
    weights = compute_class_weights(freqs, ignore_index if ignore_index >= 0 else None)
    print(f"class weights: {np.round(weights.numpy(), 3).tolist()}")
    return weights


@dataclasses.dataclass(frozen=True)
class _Job:
    """What every rank of a run trains (``run``'s arguments)."""

    config_path: str
    max_epochs: int
    n_points: int
    eval_every: int
    resume: str
    overrides: tuple
    dp: bool
    sp: int
    sp_approx: bool


def run(
    config_path,
    max_epochs: int = 100,
    n_points: int = 0,
    eval_every: int = 1,
    resume: str = "",
    dp: bool = False,
    overrides=(),
    sp: int = 0,
    device=None,
    sp_approx: bool = False,
    ranks: int | None = None,
    backend: str | None = None,
) -> TrainState:
    """Train the config's model for epochs up to ``max_epochs`` (from the
    resumed step's epoch with ``resume``), testing every ``eval_every``
    epochs; returns the final state.  ``device`` is the card unless
    ``"cpu"``.

    ``dp`` (data parallelism) and ``sp`` (each cloud striped over ``sp``
    ranks; with ``dp`` too, the hybrid over ``ranks // sp`` clouds) spawn
    the ranks (``parallel.mesh``): ``ranks`` of them (default: one a card;
    ``sp`` without ``dp``: ``sp``) over ``backend`` (default NCCL on the
    card, gloo on the CPU); the returned state is rank 0's, on the CPU."""
    device = resolve_device(device)
    job = _Job(str(config_path), max_epochs, n_points, eval_every, resume, tuple(overrides), dp, sp, sp_approx)
    if not (dp or sp):
        return _train(job, device, None)
    if not sp:
        plan = plan_ranks(ranks, device, backend)
        shape = ((plan.count,), ("dp",))
    elif not dp:
        if ranks is not None and ranks != sp:
            raise ValueError(f"--sp {sp} without --dp runs on {sp} ranks, not {ranks}")
        plan, shape = plan_ranks(sp, device, backend), ((sp,), ("sp",))
    else:  # the hybrid: as many rows of sp ranks as the ranks hold
        have = ranks if ranks is not None else (torch.cuda.device_count() if device.type == "cuda" else 0)
        if have < sp:
            raise ValueError(f"--sp {sp} needs {sp} ranks, have {have}")
        plan, shape = plan_ranks(have // sp * sp, device, backend), ((have // sp, sp), ("dp", "sp"))
    params, opt_state, step = launch(_train_rank, job, shape, ranks=plan)[0]
    as_tensor = lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x  # noqa: E731
    return TrainState(
        {k: as_tensor(v) for k, v in params.items()}, _map_tree(opt_state, as_tensor), int(step)
    )


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _train_rank(device, job: _Job, shape):
    """One rank of a parallel run: its mesh, then the training loop; rank
    0 prints, tests and checkpoints."""
    mesh = Mesh(shape[1], shape[0])
    out = contextlib.nullcontext() if mesh.rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with out:
        state = _train(job, device, mesh)
    return state.params, state.opt_state, state.step


def _train(job: _Job, device, mesh: Mesh | None) -> TrainState:
    """The training loop of one process: single-device with ``mesh`` None,
    else this rank's part of ``job.dp``/``job.sp``."""
    cfg = apply_overrides(load_config(job.config_path), job.overrides)
    tp = TrainParams.from_config(cfg)
    lp = LatticeParams.from_config(cfg)
    sp = job.sp
    rank0 = mesh is None or mesh.rank == 0
    n_points = job.n_points

    loader_train = create_loader(tp.dataset_name, cfg, "train")
    try:
        loader_test = create_loader(tp.dataset_name, cfg, "val")
    except (FileNotFoundError, ValueError):  # no val split: test on the test split
        loader_test = create_loader(tp.dataset_name, cfg, "test")
    nr_classes = loader_train.nr_classes
    ignore_index = getattr(loader_train, "ignore_index", -1)
    mp = model_params_from_config(cfg, nr_classes)
    class_weights = _class_weights(cfg, loader_train, nr_classes, ignore_index)

    if os.environ.get("LNT_TRAIN_CAPS"):
        # explicit per-level capacities, e.g. "65536,32768,8192"; the
        # parameters do not depend on them, so checkpoints resume across
        caps = tuple(int(x) for x in os.environ["LNT_TRAIN_CAPS"].split(","))
        if len(caps) != mp.nr_downsamples + 1:
            raise ValueError(f"LNT_TRAIN_CAPS {caps}: need {mp.nr_downsamples + 1} levels")
    else:
        # "auto": scout the first four train clouds (their draws come from
        # the loader's generator, as in JAX) at the fixed, upper-bound schedule
        scout = []
        if lp.capacity_mode == "auto":
            scout = [loader_train.get_cloud(i).V for i in range(min(4, len(loader_train)))]
        caps = capacities_from_config(lp, mp, scout, device)

    if n_points <= 0:  # static point budget: the next power of two over the first cloud
        first = loader_train.get_cloud(0)
        n_points = 1 << int(np.ceil(np.log2(max(len(first.V), 512))))
    # fixed-size clouds at the budget carry all-true masks: mask-free builds
    full_mask = getattr(loader_train, "fixed_n_points", None) == n_points
    if full_mask:
        print("fixed-size clouds: building mask-free")

    batch_size = max(1, tp.batch_size)
    sp_per = 0
    if sp:
        # each cloud striped over the sp ranks, with a static stripe size;
        # with dp the batch is one cloud a dp row
        sp_per = -(-n_points // sp)
        batch_size = mesh.shape["dp"] if job.dp else 1
        if mp.dropout_last_layer:
            print("--sp: dropout is a no-op in sharded training (no rng threaded)")
    elif job.dp:
        n = mesh.size("dp")
        if batch_size % n != 0:
            batch_size = max(n, batch_size - batch_size % n)
            print(f"--dp: rounding batch_size to {batch_size} ({n} ranks)")
    steps_per_epoch = max(1, len(loader_train) // batch_size)
    conv_dtype = default_conv_dtype(device)
    setup = TrainSetup.from_config(
        cfg, nr_classes, steps_per_epoch, device, conv_dtype, seed=0, capacities=caps
    )
    model, tx, sigma = setup.model, setup.tx, setup.sigma
    sp_shape = mesh.shape if sp else 0
    print(
        f"n_points={n_points} batch={batch_size} caps={caps} sigma={sigma} "
        f"classes={nr_classes} dp={bool(job.dp and not sp)} sp={sp_shape}"
    )

    # the first cloud's build, for its sanity check
    b0 = make_host_batch([prepare_cloud(loader_train.get_cloud(0), mp)] * batch_size, n_points)
    b0 = {k: v[0] for k, v in to_device(b0, device).items()}
    h0 = build_hierarchy(
        b0["positions"], sigma, mp.nr_downsamples, caps,
        point_mask=b0["point_mask"], point_feats=b0["values"],
    )  # fmt: skip
    sanity_check(int(h0.structures[0].nr_verts), int(b0["point_mask"].sum()), caps[0])
    del h0, b0
    print(f"model parameters: {sum(p.numel() for p in model.parameters()):,}")

    state = TrainState.create(model.state_dict(), tx)
    start_epoch = 0
    if job.resume:
        state = load_checkpoint(job.resume, state)
        start_epoch = state.step // steps_per_epoch
        print(f"resumed {job.resume} at step {state.step} (epoch ~{start_epoch})")
    if mesh is not None:
        state = replicate_state(state)

    if class_weights is not None:
        class_weights = class_weights.to(device)
    # LNT_CANONICAL_TRAIN=1: the loader thread puts each cloud in canonical
    # point order, and the step builds level 0 by the corner-dedup fast
    # build (the lattice is permutation invariant; labels move with points)
    canon = os.environ.get("LNT_CANONICAL_TRAIN", "0") == "1"
    if canon:
        print("LNT_CANONICAL_TRAIN=1: canonical point order, corner-dedup level-0 build")
    common = dict(
        ignore_index=ignore_index, class_weights=class_weights, full_mask=full_mask,
        canonical_points=canon,
    )  # fmt: skip
    nr_levels = mp.nr_downsamples
    generator = setup.generator
    if sp:
        if class_weights is not None:
            print("--sp: class_weights not supported in sharded steps; ignoring")
        sharded = dict(halo_budget=sp_per, ignore_index=ignore_index, check_band=not job.sp_approx)
        if job.dp:
            sp_step = make_hybrid_lnn_train_step(mesh, model, tx, sigma, nr_levels, caps, **sharded)
        else:
            sp_step = make_sharded_lnn_train_step(mesh, model, tx, sigma, nr_levels, caps, **sharded)

        def train_step(state, batch, generator):
            return sp_step(state, *(batch[k] for k in ("pos_s", "val_s", "tgt_s", "mask_s", "bounds")))
    elif job.dp:
        train_step = make_dp_train_step(model, tx, mesh, sigma, nr_levels, caps, axis="dp", **common)
        generator = rank_generator(0, mesh.rank, device)
    else:
        train_step = make_train_step(model, tx, sigma, nr_levels, caps, **common)
    loss_fn = make_loss_fn(model, sigma, nr_levels, caps, **common)

    cbs = []
    if rank0:
        cbs = [StateCallback(nr_classes, ignore_index), TimingCallback()]
        if tp.save_checkpoint:
            ckpt_dir = Path(tp.checkpoint_path or "checkpoints")
            cbs.append(CheckpointCallback(ckpt_dir, lambda: state, tx))
        if tp.with_tensorboard:
            cbs.append(TensorboardCallback("tensorboard_logs", tp.dataset_name))
    cb = CallbacksGroup(cbs)
    phases = [Phase("train", loader_train, grad=True), Phase("test", loader_test, grad=False)]

    for epoch in range(start_epoch, job.max_epochs):
        for phase in phases:
            if not phase.grad and epoch % job.eval_every != 0:
                continue
            if not phase.grad and sp and not rank0:
                continue  # the sharded runs test on rank 0, unsharded, as JAX's on one device
            cb.epoch_started(phase=phase)
            cb.phase_started(phase=phase)
            warned: set = set()
            gen = batched_clouds(
                phase.loader, mp, batch_size, n_points, drop_last=False,
                sigma=sigma, chunk_oversized=not phase.grad,
            )  # fmt: skip
            if sp and phase.grad:
                make = functools.partial(_striped_batch, n_points=n_points, sigma=sigma, sp=sp, per=sp_per,
                                         ignore_index=ignore_index, hybrid=job.dp)  # fmt: skip
            else:
                make = functools.partial(_host_batch, n_points=n_points, canonical=sigma if canon else None)
            for host, real in prefetch_batches(gen, make):
                if phase.grad:
                    if sp:
                        batch = host
                    elif job.dp:
                        batch = shard_batch(host, mesh, "dp", device)
                    else:
                        batch = to_device(host, device)
                    state, metrics = train_step(state, batch, generator)
                    # the *_mean metrics average over every batch slot, the
                    # tail's empty ones too: rescale to the real clouds
                    scale = batch_size / max(1, real)
                    sanity_check(
                        int(float(metrics["nr_verts_mean"]) * scale),
                        int(float(metrics["nr_points_mean"]) * scale),
                        caps[0],
                        seen=warned,
                    )
                else:
                    metrics = _test_metrics(loss_fn, state, host, device, mesh if job.dp and not sp else None)
                cb.after_forward_pass(
                    phase=phase,
                    loss=float(metrics["loss"]),
                    inter=metrics["iou_intersection"].cpu().numpy(),
                    union=metrics["iou_union"].cpu().numpy(),
                )
            cb.phase_ended(phase=phase)
            if phase.grad:
                print(
                    f"[train] lattice occupancy {int(metrics['nr_verts_mean'])}/{caps[0]} "
                    f"overflow {float(metrics['nr_overflow_mean']):.1f}"
                )
            cb.epoch_ended(phase=phase)
    return state


def _striped_batch(item, n_points: int, sigma, sp: int, per: int, ignore_index: int, hybrid: bool):
    """A loader-thread batch for the sharded steps: each cloud subsampled to
    ``n_points`` (as ``make_host_batch`` does), striped over ``sp`` with
    ``per`` points a stripe; the tail-padding clouds' masks cleared; without
    ``hybrid`` the one cloud's (sp, per, ...) blocks."""
    clouds, real = item
    capped = []
    for positions, values, target in clouds:
        if positions.shape[0] > n_points:
            sel = _batch_rng.choice(positions.shape[0], n_points, replace=False)
            positions, values, target = positions[sel], values[sel], target[sel]
        capped.append((positions, values, target))
    pos_b, val_b, tgt_b, mask_b, _, bounds_b = shard_clouds_host(capped, sigma, sp, ignore_index, per)
    mask_b = mask_b & (tgt_b != DUMMY_TARGET)
    batch = dict(pos_s=pos_b, val_s=val_b, tgt_s=tgt_b, mask_s=mask_b, bounds=bounds_b)
    if not hybrid:
        batch = {k: v[0] for k, v in batch.items()}
    return batch, real


def _test_metrics(loss_fn, state: TrainState, host: dict, device, mesh: Mesh | None) -> dict:
    """A test forward's loss and per-class counts: one device over the
    whole batch, or with ``mesh`` (--dp) each rank over its slice, the loss
    pmean'd and the counts psum'd."""
    batch = to_device(host, device) if mesh is None else shard_batch(host, mesh, "dp", device)
    with torch.no_grad():
        _, metrics = loss_fn(state.params, batch, None, train=False)
    if mesh is None:
        return metrics
    counts = mesh.psum_tree({k: metrics[k] for k in ("iou_intersection", "iou_union")}, "dp")
    return dict(counts, loss=mesh.pmean_tree({"loss": metrics["loss"]}, "dp")["loss"])


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="path to a .cfg file (configuru format)")
    ap.add_argument("--max-epochs", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=0, help="static point budget (0 = auto)")
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--resume", default="", help="checkpoint to restore the full train state from")
    ap.add_argument("--dp", action="store_true", help="data-parallel over the ranks (one a card)")
    ap.add_argument(
        "--sp", type=int, default=0,
        help="stripe each cloud's vertex table over N ranks (lattice sharding with ghost-point "
        "halos); with --dp, a hybrid 2-axis mesh batching clouds over the remaining ranks",
    )  # fmt: skip
    ap.add_argument(
        "--sp-approx", action="store_true",
        help="allow stripes narrower than the receptive band (boundary results become "
        "approximate instead of raising)",
    )  # fmt: skip
    ap.add_argument("--ranks", type=int, default=None, help="rank count (default: one a visible card)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="process-group backend (default nccl; gloo lets ranks share a card)")  # fmt: skip
    ap.add_argument(
        "overrides",
        nargs="*",
        help="config overrides of the form section.key=value (e.g. train.lr=0.003)",
    )
    args = ap.parse_intermixed_args()  # section.key=value overrides may follow the options
    run(
        args.config, args.max_epochs, args.n_points, args.eval_every,
        args.resume, args.dp, args.overrides, sp=args.sp, sp_approx=args.sp_approx,
        ranks=args.ranks, backend=args.backend,
    )  # fmt: skip


if __name__ == "__main__":
    main()
