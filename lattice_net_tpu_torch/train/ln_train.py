"""Training CLI on the card:

    python -m lattice_net_tpu_torch.train.ln_train <config.cfg> [--max-epochs N]
        [--n-points N] [--eval-every N] [--resume ckpt] [section.key=value ...]

The JAX package's trainer (``lattice_net_tpu/train/ln_train.py``) in the
port: the same config schema and overrides, loaders (``toy``,
``synthkitti``, ``semantickitti``; the test phase reads the ``val`` split,
or ``test`` where there is none), ``"auto"`` class weights, static point
budget, phases, callbacks (TensorBoard scalars with
``train.with_tensorboard``), printed lines, sanity heuristics, checkpoints
and resume, and the same optimizer (cosine warm restarts for
SemanticKITTI, else ``reduce_on_plateau`` over each epoch's mean step
loss).  Each train step is ``make_train_step``'s, through the CUDA kernels
of ``ops_cuda``.

What differs, because it served the TPU runtime and not the training:

* there is no setup subprocess: the weights come from
  ``torch.Generator().manual_seed(0)`` (``TrainSetup``), and the first
  cloud's hierarchy is built once on the card for its sanity check;
* the test phase is a ``torch.no_grad()`` forward in eval mode
  (``train=False``) through ``make_loss_fn``.  The JAX trainer runs it
  through its train step with the update scaled by 0, in train mode, so the
  two agree only where the head's dropout is 0, as in every shipped config;
* the loader thread builds host numpy batches only; the copy to the card
  happens on the main thread.

The lattice convs run in bf16 on the card and in f32 on the CPU, the JAX
package's choice on its accelerator and on the CPU.  Options not ported
raise ``NotImplementedError``: ``--dp`` and ``--sp`` (ROADMAP queue 1, item
8), ``capacity_mode: "auto"`` (item 7), the ``scannet`` and ``shapenet``
datasets (item 4).
"""

from __future__ import annotations

import argparse
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
from lattice_net_tpu_torch.lattice.ops import check_positions
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.models.lnn import compute_class_weights, prepare_cloud
from lattice_net_tpu_torch.parallel.data_parallel import (
    TrainState,
    make_host_batch,
    make_loss_fn,
    make_train_step,
    to_device,
)
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
_UNPORTED_DATASETS = ("shapenet", "scannet")


def create_loader(dataset_name: str, cfg: dict, mode: str):
    """The dataset of a config's ``train.dataset_name``, for ``mode``
    ("train", "val" or "test")."""
    from lattice_net_tpu_torch.data.toy import ToyDataset
    from lattice_net_tpu_torch.data.transforms import TransformParams

    def transformer(loader_cfg):
        """The loader section's ``transformer`` block, or None; the recipe's
        keys are y-up, the procedural scenes and velodyne scans z-up."""
        if "transformer" not in loader_cfg:
            return None
        return TransformParams.from_config(loader_cfg["transformer"]).for_up_axis("z")

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
    if dataset_name in _UNPORTED_DATASETS:
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported (ROADMAP queue 1, item 4)"
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


def _host_batch(item, n_points: int):
    """A loader-thread batch: host numpy arrays, with the point masks of the
    tail-padding clouds cleared."""
    clouds, real = item
    batch = make_host_batch(clouds, n_points)
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
) -> TrainState:
    """Train the config's model for epochs up to ``max_epochs`` (from the
    resumed step's epoch with ``resume``), testing every ``eval_every``
    epochs; returns the final state.  ``device`` is the card unless
    ``"cpu"``."""
    device = resolve_device(device)
    if dp or sp:
        raise NotImplementedError(
            "--dp and --sp (data and lattice parallelism) are not ported (ROADMAP queue 1, item 8)"
        )
    cfg = apply_overrides(load_config(config_path), overrides)
    tp = TrainParams.from_config(cfg)
    lp = LatticeParams.from_config(cfg)

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
        caps = capacities_from_config(lp, mp.nr_downsamples)

    if n_points <= 0:  # static point budget: the next power of two over the first cloud
        first = loader_train.get_cloud(0)
        n_points = 1 << int(np.ceil(np.log2(max(len(first.V), 512))))
    # fixed-size clouds at the budget carry all-true masks: mask-free builds
    full_mask = getattr(loader_train, "fixed_n_points", None) == n_points
    if full_mask:
        print("fixed-size clouds: building mask-free")

    batch_size = max(1, tp.batch_size)
    steps_per_epoch = max(1, len(loader_train) // batch_size)
    conv_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    setup = TrainSetup.from_config(
        cfg, nr_classes, steps_per_epoch, device, conv_dtype, seed=0, capacities=caps
    )
    model, tx, sigma = setup.model, setup.tx, setup.sigma
    print(
        f"n_points={n_points} batch={batch_size} caps={caps} sigma={sigma} "
        f"classes={nr_classes} dp=False sp=0"
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
    if resume:
        state = load_checkpoint(resume, state)
        start_epoch = state.step // steps_per_epoch
        print(f"resumed {resume} at step {state.step} (epoch ~{start_epoch})")

    if class_weights is not None:
        class_weights = class_weights.to(device)
    common = dict(ignore_index=ignore_index, class_weights=class_weights, full_mask=full_mask)
    train_step = make_train_step(model, tx, sigma, mp.nr_downsamples, caps, **common)
    loss_fn = make_loss_fn(model, sigma, mp.nr_downsamples, caps, **common)

    cbs = [StateCallback(nr_classes, ignore_index), TimingCallback()]
    if tp.save_checkpoint:
        ckpt_dir = Path(tp.checkpoint_path or "checkpoints")
        cbs.append(CheckpointCallback(ckpt_dir, lambda: state, tx))
    if tp.with_tensorboard:
        cbs.append(TensorboardCallback("tensorboard_logs", tp.dataset_name))
    cb = CallbacksGroup(cbs)
    phases = [Phase("train", loader_train, grad=True), Phase("test", loader_test, grad=False)]

    for epoch in range(start_epoch, max_epochs):
        for phase in phases:
            if not phase.grad and epoch % eval_every != 0:
                continue
            cb.epoch_started(phase=phase)
            cb.phase_started(phase=phase)
            warned: set = set()
            gen = batched_clouds(
                phase.loader, mp, batch_size, n_points, drop_last=False,
                sigma=sigma, chunk_oversized=not phase.grad,
            )  # fmt: skip
            for host, real in prefetch_batches(gen, lambda item: _host_batch(item, n_points)):
                batch = to_device(host, device)
                if phase.grad:
                    state, metrics = train_step(state, batch, setup.generator)
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
                    with torch.no_grad():
                        _, metrics = loss_fn(state.params, batch, None, train=False)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="path to a .cfg file (configuru format)")
    ap.add_argument("--max-epochs", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=0, help="static point budget (0 = auto)")
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--resume", default="", help="checkpoint to restore the full train state from")
    ap.add_argument("--dp", action="store_true", help="data parallelism (not ported: raises)")
    ap.add_argument("--sp", type=int, default=0, help="lattice sharding (not ported: raises)")
    ap.add_argument(
        "overrides",
        nargs="*",
        help="config overrides of the form section.key=value (e.g. train.lr=0.003)",
    )
    args = ap.parse_args()
    run(
        args.config, args.max_epochs, args.n_points, args.eval_every,
        args.resume, args.dp, args.overrides, sp=args.sp,
    )  # fmt: skip


if __name__ == "__main__":
    main()
