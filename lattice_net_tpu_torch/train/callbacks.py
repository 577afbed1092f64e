"""Training callbacks, phases and streaming IoU scores (counterpart of
``lattice_net_tpu/train/callbacks.py``).

The hook names that the trainer dispatches (``after_forward_pass`` /
``epoch_started`` / ``epoch_ended`` / ``phase_started`` / ``phase_ended``;
the JAX package's ``before_forward_pass`` and ``after_backward_pass``, which
neither trainer calls, are left out), the ``Phase`` state, the per-class
intersection/union accumulator, the printed lines and the checkpoint and
CSV names are the JAX package's.  ``Scores.accumulate`` takes per-class
counts that the step already reduced on the device
(:func:`iou_counts_device`): only (nr_classes,) vectors reach the host.
``PlyDumpCallback`` writes the JAX package's PLY and HTML files byte for
byte from the same arrays.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np
import torch


def iou_counts_device(logp, target, nr_classes: int, ignore_index: int = -1, point_mask=None):
    """(nr_classes,) int64 intersection and union of the argmax labels with
    the targets over valid points; stays on the device."""
    pred = torch.argmax(logp, dim=-1)
    valid = target != ignore_index
    if point_mask is not None:
        valid = valid & point_mask
    classes = torch.arange(nr_classes, device=logp.device)
    p = (pred[:, None] == classes) & valid[:, None]
    t = (target[:, None] == classes) & valid[:, None]
    return (p & t).sum(dim=0), (p | t).sum(dim=0)


def iou_counts(pred: np.ndarray, target: np.ndarray, nr_classes: int, ignore_index: int = -1):
    """Per-class (intersection, union) of one sample's numpy labels."""
    valid = target != ignore_index
    pred, target = pred[valid], target[valid]
    inter = np.zeros(nr_classes, np.int64)
    union = np.zeros(nr_classes, np.int64)
    for c in range(nr_classes):
        p = pred == c
        t = target == c
        inter[c] = np.sum(p & t)
        union[c] = np.sum(p | t)
    return inter, union


class Callback:
    """The hook surface; every hook does nothing."""

    def after_forward_pass(self, **kw):
        pass

    def epoch_started(self, **kw):
        pass

    def epoch_ended(self, **kw):
        pass

    def phase_started(self, **kw):
        pass

    def phase_ended(self, **kw):
        pass


class CallbacksGroup(Callback):
    """Dispatches every hook to each member, in order."""

    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def _dispatch(self, name, **kw):
        for cb in self.callbacks:
            getattr(cb, name)(**kw)

    def after_forward_pass(self, **kw):
        self._dispatch("after_forward_pass", **kw)

    def epoch_started(self, **kw):
        self._dispatch("epoch_started", **kw)

    def epoch_ended(self, **kw):
        self._dispatch("epoch_ended", **kw)

    def phase_started(self, **kw):
        self._dispatch("phase_started", **kw)

    def phase_ended(self, **kw):
        self._dispatch("phase_ended", **kw)


class Scores:
    """Streaming mIoU accumulator."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.intersection = None
        self.union = None
        self.best_iou = -1.0
        self.best_epoch = -1

    def accumulate(self, inter, union):
        inter = np.asarray(inter, np.int64)
        union = np.asarray(union, np.int64)
        if self.intersection is None:
            self.intersection = np.zeros_like(inter)
            self.union = np.zeros_like(union)
        self.intersection += inter
        self.union += union

    def per_class_iou(self) -> np.ndarray:
        if self.intersection is None:
            return np.zeros(0)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.union > 0, self.intersection / np.maximum(self.union, 1), np.nan)

    def avg_class_iou(self, print_per_class: bool = False, class_names=None) -> float:
        iou = self.per_class_iou()
        if print_per_class and iou.size:
            for c, v in enumerate(iou):
                name = class_names[c] if class_names else f"class_{c}"
                print(f"  {name}: iou {v:.4f}")
        return float(np.nanmean(iou)) if iou.size else 0.0

    def update_best(self, epoch: int) -> bool:
        miou = self.avg_class_iou()
        if miou > self.best_iou:
            self.best_iou = miou
            self.best_epoch = epoch
            return True
        return False

    def write_iou_to_csv(self, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["class", "iou"])
            for c, v in enumerate(self.per_class_iou()):
                w.writerow([c, v])
            w.writerow(["mean", self.avg_class_iou()])


class Phase:
    """Train/test phase state."""

    def __init__(self, name: str, loader, grad: bool):
        self.name = name
        self.loader = loader
        self.grad = grad
        self.epoch_nr = 0
        self.samples_processed_this_epoch = 0
        self.iter_nr = 0
        self.scores = Scores()
        self.loss_acum_per_epoch = 0.0


class StateCallback(Callback):
    """Loss and IoU accumulation, and the per-epoch summary line."""

    def __init__(self, nr_classes: int, ignore_index: int = -1):
        self.nr_classes = nr_classes
        self.ignore_index = ignore_index

    def after_forward_pass(self, phase: Phase = None, loss: float = 0.0, inter=None, union=None, **kw):
        phase.loss_acum_per_epoch += float(loss)
        phase.samples_processed_this_epoch += 1
        phase.iter_nr += 1
        if inter is not None:
            phase.scores.accumulate(inter, union)

    def epoch_started(self, phase: Phase = None, **kw):
        phase.loss_acum_per_epoch = 0.0
        phase.samples_processed_this_epoch = 0
        phase.scores.intersection = None
        phase.scores.union = None

    def epoch_ended(self, phase: Phase = None, **kw):
        n = max(phase.samples_processed_this_epoch, 1)
        miou = phase.scores.avg_class_iou()
        print(
            f"[{phase.name}] epoch {phase.epoch_nr}: "
            f"loss {phase.loss_acum_per_epoch / n:.4f}  mIoU {miou:.4f}"
        )
        phase.epoch_nr += 1


class CheckpointCallback(Callback):
    """At each test epoch's end, the full train state to ``last.ckpt``, and
    to ``model_e_{epoch}_{miou:.4f}.ckpt`` with ``iou_e_{epoch}.csv`` when
    the mIoU is the best so far.  ``get_state()`` gives the run's current
    state, of the optimizer ``tx``."""

    def __init__(self, checkpoint_dir, get_state, tx):
        self.dir = Path(checkpoint_dir)
        self.get_state = get_state
        self.tx = tx

    def epoch_ended(self, phase: Phase = None, **kw):
        if phase.grad:  # save on test phases
            return
        from lattice_net_tpu_torch.train.checkpoint import save_checkpoint

        state = self.get_state()
        save_checkpoint(self.dir / "last.ckpt", state, self.tx)
        if phase.scores.update_best(phase.epoch_nr):
            miou = phase.scores.best_iou
            save_checkpoint(self.dir / f"model_e_{phase.epoch_nr}_{miou:.4f}.ckpt", state, self.tx)
            phase.scores.write_iou_to_csv(self.dir / f"iou_e_{phase.epoch_nr}.csv")


class TensorboardCallback(Callback):
    """TensorBoard scalars under ``<logdir>/<experiment_name>``: each
    phase's loss every 10 forwards and its mIoU at each epoch's end.  A
    no-op, which it prints, where ``torch.utils.tensorboard`` cannot be
    imported."""

    def __init__(self, logdir, experiment_name="lnn"):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"tensorboard: not logging ({e})")
            return
        self.writer = SummaryWriter(str(Path(logdir) / experiment_name))

    def after_forward_pass(self, phase: Phase = None, loss: float = 0.0, **kw):
        if self.writer and phase.iter_nr % 10 == 0:
            self.writer.add_scalar(f"{phase.name}/loss", float(loss), phase.iter_nr)

    def epoch_ended(self, phase: Phase = None, **kw):
        if self.writer:
            self.writer.add_scalar(f"{phase.name}/miou", phase.scores.avg_class_iou(), phase.epoch_nr)
            self.writer.flush()


class PlyDumpCallback(Callback):
    """At the end of each ``every_n_epochs``-th test phase, the last sample's
    prediction cloud and difference-to-target cloud as PLY files under
    ``<out_dir>/epoch_<n>/`` (``prediction.ply``, ``diff.ply``), and with
    ``html`` a ``prediction.html`` viewer.  Feed it host arrays through
    ``after_forward_pass`` keywords ``positions``, ``pred`` and ``target``;
    forwards without them are skipped, as are train phases."""

    def __init__(self, out_dir, nr_classes: int, ignore_index: int = -1, every_n_epochs: int = 1,
                 html: bool = False):  # fmt: skip
        self.out_dir = Path(out_dir)
        self.nr_classes = nr_classes
        self.ignore_index = ignore_index
        self.every = max(1, every_n_epochs)
        self.html = html
        self._last = None

    def after_forward_pass(self, phase=None, positions=None, pred=None, target=None, **kw):
        if positions is not None and pred is not None:
            self._last = (np.asarray(positions), np.asarray(pred), target)

    def epoch_ended(self, phase: Phase = None, **kw):
        if phase.grad or self._last is None or phase.epoch_nr % self.every:
            return
        from lattice_net_tpu_torch.misc import viz

        positions, pred, target = self._last
        d = self.out_dir / f"epoch_{phase.epoch_nr}"
        viz.prediction_cloud(d / "prediction.ply", positions[:, :3], pred, self.nr_classes)
        if target is not None:
            viz.diff_cloud(d / "diff.ply", positions[:, :3], pred, np.asarray(target), self.ignore_index)
        if self.html:
            from lattice_net_tpu_torch.misc.viz_html import write_html_viewer

            colors = viz.class_color_map(self.nr_classes)[np.asarray(pred) % self.nr_classes]
            write_html_viewer(d / "prediction.html", positions[:, :3], colors,
                              title=f"epoch {phase.epoch_nr} prediction")  # fmt: skip
        self._last = None


class TimingCallback(Callback):
    """A phase's wall-clock time and samples per second."""

    def __init__(self):
        self.t0 = None

    def phase_started(self, phase: Phase = None, **kw):
        self.t0 = time.perf_counter()

    def phase_ended(self, phase: Phase = None, **kw):
        if self.t0 is None:
            return
        dt = time.perf_counter() - self.t0
        n = max(phase.samples_processed_this_epoch, 1)
        print(f"[{phase.name}] {n} samples in {dt:.1f}s ({n / dt:.2f} samples/s)")
