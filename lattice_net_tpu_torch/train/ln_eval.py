"""Evaluation CLI on the card:

    python -m lattice_net_tpu_torch.train.ln_eval <config.cfg> [--checkpoint ckpt]
        [--write-predictions] [--n-points N] [section.key=value ...]

The JAX package's ``ln_eval`` (``lattice_net_tpu/train/ln_eval.py``) in the
port: it restores a checkpoint, labels every point of every scan of the
config's test split, accumulates per-class IoU, and writes benchmark-server
submissions (SemanticKITTI ``.label`` files at
``sequences/<seq>/predictions/<scan>.label``, one text file a cloud
otherwise).

A cloud larger than the point budget is split into consecutive chunks, each
with its own lattice hierarchy, at the JAX package's chunk bounds, so every
point gets exactly one label.  Scans are read by index (``get_cloud``), so
each output is named by its scan's identity.

What differs, because it served the TPU runtime and not the evaluation:
there is no setup subprocess and no un-jitted predictor variant; eval is a
plain forward under ``torch.inference_mode``.  The lattice convs run in bf16
on the card and in f32 on the CPU.  ``--sp`` (lattice-sharded prediction)
raises ``NotImplementedError`` (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from lattice_net_tpu_torch.config import EvalParams, apply_overrides, load_config
from lattice_net_tpu_torch.data.semantic_kitti import write_kitti_label_file
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import check_positions
from lattice_net_tpu_torch.models.lnn import prepare_cloud
from lattice_net_tpu_torch.serve import Predictor
from lattice_net_tpu_torch.train.callbacks import Scores, iou_counts
from lattice_net_tpu_torch.train.ln_train import create_loader


def predict_cloud_chunked(predict, prepared, n_points: int) -> np.ndarray:
    """(N,) int32 labels of all N points of ``prepared`` (positions, values,
    target), ``predict(positions, values)`` on consecutive slices of at most
    ``n_points`` points (``Predictor.predict``).  Each chunk builds its own
    hierarchy, so a point's receptive field ends at its chunk."""
    positions, values, _ = prepared
    n = positions.shape[0]
    preds = np.empty(n, np.int32)
    for start in range(0, n, n_points):
        stop = min(start + n_points, n)
        preds[start:stop] = predict(positions[start:stop], values[start:stop])
    return preds


def unstripe_predictions(lab_s, ids_s, n: int) -> np.ndarray:
    """Scatter per-stripe predictions back to the original point order.

    ``lab_s`` (n_shards, per) predictions, ``ids_s`` (n_shards, per) original
    point indices (-1 = padding).  Every real point appears exactly once
    across stripes."""
    lab = np.asarray(lab_s).reshape(-1)
    ids = np.asarray(ids_s).reshape(-1)
    preds = np.empty(n, np.int32)
    preds[ids[ids >= 0]] = lab[ids >= 0]
    return preds


@dataclasses.dataclass
class EvalSetup:
    """What the eval tools share: the config's eval section, its test
    loader, and a predictor with the restored weights at the point budget."""

    ep: EvalParams
    loader: object
    nr_classes: int
    ignore_index: int
    predictor: Predictor

    @property
    def n_points(self) -> int:
        return self.predictor.n_points


def setup_predictor(config_path, checkpoint: str = "", overrides=(), n_points: int = 0, sp: int = 0,
                    device=None) -> EvalSetup:  # fmt: skip
    """The config's test loader and a :class:`Predictor` with the weights of
    ``checkpoint`` (default: the config's ``eval.checkpoint_path``; empty:
    seeded random weights, which it prints).  The point budget defaults to
    the next power of two over the first test cloud (at least 512)."""
    device = resolve_device(device)
    if sp:
        raise NotImplementedError("--sp (lattice-sharded prediction) is not ported (ROADMAP queue 1, item 8)")
    cfg = apply_overrides(load_config(config_path), overrides)
    ep = EvalParams.from_config(cfg)
    checkpoint = checkpoint or ep.checkpoint_path
    loader = create_loader(ep.dataset_name, cfg, "test")
    first = loader.get_cloud(0)
    n_points = n_points or 1 << int(np.ceil(np.log2(max(len(first.V), 512))))
    conv_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    predictor = Predictor.from_config(
        cfg, loader.nr_classes, device, conv_dtype, n_points=n_points, checkpoint=checkpoint
    )
    if checkpoint:
        print(f"restored checkpoint {checkpoint}")
    else:
        print("no checkpoint: seeded random weights (torch.Generator().manual_seed(0))")
    ignore_index = getattr(loader, "ignore_index", -1)
    return EvalSetup(ep, loader, loader.nr_classes, ignore_index, predictor)


def output_path(dataset_name: str, out_dir: Path, name: str) -> Path:
    """Where a scan's predictions go: for SemanticKITTI the server layout
    ``sequences/<seq>/predictions/<scan>.label`` of a ``"<seq>/<scan>"``
    name, else ``pred_<name>.txt``."""
    if dataset_name != "semantickitti":
        return out_dir / f"pred_{name}.txt"
    seq, _, scan = name.partition("/")
    if not scan:
        return out_dir / f"{name}.label"
    return out_dir / "sequences" / seq / "predictions" / f"{scan}.label"


def run(
    config_path,
    checkpoint: str = "",
    write_predictions: bool | None = None,
    overrides=(),
    n_points: int = 0,
    sp: int = 0,
    device=None,
) -> float:
    """Label every scan of the config's test split and return the mIoU;
    writes the predictions when ``write_predictions`` (default: the
    config's ``eval.do_write_predictions``).  ``device`` is the card unless
    ``"cpu"``."""
    s = setup_predictor(config_path, checkpoint, overrides, n_points, sp, device)
    ep, loader, pred_fn = s.ep, s.loader, s.predictor.predict
    do_write = ep.do_write_predictions if write_predictions is None else write_predictions
    out_dir = Path(ep.output_predictions_path or "predictions")
    sigma = s.predictor.sigma
    scores = Scores()
    chunks = 0
    t0 = time.perf_counter()
    for i in range(len(loader)):
        cloud = loader.get_cloud(i)
        prepared = prepare_cloud(cloud, s.predictor.params)
        check_positions(prepared[0], prepared[1], sigma=sigma)
        pred = predict_cloud_chunked(pred_fn, prepared, s.n_points)
        chunks += -(-len(pred) // s.n_points)
        scores.accumulate(*iou_counts(pred, prepared[2], s.nr_classes, s.ignore_index))
        if do_write:
            path = output_path(ep.dataset_name, out_dir, cloud.name or f"{i:06d}")
            if ep.dataset_name == "semantickitti":
                write_kitti_label_file(path, pred)
            else:
                path.parent.mkdir(parents=True, exist_ok=True)
                np.savetxt(path, pred, fmt="%d")
    seconds = time.perf_counter() - t0  # each scan's labels reach the host: no work left on the card
    n = len(loader)
    print(f"evaluated {n} scans in {chunks} chunks of {s.n_points} points in {seconds:.4f} s "
          f"({seconds / n:.4f} s/scan, {n / seconds:.2f} scans/s)")  # fmt: skip
    names = getattr(loader, "label_names", lambda: None)()
    miou = scores.avg_class_iou(print_per_class=True, class_names=names)
    print(f"mIoU: {miou:.4f}")
    return miou


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--write-predictions", action="store_true", default=None)
    ap.add_argument(
        "--n-points", type=int, default=0,
        help="per-chunk point budget (0 = fit the first cloud whole); smaller values force chunked "
        "prediction, to measure the chunked-vs-whole receptive-field gap",
    )  # fmt: skip
    ap.add_argument("--sp", type=int, default=0, help="lattice-sharded prediction (not ported: raises)")
    ap.add_argument("overrides", nargs="*", help="config overrides of the form section.key=value")
    args = ap.parse_args()
    run(args.config, args.checkpoint, args.write_predictions, args.overrides, args.n_points, sp=args.sp)


if __name__ == "__main__":
    main()
