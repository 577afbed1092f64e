"""Headless teaser-figure maker (the JAX package's ``misc/lnn_make_teaser.py``).

    python -m lattice_net_tpu_torch.misc.lnn_make_teaser <config.cfg> \\
        [--checkpoint ckpt] [--clouds 0 5 9] [--out teaser/] [--max-points N] \\
        [--device cuda|cpu] [section.key=value ...]

For each selected cloud of the config's test split it predicts the labels
(``ln_eval.setup_predictor``, chunked at the point budget) and writes, under
``<out>/<cloud name>/``, a self-contained interactive HTML viewer of the
prediction and of the ground truth (``misc/viz_html.py``) and PLY dumps of
both and of the ground-truth-vs-prediction difference (``misc/viz.py``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.misc import viz
from lattice_net_tpu_torch.misc.viz_html import write_html_viewer
from lattice_net_tpu_torch.models.lnn import prepare_cloud
from lattice_net_tpu_torch.train.ln_eval import predict_cloud_chunked, setup_predictor


def run(config, checkpoint="", clouds=(0,), out="teaser", max_points=400_000, overrides=(), device=None) -> list:
    """Writes the files of the module docstring; returns ``(index, dir,
    accuracy)`` a cloud."""
    s = setup_predictor(config, checkpoint, overrides, device=device)
    mp, nr_classes, ignore_index = s.predictor.params, s.nr_classes, s.ignore_index
    cmap = viz.class_color_map(nr_classes)
    done = []
    for idx in clouds:
        cloud = s.loader.get_cloud(idx)
        prepared = prepare_cloud(cloud, mp)
        pred = predict_cloud_chunked(s.predictor.predict, prepared, s.n_points)
        xyz = np.asarray(prepared[0][:, :3])
        target = np.asarray(prepared[2])
        name = (getattr(cloud, "name", None) or f"{idx:06d}").replace("/", "_")
        d = Path(out) / name
        viz.prediction_cloud(d / "prediction.ply", xyz, pred, nr_classes)
        viz.prediction_cloud(d / "gt.ply", xyz, np.maximum(target, 0), nr_classes)
        viz.diff_cloud(d / "diff.ply", xyz, pred, target, ignore_index)
        write_html_viewer(d / "prediction.html", xyz, cmap[pred % nr_classes], title=f"{name} prediction",
                          max_points=max_points)  # fmt: skip
        write_html_viewer(d / "gt.html", xyz, cmap[np.maximum(target, 0) % nr_classes],
                          title=f"{name} ground truth", max_points=max_points)  # fmt: skip
        labelled = target != ignore_index
        acc = float((pred == target)[labelled].mean()) if labelled.any() else 1.0
        print(f"cloud {idx} ({name}): {len(xyz)} pts, acc={acc:.4f} -> {d}/")
        done.append((idx, d, acc))
    return done


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default="", help="defaults to eval.checkpoint_path")
    ap.add_argument("--clouds", type=int, nargs="+", default=[0], help="cloud indices to render")
    ap.add_argument("--out", default="teaser", help="output directory")
    ap.add_argument("--max-points", type=int, default=400_000, help="HTML subsample cap")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="config overrides (section.key=value)")
    a = ap.parse_args()
    run(a.config, a.checkpoint, a.clouds, a.out, a.max_points, a.overrides, a.device)


if __name__ == "__main__":
    main()
