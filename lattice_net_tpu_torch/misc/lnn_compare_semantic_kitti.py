"""Compare two sets of SemanticKITTI predictions point by point (a copy of
``lattice_net_tpu/misc/lnn_compare_semantic_kitti.py``).

Given a scan, its ground-truth labels and one or two prediction ``.label``
files, prints each prediction's accuracy on the labelled points and their
agreement, and writes PLY clouds (each prediction, its difference to the
ground truth, and where the two disagree) for any point-cloud viewer.

    python -m lattice_net_tpu_torch.misc.lnn_compare_semantic_kitti \
        --scan .../08/velodyne/000000.bin --gt .../08/labels/000000.label \
        --pred-a ours/000000.label --pred-b other/000000.label -o /tmp/cmp
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.semantic_kitti import NR_CLASSES, remap_labels
from lattice_net_tpu_torch.misc import viz


def load_labels(path) -> np.ndarray:
    return remap_labels(np.fromfile(path, dtype=np.uint32))


def compare(scan, gt, pred_a, pred_b="", out="compare_out") -> dict:
    """Accuracy of each prediction on the labelled points (and the two
    predictions' agreement), with the PLY clouds written under ``out``."""
    xyz = np.fromfile(scan, dtype=np.float32).reshape(-1, 4)[:, :3]
    gt = load_labels(gt)
    preds = {"a": load_labels(pred_a)}
    if pred_b:
        preds["b"] = load_labels(pred_b)
    out = Path(out)
    valid = gt != 0  # class 0 = unlabeled
    result = {}
    for name, p in preds.items():
        if len(p) != len(xyz):
            raise ValueError(f"pred_{name}: {len(p)} labels for {len(xyz)} points")
        acc = float(np.mean(p[valid] == gt[valid])) if valid.any() else float("nan")
        result[f"accuracy_{name}"] = acc
        print(f"pred_{name}: accuracy vs GT (labeled points) = {acc:.4f}")
        viz.prediction_cloud(out / f"pred_{name}.ply", xyz, p, NR_CLASSES)
        viz.diff_cloud(out / f"diff_{name}.ply", xyz, p, gt, ignore_index=0)
    if len(preds) == 2:
        a, b = preds["a"], preds["b"]
        result["agreement"] = float(np.mean(a == b))
        print(f"agreement a vs b = {result['agreement']:.4f}")
        # grey where the two agree, a's class colour where they do not
        cmap = viz.class_color_map(NR_CLASSES)
        rgb = np.where((a == b)[:, None], np.array([[90, 90, 90]]), cmap[np.clip(a, 0, NR_CLASSES - 1)])
        viz.write_ply(out / "disagreement.ply", xyz, rgb)
    print(f"PLY clouds written to {out}/")
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scan", required=True, help="velodyne .bin")
    ap.add_argument("--gt", required=True, help="ground-truth .label")
    ap.add_argument("--pred-a", required=True, help="first prediction .label (e.g. ours)")
    ap.add_argument("--pred-b", default="", help="optional second prediction .label")
    ap.add_argument("-o", "--out", default="compare_out")
    args = ap.parse_args()
    compare(args.scan, args.gt, args.pred_a, args.pred_b, args.out)


if __name__ == "__main__":
    main()
