"""Run the model on one cloud file and write visual diagnostics (the JAX
package's ``misc/lnn_eval_single_cloud.py`` in the port).

Loads one scan (KITTI ``.bin``, ``.pts`` text, or a ``.npy``/``.npz``
array), restores a checkpoint, labels every point (in chunks where the cloud
exceeds the point budget, ``train/ln_eval.predict_cloud_chunked``) and
writes prediction and confidence PLYs; the confidence is the first chunk's.

    python -m lattice_net_tpu_torch.misc.lnn_eval_single_cloud <config.cfg> \
        --cloud scan.bin --checkpoint last.ckpt -o /tmp/single
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.ops import default_conv_dtype
from lattice_net_tpu_torch.misc import viz
from lattice_net_tpu_torch.serve import Predictor
from lattice_net_tpu_torch.train.ln_eval import predict_cloud_chunked


def load_cloud(path: str):
    """(xyz (N, 3), intensity (N, 1)) float32 of a cloud file."""
    p = Path(path)
    if p.suffix == ".bin":
        raw = np.fromfile(p, dtype=np.float32).reshape(-1, 4)
        return raw[:, :3], raw[:, 3:4]
    if p.suffix == ".pts":
        xyz = np.loadtxt(p, dtype=np.float32).reshape(-1, 3)
        return xyz, np.zeros((len(xyz), 1), np.float32)
    if p.suffix == ".npy":
        xyz = np.load(p).astype(np.float32)
        return xyz[:, :3], np.zeros((len(xyz), 1), np.float32)
    if p.suffix == ".npz":
        with np.load(p) as z:
            xyz = z["points"].astype(np.float32)
        return xyz[:, :3], np.zeros((len(xyz), 1), np.float32)
    raise ValueError(f"unsupported cloud format {p.suffix}")


def evaluate(config, cloud, checkpoint="", nr_classes: int = 20, out="single_cloud_out", device=None):
    """The (N,) labels of the cloud file ``cloud`` by the model of
    ``config`` (a ``.cfg`` path or a parsed config), with the PLYs written
    under ``out``; the point budget is the next power of two over the cloud
    (at most 2^17).  ``device`` is the card unless ``"cpu"``."""
    device = resolve_device(device)
    xyz, _ = load_cloud(cloud)
    values = np.zeros((len(xyz), 1), np.float32)
    n_points = 1 << int(np.ceil(np.log2(max(min(len(xyz), 1 << 17), 512))))
    conv_dtype = default_conv_dtype(device)
    predictor = Predictor.from_config(config, nr_classes, device, conv_dtype, n_points=n_points,
                                      checkpoint=checkpoint)  # fmt: skip
    if checkpoint:
        print(f"restored {checkpoint}")
    pred = predict_cloud_chunked(predictor.predict, (xyz, values, None), n_points)
    logp0, _ = predictor.forward(xyz[:n_points], values[:n_points])
    logp0 = logp0[: min(len(xyz), n_points)].float().cpu().numpy()
    out = Path(out)
    viz.prediction_cloud(out / "prediction.ply", xyz, pred, nr_classes)
    viz.confidence_cloud(out / "confidence.ply", xyz[: len(logp0)], logp0)
    counts = np.bincount(pred, minlength=nr_classes)
    for c in np.nonzero(counts)[0]:
        print(f"class {c}: {counts[c]} points")
    print(f"PLYs written to {out}/")
    return pred


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--cloud", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--nr-classes", type=int, default=20)
    ap.add_argument("-o", "--out", default="single_cloud_out")
    args = ap.parse_args()
    evaluate(args.config, args.cloud, args.checkpoint, args.nr_classes, args.out)


if __name__ == "__main__":
    main()
