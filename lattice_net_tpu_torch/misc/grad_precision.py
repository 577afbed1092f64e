"""How precise the f32 gradients of one train step are, against f64.

    python -m lattice_net_tpu_torch.misc.grad_precision

The SemanticKITTI train config at full width (seeded random weights, seed
1) on a 6000-point synthetic scan padded to 8192 points: one loss and its
gradients in f64 on the CPU, in f32 on the CPU, and, where a card is
present, in f32 on the card.  The hierarchy is built once in f32, so every
run sees the same lattice.  Prints one JSON line per f32 run with each
parameter's relative L2 error against f64 (the largest first) and the loss
difference.  ``chip_smoke.py``'s card-vs-CPU tolerance rests on these.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.func import functional_call

from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.losses import segmentation_loss
from lattice_net_tpu_torch.models.lnn import ModelParams, prepare_cloud
from lattice_net_tpu_torch.parallel.data_parallel import make_batch
from lattice_net_tpu_torch.train.setup import TrainSetup

CONFIG = Path(__file__).resolve().parents[2] / "config" / "lnn_train_semantic_kitti.cfg"
NR_CLASSES = 20
WORST = 8


def loss_and_grads(device, dtype):
    run = TrainSetup.from_config(CONFIG, NR_CLASSES, 1, device=device, conv_dtype=dtype, seed=1)
    cloud = prepare_cloud(make_scene(6000, seed=11), ModelParams(values_mode="none"))
    b = {k: v[0] for k, v in make_batch([cloud], 1 << 13, device=device).items()}
    h = build_hierarchy(
        b["positions"], run.sigma, run.model.params.nr_downsamples, run.capacities,
        point_mask=b["point_mask"], point_feats=b["values"],
    )  # fmt: skip
    h.edges.rows = h.edges.rows.to(dtype)
    h.splat_weights = h.splat_weights.to(dtype)
    params = {k: v.detach().to(dtype).requires_grad_() for k, v in run.model.state_dict().items()}
    inputs = (h, b["positions"].to(dtype), b["values"].to(dtype))
    logp, _ = functional_call(run.model, params, inputs)
    loss = segmentation_loss(logp, b["target"], point_mask=b["point_mask"])
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.detach().double().cpu() for k, g in zip(params, grads)}


def main():
    loss64, ref = loss_and_grads("cpu", torch.float64)
    runs = [("cpu", "cpu f32")] + ([("cuda", "card f32")] if torch.cuda.is_available() else [])
    for device, label in runs:
        loss, grads = loss_and_grads(device, torch.float32)
        rel = {k: ((grads[k] - w).norm() / w.norm().clamp(min=1e-30)).item() for k, w in ref.items()}
        worst = sorted(rel, key=rel.get, reverse=True)[:WORST]
        print(json.dumps(dict(
            run=label, loss_abs_diff=abs(loss - loss64), max_grad_rel_l2=rel[worst[0]],
            worst=[dict(param=k, rel_l2=rel[k]) for k in worst],
        )), flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
