"""Where one served scan spends its time on the card.

    python -m lattice_net_tpu_torch.misc.profile_serve

Serves six synthetic 2^17-point scans through ``Predictor`` on the
SemanticKITTI eval config (full width, seeded random weights) and prints
JSON lines:

* ``stages``: per scan, CUDA-event times of the three stages of
  ``Predictor.forward`` (padding and copy to the card, ``build_hierarchy``,
  the LNN forward with the argmax), after two warm-up scans;
* ``profile``: a ``torch.profiler`` capture of two served scans: the wall
  time, the summed device time of all kernels, the device's idle share
  (1 - the union of its operations' intervals / wall), the kernels that
  take the most device time and the port's spans (``tracing.SPANS``:
  calls and wall ms of each).

Runs on a CUDA card only (the default device raises elsewhere).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.lattice.structure import build_hierarchy
from lattice_net_tpu_torch.misc.profiling import profile
from lattice_net_tpu_torch.models.lnn import prepare_cloud
from lattice_net_tpu_torch.serve import Predictor

CONFIG = Path(__file__).resolve().parents[2] / "config" / "lnn_eval_semantic_kitti.cfg"
NR_CLASSES = 20
SCANS = 6


def _stage_times(pred: Predictor, positions, values):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        ev[0].record()
        pos, val, mask = pred._batch(positions, values)
        ev[1].record()
        h = build_hierarchy(
            pos, pred.sigma, pred.params.nr_downsamples, pred.capacities,
            point_mask=mask, point_feats=val,
        )  # fmt: skip
        ev[2].record()
        logp, _ = pred.model(h, pos, val)
        labels = torch.argmax(logp, dim=-1)
        ev[3].record()
    ev[3].synchronize()
    names = ("batch_ms", "build_ms", "model_ms")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["total_ms"] = ev[0].elapsed_time(ev[3])
    del labels
    return out


def main():
    pred = Predictor.from_config(CONFIG, nr_classes=NR_CLASSES, seed=0)
    clouds = [prepare_cloud(make_scene(1 << 17, seed=s), pred.params)[:2] for s in range(SCANS)]
    for pos, val in clouds[:2]:
        pred.predict(pos, val)
    for i, (pos, val) in enumerate(clouds):
        print(json.dumps(dict(stages=i, **_stage_times(pred, pos, val))), flush=True)

    def two_scans():
        for pos, val in clouds[:2]:
            pred.predict(pos, val)

    print(json.dumps(dict(profile="2 served scans", **profile(two_scans, pred.device, 1))), flush=True)


if __name__ == "__main__":
    main()
