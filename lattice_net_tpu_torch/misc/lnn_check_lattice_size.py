"""Lattice occupancy against sigma for a dataset (the JAX package's
``misc/lnn_check_lattice_size.py``): the vertices and points a vertex of
the first train cloud at a sweep of sigmas, to pick sigma and capacity
before training.

    python -m lattice_net_tpu_torch.misc.lnn_check_lattice_size <config.cfg>
        [--device cuda|cpu] [section.key=value ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lattice_net_tpu_torch.config import LatticeParams, TrainParams, apply_overrides, load_config
from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice.structure import build_structure
from lattice_net_tpu_torch.train.ln_train import create_loader

FACTORS = (0.25, 0.5, 1.0, 2.0, 4.0)


def run(config_path, sigmas=None, overrides=(), device=None) -> list:
    """``(sigma, vertices, overflow)`` a sigma (default: the config's first
    sigma times ``FACTORS``), the level-0 build of the first train cloud's
    xyz at the config's capacity; prints a line each."""
    device = resolve_device(device)
    cfg = apply_overrides(load_config(config_path), overrides)
    tp, lp = TrainParams.from_config(cfg), LatticeParams.from_config(cfg)
    cloud = create_loader(tp.dataset_name, cfg, "train").get_cloud(0)
    pos = torch.from_numpy(np.asarray(cloud.V, np.float32)).to(device)
    n, cap = len(cloud.V), lp.hash_table_capacity
    sigmas = sigmas or [lp.sigmas[0] * f for f in FACTORS]
    print(f"{n} points, capacity {cap}")
    out = []
    for s in sigmas:
        with torch.inference_mode():
            st = build_structure(pos, float(s), cap)[0]
        nv, ov = int(st.nr_verts), int(st.nr_overflow)
        print(f"sigma {s:8.4f}: {nv:8d} vertices ({n / max(nv, 1):8.1f} pts/vertex)" + (f"  OVERFLOW {ov}" if ov else ""))
        out.append((float(s), nv, ov))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="config overrides (section.key=value)")
    a = ap.parse_args()
    run(a.config, overrides=a.overrides, device=a.device)


if __name__ == "__main__":
    main()
