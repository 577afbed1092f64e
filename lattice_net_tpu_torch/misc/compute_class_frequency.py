"""Per-class point frequencies over a dataset's train split (the JAX
package's ``misc/compute_class_frequency.py``); they feed
``models.lnn.compute_class_weights``.

    python -m lattice_net_tpu_torch.misc.compute_class_frequency <config.cfg>
        [--max-clouds N] [section.key=value ...]
"""

from __future__ import annotations

import argparse

import numpy as np

from lattice_net_tpu_torch.config import TrainParams, apply_overrides, load_config
from lattice_net_tpu_torch.train.ln_train import create_loader


def run(config_path, max_clouds: int = 0, overrides=()) -> np.ndarray:
    """The (nr_classes,) frequencies of the train split's labels (labels
    outside the classes clip to the nearest class, as in JAX); prints each
    class's count."""
    cfg = apply_overrides(load_config(config_path), overrides)
    tp = TrainParams.from_config(cfg)
    loader = create_loader(tp.dataset_name, cfg, "train")
    counts = np.zeros(loader.nr_classes, np.int64)
    for i, cloud in enumerate(loader):
        labels = np.asarray(cloud.L_gt).reshape(-1)
        counts += np.bincount(np.clip(labels, 0, loader.nr_classes - 1), minlength=loader.nr_classes)
        if max_clouds and i + 1 >= max_clouds:
            break
    freq = counts / max(counts.sum(), 1)
    for c, (n, f) in enumerate(zip(counts, freq)):
        print(f"class {c}: {n} points ({f:.6f})")
    print("frequencies:", [round(float(f), 6) for f in freq])
    return freq


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--max-clouds", type=int, default=0)
    ap.add_argument("overrides", nargs="*", help="config overrides (section.key=value)")
    a = ap.parse_args()
    run(a.config, a.max_clouds, a.overrides)


if __name__ == "__main__":
    main()
