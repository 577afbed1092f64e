"""Package SemanticKITTI predictions into the benchmark-server layout (a
copy of ``lattice_net_tpu/misc/prepare_submission_semantickitti.py``).

Collects ``.label`` files from ``sequences/<seq>/predictions/``, checks that
each holds only submittable raw ids and, given the dataset, one uint32
label per point of its velodyne scan (the server rejects other counts), and
zips them.

    python -m lattice_net_tpu_torch.misc.prepare_submission_semantickitti \
        --predictions predictions/ --dataset /data/kitti --out submission.zip
"""

from __future__ import annotations

import argparse
import zipfile
from pathlib import Path

import numpy as np

from lattice_net_tpu_torch.data.semantic_kitti import LEARNING_MAP_INV, TEST_SEQUENCES


def prepare_submission(predictions, dataset="", out="submission.zip") -> tuple[int, int]:
    """Zip the ``.label`` files under ``predictions`` into ``out``; raises
    ``ValueError`` on a file with an id outside ``LEARNING_MAP_INV``'s values
    or, where ``dataset`` has the scan, a label count other than its point
    count.  Returns (files written, files whose count was checked)."""
    pred_root = Path(predictions)
    valid_raw = set(LEARNING_MAP_INV.values())
    n_files, n_checked = 0, 0
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        for seq_dir in sorted((pred_root / "sequences").glob("*")):
            seq = seq_dir.name
            for f in sorted((seq_dir / "predictions").glob("*.label")):
                labels = np.fromfile(f, dtype=np.uint32)
                bad = set(np.unique(labels).tolist()) - valid_raw
                if bad:
                    raise ValueError(f"{f}: non-submittable raw label ids {sorted(bad)}")
                if dataset:
                    scan = Path(dataset) / "sequences" / seq / "velodyne" / f"{f.stem}.bin"
                    if scan.exists():
                        n_pts = scan.stat().st_size // 16  # 4 floats a point
                        if len(labels) != n_pts:
                            raise ValueError(f"{f}: {len(labels)} labels but scan has {n_pts} points")
                        n_checked += 1
                zf.write(f, f"sequences/{seq}/predictions/{f.name}")
                n_files += 1
    missing = [s for s in TEST_SEQUENCES if not (pred_root / "sequences" / s / "predictions").exists()]
    if missing:
        print(f"WARNING: no predictions for test sequences {missing}")
    print(f"wrote {out}: {n_files} label files ({n_checked} point-count-validated)")
    return n_files, n_checked


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--predictions", required=True, help="dir holding sequences/<seq>/predictions/*.label")
    ap.add_argument("--dataset", default="", help="KITTI root (for point-count validation; optional)")
    ap.add_argument("--out", default="submission.zip")
    args = ap.parse_args()
    prepare_submission(args.predictions, args.dataset, args.out)


if __name__ == "__main__":
    main()
