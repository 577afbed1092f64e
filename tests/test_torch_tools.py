"""The port's ``misc/`` tools on the CPU: the ones with a JAX twin that
computes numbers against it, the profilers and probes as small runs.

* ``compute_class_frequency``: the frequencies equal JAX's on the toy
  config; ``lnn_check_lattice_size``: the printed sweep equals JAX's line
  for line.
* ``lnn_grad_check``: every op passes its f64 finite-difference check.
* ``profile_train`` (the ScanNet config at auto capacities too),
  ``profile_forward``, ``profile_build`` (``xyz+intensity``),
  ``batch_scaling_probe`` and ``lnn_make_teaser`` run at tiny sizes and
  give what they promise.
"""

from pathlib import Path

import numpy as np
import torch

from lattice_net_tpu.misc import compute_class_frequency as jccf
from lattice_net_tpu.misc import lnn_check_lattice_size as jcls
from lattice_net_tpu_torch.misc import (
    batch_scaling_probe,
    compute_class_frequency,
    lnn_check_lattice_size,
    lnn_grad_check,
    lnn_make_teaser,
    profile_build,
    profile_forward,
    profile_train,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOY = str(ROOT / "config" / "ln_train_toy.cfg")


def test_compute_class_frequency_matches_jax():
    np.testing.assert_array_equal(compute_class_frequency.run(TOY, max_clouds=3), jccf.run(TOY, max_clouds=3))


def test_lnn_check_lattice_size_matches_jax(capsys):
    jcls.run(TOY)
    want = capsys.readouterr().out
    rows = lnn_check_lattice_size.run(TOY, device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert len(rows) == len(lnn_check_lattice_size.FACTORS) and rows[0][1] > rows[-1][1] > 0


def test_lnn_grad_check_passes_in_f64():
    results = lnn_grad_check.run_all("cpu", verbose=False)
    assert len(results) == 6 and max(results.values()) < 1e-4


def test_profile_train_runs_on_the_cpu():
    out = profile_train.run(n_points=512, cap=4096, iters=2, device="cpu")
    setup, steps = out[0], out[1]
    assert setup["capacities"] == [4096, 2048, 1024] and sum(setup["overflow"]) == 0
    assert len(steps["step_ms"]) == 2 and np.isfinite(steps["loss"])
    assert [r.get("stages") for r in out[2:5]] == [0, 1, 2] and out[-1]["idle_share"] is None


def test_profile_train_scouts_the_scannet_config():
    # the ScanNet config at auto capacities (scouted on the room), narrowed
    cfg = str(ROOT / "config" / "lnn_train_scannet.cfg")
    narrow = ["model.nr_downsamples=1", "model.nr_blocks_down_stage=[1]", "model.nr_blocks_up_stage=[1]",
              "model.nr_blocks_bottleneck=1", "model.pointnet_start_nr_channels=8",
              "lattice_gpu.hash_table_capacity=65536", "lattice_gpu.capacity_mode=auto"]  # fmt: skip
    out = profile_train.run(cfg, n_points=1024, iters=1, overrides=narrow, device="cpu")
    setup = out[0]
    assert setup["dataset"] == "scannet" and setup["sigma"] == 0.08 and sum(setup["overflow"]) == 0
    assert setup["capacities"][0] < 65536 and np.isfinite(out[1]["loss"])


def test_profile_forward_runs_on_the_cpu():
    rows = profile_forward.run(n_points=512, cap=2048, iters=1, device="cpu")
    stages = [r["stage"] for r in rows[1:]]
    assert stages[0].startswith("build_structure L0") and stages[-1].startswith("END-TO-END") and len(stages) == 22
    assert all(r["ms"] > 0 for r in rows[1:])


def test_profile_build_times_the_switches_at_d4():
    rows = profile_build.run(n_points=512, cap=2048, iters=1, positions_mode="xyz+intensity", device="cpu")
    assert rows[0]["d"] == 4 and sum(rows[0]["occupancy"]) > 0
    stages = [r["stage"] for r in rows[1:]]
    assert len(stages) == 7 and stages[0] == "canonical_point_order" and "lookup" in stages[-1]
    assert all(r["ms"] > 0 for r in rows[1:])


def test_batch_scaling_probe_runs_on_the_cpu():
    out = batch_scaling_probe.run(batches=(1, 2), n_points=256, cap=1024, iters=1, device="cpu")
    assert set(out["results"]) == {1, 2} and all(r["clouds_per_s"] > 0 for r in out["results"].values())


def test_lnn_make_teaser_writes_its_files(tmp_path):
    done = lnn_make_teaser.run(TOY, clouds=(0,), out=str(tmp_path), device="cpu")
    (idx, d, acc), = done
    names = sorted(p.name for p in Path(d).iterdir())
    assert names == ["diff.ply", "gt.html", "gt.ply", "prediction.html", "prediction.ply"]
    assert 0.0 <= acc <= 1.0

