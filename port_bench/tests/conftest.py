"""The benchmark's own tests (``python -m pytest port_bench/tests``, from
the repository's root); ``card`` marks the ones that need an NVIDIA card,
which skip without one."""

import pytest
import torch

# cells cut to a size the CPU runs in seconds: the same loops, loaders,
# checks and readers, on a few thousand points and small tables
TINY = {
    "kitti_serve_10hz": dict(
        config={"lattice_serve": {"hash_table_capacity": 8192}},
        traffic={"scene_points": 4096, "points_min": 3000, "points_max": 4096, "budget": 4096,
                 "check_sample": 2, "trace_items": 2},
    ),
    "kitti_train": dict(
        config={"lattice_train": {"hash_table_capacity": 8192}},
        traffic={"scene_points": 4096, "points": 4096, "budget": 4096, "variants": 6, "trace_items": 3,
                 "window_check_within": 2},
    ),
    "scannet_train": dict(
        config={"lattice_train": {"hash_table_capacity": 16384}},
        traffic={"scene_points": 4096, "points": 4096, "budget": 4096, "variants": 6, "trace_items": 3,
                 "window_check_within": 2},
    ),
    "scannet_eval_5m": dict(
        config={"lattice_serve": {"hash_table_capacity": 16384}},
        traffic={"scene_points": 4096, "points": 4096, "budget": 4096, "variants": 6, "check_from": 2,
                 "trace_items": 2},
    ),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"


def tiny(cell, f32=False):
    """The CPU overrides of ``cell``; ``f32`` runs the port's convs in f32,
    where the plain reference agrees with it to the last bit."""
    o = TINY[cell]
    if not f32:
        return o
    return {"config": dict(o["config"], conv_dtype="float32"), "traffic": o["traffic"]}
