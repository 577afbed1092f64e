"""The general traffic generator: the clouds, batches, sizes and arrival
times of a run, drawn from ``--seed`` alone by the parameters of a traffic
file (``traffic/<mix>.json``) and the modes of a configuration file.

Every cloud is a scene of ``scenes.GENERATORS[scene]`` from a pool of
``pool_scenes`` drawn from the seed, cut to its size and turned about the
up axis (z) by an angle drawn from the seed (mirrored in x too where the
mix says ``mirror``).  Its positions and values are the columns that the
configuration's ``positions_mode`` and ``values_mode`` name, as the port's
``prepare_cloud`` maps every mode it has; the turn moves the positions'
xyz, and the values are read from the scene as generated.

Arrivals (an open loop): ``"arrivals": "periodic"`` (the default) at
``rate_hz`` with a phase and a jitter of ``jitter_ms`` drawn from the
seed; ``"poisson"`` in bursts of ``burst`` (default 1) clouds, the bursts'
gaps a fixed set of exponential quantiles of mean ``burst / rate_hz`` in an
order drawn from the seed, so that every seed offers the same load.
"""

from __future__ import annotations

import math

import numpy as np

from port_bench import scenes

# the scene's columns each mode reads (``height`` is the port's: V[:, 1:2])
POSITION_COLUMNS = {"xyz": ("V",), "xyz+intensity": ("V", "I"), "xyz+rgb": ("V", "C")}
VALUE_COLUMNS = {
    "none": (), "intensity": ("I",), "rgb": ("C",), "rgb+height": ("C", "height"), "rgb+xyz": ("C", "V"),
    "height": ("height",), "xyz": ("V",),
}  # fmt: skip
WIDTH = {"V": 3, "C": 3, "I": 1, "height": 1}


def dims(cfg: dict) -> tuple:
    """(position dimensions, value channels) of a configuration's modes;
    "none" values are one zero channel."""
    model = cfg["model"]
    pos = sum(WIDTH[c] for c in POSITION_COLUMNS[model["positions_mode"]])
    val = sum(WIDTH[c] for c in VALUE_COLUMNS[model["values_mode"]]) or 1
    return pos, val


def _column(scene, name, n, xyz=None):
    if name == "V":
        return scene["V"][:n] if xyz is None else xyz
    if name == "height":
        return scene["V"][:n, 1:2]
    return scene[name][:n]


def _cloud(scene, n, angle, mirror, model):
    """(positions, values, labels) of the scene's first ``n`` points, the
    positions' xyz turned by ``angle`` about z and mirrored in x if
    ``mirror``."""
    v = scene["V"][:n].astype(np.float64)
    c, s = math.cos(angle), math.sin(angle)
    x, y = c * v[:, 0] - s * v[:, 1], s * v[:, 0] + c * v[:, 1]
    xyz = np.stack([-x if mirror else x, y, v[:, 2]], axis=1)
    pos = np.concatenate([_column(scene, k, n, xyz) for k in POSITION_COLUMNS[model["positions_mode"]]], axis=1)
    vals = [_column(scene, k, n) for k in VALUE_COLUMNS[model["values_mode"]]]
    val = np.concatenate(vals, axis=1) if vals else np.zeros((n, 1))
    return pos.astype(np.float32), val.astype(np.float32), scene["L"][:n].astype(np.int32)


def clouds(cfg, traffic, rng, sizes) -> list:
    """``len(sizes)`` clouds of those sizes (points each)."""
    gen = scenes.GENERATORS[traffic["scene"]]
    pool = [gen(traffic["scene_points"], int(s)) for s in rng.integers(0, 1 << 31, traffic["pool_scenes"])]
    count = len(sizes)
    angles = rng.uniform(0.0, 2 * math.pi, count)
    mirrors = rng.random(count) < (0.5 if traffic.get("mirror") else 0.0)
    return [_cloud(pool[i % len(pool)], int(sizes[i]), angles[i], mirrors[i], cfg["model"]) for i in range(count)]


def spread_sizes(traffic, rng, count) -> np.ndarray:
    """``count`` sizes spread evenly over ``points_min``..``points_max``, in
    an order drawn from the seed; the first ``warmup`` alternate between the
    largest and the smallest, so that the warm-up meets both ends."""
    sizes = np.rint(np.linspace(traffic["points_min"], traffic["points_max"], count)).astype(int)
    sizes = sizes[rng.permutation(count)]
    ends = [traffic["points_max"], traffic["points_min"]]
    sizes[: traffic["warmup"]] = [ends[i % 2] for i in range(traffic["warmup"])]
    return sizes


def offered(traffic, seconds) -> int:
    """Clouds to make for a window of ``seconds``: those due in it, with
    room for a Poisson mix's slower draws."""
    if traffic.get("arrivals", "periodic") == "poisson":
        return int(math.ceil(seconds * traffic["rate_hz"] * 1.25)) + traffic.get("burst", 1)
    return int(math.ceil(seconds * traffic["rate_hz"])) + 1


def arrival_times(traffic, rng, count) -> np.ndarray:
    """Seconds from the window's start at which each of ``count`` clouds is
    due, non-decreasing from 0."""
    rate = traffic["rate_hz"]
    kind = traffic.get("arrivals", "periodic")
    if kind == "periodic":
        phase = rng.uniform(0.0, 1.0 / rate)
        jitter = rng.uniform(-traffic["jitter_ms"], traffic["jitter_ms"], count) / 1e3
        return np.maximum.accumulate(np.maximum(phase + np.arange(count) / rate + jitter, 0.0))
    if kind == "poisson":
        burst = traffic.get("burst", 1)
        groups = -(-count // burst)
        gaps = -np.log1p(-(np.arange(groups) + 0.5) / groups) * burst / rate
        starts = np.concatenate([[0.0], np.cumsum(gaps[rng.permutation(groups)])[:-1]])
        return np.repeat(starts, burst)[:count]
    raise ValueError(f"arrivals {kind!r}: periodic or poisson")
