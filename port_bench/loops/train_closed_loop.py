"""A closed loop of train steps (``make_train_step``'s step), one batch of
``batch`` (default 1) labelled clouds of ``points`` points a step, copied
to the card each step; each step ends in a synchronise.  Reports the steps'
clouds completed in the window over the time to the last step completed in
it, under the mix's ``rate_metric``.

``correct``: three watched runs of ``check_steps`` steps each
(``check.Steps``), held against the reference from the same start: the
first steps, which set-up takes through the window's own call from the
benchmark's weights; steps that the window took, from step
``rng.integers(window_check_within)`` of the window on (those past the
window's end are taken after it through the same call); and in a traced
run the traced segment's first steps, which go through the untimed entry.
The last two start from the program's own state (prefix ``win_``)."""

from __future__ import annotations

import time

import numpy as np

from port_bench import check, inputs, timing


def run(env):
    cfg, tr, rng, program, dev = env.cfg, env.traffic, env.rng, env.program, env.device
    count, b = tr["variants"], tr.get("batch", 1)
    clouds = inputs.clouds(cfg, tr, rng, np.full(count * b, tr["points"]))
    batches = [program.make_host_batch(clouds[i * b : (i + 1) * b], tr["budget"]) for i in range(count)]
    env.stage("inputs")
    caps = program.capacities(cfg, "train", [c[0] for c in clouds[: tr["scout_clouds"]]], dev)
    env.stage("capacities")
    run = program.Trained(cfg, env.weights, caps, dev)
    env.stage("program")
    n_check = tr["check_steps"]
    first = check.Steps(0, n_check)
    start = max(n_check + tr["warmup_extra"], count)  # every batch once: no size is new in the window
    for k in range(start):
        _step(run, first, k, batches[k % count], run.train)
    timing.sync(dev)
    first = first.program_side()
    window = check.Steps(int(rng.integers(tr["window_check_within"])), n_check)
    done, failed, last, i = 0, 0, 0.0, 0
    clock = timing.Clock(dev) if env.trace else None
    step = (lambda hb: run.train_staged(hb, clock)) if clock else run.train
    env.start_window()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < env.seconds:
        try:
            _step(run, window, i, batches[(start + i) % count], step)
            timing.sync(dev)
        except Exception as e:
            failed += 1
            env.note(f"step {i} failed: {e!r}")
            i += 1
            continue
        t = time.perf_counter() - t0
        if t <= env.seconds:
            done, last = done + b, t
        i += 1
    while not window.done:  # the watched steps past the window's end, through the same call
        _step(run, window, i, batches[(start + i) % count], step)
        i += 1
    out = dict(attempted=i * b, failed=failed * b, e2e={tr["rate_metric"]: done / last if last > 0 else 0.0})
    sides = [("", first), ("win_", window.program_side())]
    layer = {}
    if env.trace:
        layer["stages"] = {f"train.{k}": v for k, v in clock.ms().items()}
        seg = [batches[(start + i + j) % count] for j in range(tr["trace_items"])]
        traced = check.Steps(0, n_check)

        def run_items(mark):
            for j, hb in enumerate(seg):
                with mark():
                    _step(run, traced, j, hb, run.train)
                    timing.sync(dev)

        def flops():
            return sum(3 * timing.forward_flops(cfg, program.occupancy(h), int(h_n))
                       for hb in seg for h, h_n in zip(run.hierarchies(hb), hb["point_mask"].sum(1)))  # fmt: skip

        layer.update(timing.traced_segment(run_items, dev, program, flops, lambda: run.train(seg[0])))
        sides.append(("win_", traced.program_side()))
    env.read_memory()
    del run, window
    timing.free(dev)
    out["layer"] = layer
    out["check"] = check.train(env, caps, sides, n_check * len(sides))
    return out


def _step(run, watch, i, host_batch, step):
    watch.before(i, run.state)
    metrics = step(host_batch)
    watch.after(i, run.state, metrics, host_batch)
