"""A closed loop of labelled clouds, one after another, each of
``points`` points.  Reports the clouds labelled in the window over the
time to the last one labelled in it, under the mix's ``rate_metric``.

``correct``: a sample drawn from the seed of the first ``check_from``
clouds (``check_sample``; one the window did not reach is labelled after
it, as it would be next), and in a traced run the traced segment's clouds
too, which go through the untimed entry."""

from __future__ import annotations

import time

import numpy as np

from port_bench import check, inputs, timing


def run(env):
    cfg, tr, rng, program, dev = env.cfg, env.traffic, env.rng, env.program, env.device
    count = tr["variants"]
    clouds = inputs.clouds(cfg, tr, rng, np.full(count, tr["points"]))
    env.stage("inputs")
    caps = program.capacities(cfg, "serve")
    served = program.Served(cfg, env.weights, caps, tr["budget"], dev)
    env.stage("program")
    for pos, val, _ in clouds[: tr["warmup"]]:
        served.label(pos, val)
    timing.sync(dev)
    sample = set(int(i) for i in rng.permutation(tr["check_from"])[: tr["check_sample"]])
    kept, done, failed, last = {}, 0, 0, 0.0
    clock = timing.Clock(dev, host_stages=("batch",)) if env.trace else None
    env.start_window()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < env.seconds:
        pos, val, _ = clouds[(tr["warmup"] + i) % count]
        try:
            labels, logp, _ = served.label_staged(pos, val, clock) if clock else served.label(pos, val)
        except Exception as e:
            failed += 1
            env.note(f"cloud {i} failed: {e!r}")
            labels = None
        t = time.perf_counter() - t0
        if labels is not None and t <= env.seconds:
            done, last = done + 1, t
        if labels is not None and i in sample:
            kept[i] = (labels, logp)
        i += 1
    while any(j >= i for j in sample):
        pos, val, _ = clouds[(tr["warmup"] + i) % count]
        labels, logp, _ = served.label(pos, val)
        if i in sample:
            kept[i] = (labels, logp)
        i += 1
    out = dict(attempted=i, failed=failed, e2e={tr["rate_metric"]: done / last if last > 0 else 0.0})
    items = [(clouds[(tr["warmup"] + j) % count], *kept[j]) for j in sorted(kept)]
    layer = {}
    n_trace = tr["trace_items"] if env.trace else 0
    if env.trace:
        layer["stages"] = {f"eval.{k}": v for k, v in clock.ms().items()}
        seg = [clouds[(tr["warmup"] + i + j) % count] for j in range(n_trace)]
        traced = []

        def run_items(mark):
            traced.clear()
            for cloud in seg:
                with mark():
                    labels, logp, h = served.label(*cloud[:2])
                traced.append((cloud, labels, logp, h))

        def flops():
            return sum(timing.forward_flops(cfg, program.occupancy(h), len(c[0])) for c, _, _, h in traced)

        layer.update(timing.traced_segment(run_items, dev, program, flops, lambda: served.label(*seg[0][:2])))
        items += [(c, labels, logp) for c, labels, logp, _ in traced]
        del traced
    env.read_memory()
    del served
    timing.free(dev)
    out["layer"] = layer
    out["check"] = check.labels(env, caps, "serve", items, tr["check_sample"] + n_trace)
    return out
