"""An open loop of served clouds: each is labelled on arrival, or as soon
as the card is free, and timed from when it was due (``inputs.
arrival_times``); sizes spread over ``points_min``..``points_max``
(``inputs.spread_sizes``).  Reports ``serve_p50_ms`` and ``serve_p95_ms``
over every cloud due in the window.

``correct``: a sample drawn from the seed of the clouds the window served
(``check_sample``, the largest among them), and in a traced run the
traced segment's clouds too, which go through the untimed entry."""

from __future__ import annotations

import time

import numpy as np

from port_bench import check, inputs, timing, yardstick


def run(env):
    cfg, tr, rng, program, dev = env.cfg, env.traffic, env.rng, env.program, env.device
    n_trace = tr["trace_items"] if env.trace else 0
    count = tr["warmup"] + inputs.offered(tr, env.seconds) + n_trace + 1
    sizes = inputs.spread_sizes(tr, rng, count)
    clouds = inputs.clouds(cfg, tr, rng, sizes)
    env.stage("inputs")
    due_all = inputs.arrival_times(tr, rng, count)
    caps = program.capacities(cfg, "serve")
    served = program.Served(cfg, env.weights, caps, tr["budget"], dev)
    env.stage("program")
    for pos, val, _ in clouds[: tr["warmup"]]:
        served.label(pos, val)
    timing.sync(dev)
    work = clouds[tr["warmup"] :]
    due = due_all[: len(work)]
    in_window = int(np.sum(due < env.seconds))
    longest = int(np.argmax([len(c[0]) for c in work[:in_window]]))
    others = [i for i in rng.permutation(in_window) if i != longest][: tr["check_sample"] - 1]
    sample = sorted([longest] + others)
    kept, lat, failed = {}, [], 0
    clock = timing.Clock(dev, host_stages=("batch",)) if env.trace else None
    env.start_window()
    t0 = time.perf_counter()
    for i in range(in_window):
        timing.wait_until(t0 + due[i])
        pos, val, _ = work[i]
        try:
            labels, logp, _ = served.label_staged(pos, val, clock) if clock else served.label(pos, val)
        except Exception as e:  # a failed request counts, and the run goes on
            failed += 1
            env.note(f"scan {i} failed: {e!r}")
            continue
        lat.append((time.perf_counter() - (t0 + due[i])) * 1e3)
        if i in sample:
            kept[i] = (labels, logp)
    out = dict(attempted=in_window, failed=failed, e2e=dict(serve_p50_ms=yardstick.median(lat),
               serve_p95_ms=yardstick.percentile(lat, 95)))  # fmt: skip
    items = [(work[i], *kept[i]) for i in sample if i in kept]
    layer = {}
    if env.trace:
        layer["stages"] = {f"serve.{k}": v for k, v in clock.ms().items()}
        seg = work[in_window : in_window + n_trace]
        seg_due = due_all[: len(seg)] - due_all[0]
        done = []

        def run_items(mark):
            done.clear()
            s0 = time.perf_counter()
            for j, cloud in enumerate(seg):
                timing.wait_until(s0 + seg_due[j])
                with mark():
                    labels, logp, h = served.label(*cloud[:2])
                done.append((cloud, labels, logp, h))

        def flops():
            return sum(timing.forward_flops(cfg, program.occupancy(h), len(c[0])) for c, _, _, h in done)

        layer.update(timing.traced_segment(run_items, dev, program, flops, lambda: served.label(*seg[0][:2])))
        items += [(c, labels, logp) for c, labels, logp, _ in done]
        del done
    env.read_memory()
    del served
    timing.free(dev)
    out["layer"] = layer
    out["check"] = check.labels(env, caps, "serve", items, tr["check_sample"] + n_trace)
    return out

