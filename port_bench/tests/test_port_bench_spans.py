"""``metrics/_spans.py`` on a hand-made Chrome trace: two items, nested
``lnt.*`` spans, launches joined to their device operations by
``correlation``, a launch on a second thread, and two streams that
overlap."""

import copy

from port_bench import trace
from port_bench.metrics import _spans

MAIN, AUTOGRAD = 11, 12


def _ev(cat, name, ts, dur, tid=MAIN, corr=None):
    ev = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _span(name, ts, dur, tid=MAIN):
    return _ev("user_annotation", name, ts, dur, tid)


def _launch(corr, ts, tid=MAIN):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _device(corr, ts, dur, stream=7, cat="kernel", name="k"):
    return dict(_ev(cat, name, ts, dur, stream, corr), pid=0)


ITEMS = [_span(trace.ITEM, 0, 100), _span(trace.ITEM, 200, 100)]
# item 1: a served cloud; item 2: a step's backward, with autograd's thread
SPANS = [
    _span("lnt.build", 5, 40), _span("lnt.build.level0", 5, 20), _span("lnt.host_read", 20, 5),
    _span("lnt.build.tables", 30, 15), _span("lnt.model", 50, 45), _span("lnt.norm", 60, 10),
    _span("lnt.norm", 80, 10),
    _span("lnt.step.backward", 210, 80), _span("lnt.norm", 230, 10, tid=AUTOGRAD),
]  # fmt: skip
OPS = [
    _launch(1, 6), _device(1, 8, 10),  # level 0
    _launch(2, 21), _device(2, 21, 3, cat="gpu_memcpy", name="Memcpy DtoH"),  # the host read's copy
    _launch(3, 31), _device(3, 33, 7),  # tables
    _launch(4, 52), _device(4, 52, 23),  # the model, outside the norms
    _launch(5, 61), _device(5, 62, 6, stream=8),  # the first norm, on a stream beside the model's kernel
    _launch(6, 81), _device(6, 85, 3),  # the second norm
    _launch(7, 92, tid=AUTOGRAD), _device(7, 93, 4),  # no span open on its thread: the main thread's
    _launch(8, 150), _device(8, 150, 10),  # between the items: nobody's
    _launch(10, 215), _device(10, 216, 4),  # the backward
    _launch(11, 232, tid=AUTOGRAD), _device(11, 233, 5),  # the autograd thread's own norm
    _launch(12, 250, tid=AUTOGRAD), _device(12, 251, 9),  # the autograd thread outside its span
    _device(None, 97, 1, name="uncorrelated"),
    _ev("cpu_op", "aten::sort", 35, 30),
]  # fmt: skip
DATA = {"traceEvents": ITEMS + SPANS + OPS}


def _want(n, us, idle_us, device_us):
    return dict(n=n, us=us, idle_us=idle_us, device_us=device_us)


def test_span_items_of_the_hand_made_trace():
    first, second = _spans.span_items(DATA)
    # busy in item 1: [8, 18] [21, 24] [33, 40] [52, 75] (the norm's [62, 68] inside it) [85, 88] [93, 98]
    assert first == {
        "lnt.build": _want(1, 40, 40 - (10 + 3 + 7), 0),
        "lnt.build.level0": _want(1, 20, 20 - (10 + 3), 10),
        "lnt.host_read": _want(1, 5, 5 - 3, 3),
        "lnt.build.tables": _want(1, 15, 15 - 7, 7),
        "lnt.model": _want(1, 45, 45 - (23 + 3 + 2), 23 + 4),
        "lnt.norm": _want(2, 20, 20 - (10 + 3), 6 + 3),
    }
    # busy in item 2: [216, 220] [233, 238] [251, 260]
    assert second == {
        "lnt.step.backward": _want(1, 80, 80 - (4 + 5 + 9), 4 + 9),
        "lnt.norm": _want(1, 10, 10 - 5, 5),
    }


def test_spans_fit_their_items():
    for (a, b), item in zip([(0, 100), (200, 300)], _spans.span_items(DATA)):
        for s in item.values():
            assert 0 <= s["idle_us"] <= s["us"] and s["device_us"] >= 0
        top = sum(item.get(name, {}).get("us", 0) for name in ("lnt.build", "lnt.model"))
        assert top <= b - a


def test_read_is_the_same_with_and_without_the_spans():
    plain = {"traceEvents": ITEMS + OPS}
    assert trace.read(copy.deepcopy(DATA)) == trace.read(plain)
    assert trace.breakdown(trace.read(DATA)) == trace.breakdown(trace.read(plain))


def test_a_program_without_spans_reads_nothing():
    plain = {"traceEvents": ITEMS + OPS}
    items = _spans.span_items(plain)
    assert items == [{}, {}]
    assert _spans.median(items, "lnt.build", "us") is None
    assert _spans.median([], "lnt.build", "us") is None
    assert _spans.span_items({"traceEvents": SPANS + OPS}) == []


def test_median_over_the_items():
    items = _spans.span_items(DATA)
    assert _spans.median(items, "lnt.norm", "n") == 1.5
    assert _spans.median(items, "lnt.host_read", "n") == 0.5
    assert _spans.median(items, "lnt.build", "us") == 20.0
