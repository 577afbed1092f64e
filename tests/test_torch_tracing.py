"""The port's spans (``lattice_net_tpu_torch/tracing.py``) on the CPU.

* Without a profiler a span dispatches nothing: a ``TorchDispatchMode``
  over a served cloud and a train step sees no ``profiler.*`` op.
* Under ``torch.profiler`` the exported trace holds every span of
  ``tracing.SPANS``, nested as the table says, and ``lnt.norm`` counts the
  ``masked_group_norm`` calls; ``lnt.norm.fused`` counts as many in an
  inference forward and none in a train step.
* ``lnt.build.sort2`` and ``lnt.build.lookup2`` are entered only by
  two-column keys (d > 3): as many times as a d = 6 build sorts and looks
  up, and never by a d = 3 cloud or step; ``lookup2.launches`` (counted
  here by the plain version, which the CPU runs) likewise.
* Every span name in the package's source is in ``tracing.SPANS``.
* ``misc/profiling``: the union of overlapping device intervals, and the
  spans of a capture.
"""

import ast
import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lattice_net_tpu_torch import tracing
from lattice_net_tpu_torch.data.synth_kitti import make_scene
from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.misc import profiling
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.nn import modules as lnm
from lattice_net_tpu_torch.ops_cuda import lookup as k_lookup
from lattice_net_tpu_torch.ops_cuda import norm as k_norm
from lattice_net_tpu_torch.parallel import data_parallel as tdp
from lattice_net_tpu_torch.serve import Predictor
from lattice_net_tpu_torch.train import optim as to

torch.set_num_threads(2)

PACKAGE = Path(tracing.__file__).resolve().parent
N_POINTS, N_REAL, CAPS, SIGMA = 1024, 900, (4096, 2048, 1024), 0.6
MODEL = dict(
    nr_classes=5,
    values_mode="intensity",
    pointnet_channels_per_layer=(8, 16),
    pointnet_start_nr_channels=16,
    nr_downsamples=2,
    nr_blocks_down_stage=(1, 1),
    nr_blocks_bottleneck=1,
    nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3,
    nr_levels_up_with_normal_resnet=3,
)
NAMES = [name for name, _ in tracing.SPANS]
# each span's enclosing lnt.* span (None: none), as the table of
# tracing.SPANS lays them out; lnt.norm and lnt.host_read may sit deeper
PARENTS = {
    tracing.SERVE_BATCH: {None},
    tracing.BUILD: {None, tracing.STEP_FORWARD_LOSS},
    tracing.BUILD_LEVEL0: {tracing.BUILD},
    tracing.BUILD_COARSE: {tracing.BUILD},
    tracing.BUILD_TABLES: {tracing.BUILD},
    tracing.BUILD_FALLBACK: {tracing.BUILD_LEVEL0, tracing.BUILD_COARSE},
    tracing.BUILD_SORT2: {tracing.BUILD_LEVEL0, tracing.BUILD_COARSE, tracing.BUILD_FALLBACK},
    tracing.BUILD_LOOKUP2: {tracing.BUILD_TABLES},
    tracing.HOST_READ: {tracing.BUILD_LEVEL0, tracing.STEP_FORWARD_LOSS},
    tracing.MODEL: {None, tracing.STEP_FORWARD_LOSS},
    tracing.MODEL_DISTRIBUTE: {tracing.MODEL},
    tracing.MODEL_DOWN: {tracing.MODEL},
    tracing.MODEL_UP: {tracing.MODEL},
    tracing.MODEL_SLICE: {tracing.MODEL},
    tracing.NORM: {tracing.MODEL_DISTRIBUTE, tracing.MODEL_DOWN, tracing.MODEL_UP, tracing.MODEL_SLICE},
    tracing.NORM_FUSED: {tracing.NORM},
    tracing.STEP_FORWARD_LOSS: {None},
    tracing.STEP_BACKWARD: {None},
    tracing.STEP_UPDATE: {None},
}


def _cloud(seed=1):
    c = make_scene(N_REAL, seed=seed)
    pos, vals, target = tlnn.prepare_cloud(c, tlnn.ModelParams(**MODEL))
    return pos, vals, target % MODEL["nr_classes"]


def _model():
    mp = tlnn.ModelParams(**MODEL)
    return tlnn.LNN(mp, torch.Generator().manual_seed(0), device="cpu", conv_dtype=torch.float32)


@pytest.fixture(scope="module")
def predictor():
    return Predictor(_model().eval(), SIGMA, CAPS, N_POINTS, torch.device("cpu"))


@pytest.fixture(scope="module")
def trainer():
    model = _model()
    tx = to.make_optimizer(lr=1e-3, weight_decay=1e-3)
    step = tdp.make_train_step(model, tx, SIGMA, MODEL["nr_downsamples"], CAPS)
    pos, vals, target = _cloud()
    batch = tdp.make_batch([(pos, vals, target)], N_POINTS, device="cpu")
    return step, tdp.TrainState.create(model.state_dict(), tx), batch


def _serve(predictor):
    pos, vals, _ = _cloud()
    return lambda: predictor.forward(pos, vals)


def _step(trainer):
    step, state, batch = trainer
    return lambda: step(state, batch)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _spans(fn, tmp_path):
    """The lnt.* ``user_annotation`` events of a CPU profile of ``fn()``:
    ``[(name, start, end, parent name or None)]`` in start order."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(
        (float(e["ts"]), -float(e["dur"]), e["name"], e["tid"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("lnt.")
    )  # fmt: skip
    out, open_ = [], collections.defaultdict(list)
    for ts, neg_dur, name, tid in spans:
        end = ts - neg_dur
        stack = open_[tid]
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append((name, ts, end, stack[-1][0] if stack else None))
        stack.append((name, end))
    return out


def _check_nesting(spans):
    for name, _, _, parent in spans:
        assert parent in PARENTS[name], (name, parent)


@pytest.mark.parametrize("entry", ["serve", "step"])
def test_no_profiler_dispatches_no_span_op(entry, predictor, trainer):
    fn = _serve(predictor) if entry == "serve" else _step(trainer)
    assert not torch.autograd._profiler_enabled()
    with _Ops() as ops:
        fn()
    assert sum(ops.names.values()) > 100
    assert not [name for name in ops.names if name.startswith("profiler.")]


def test_span_is_the_shared_no_op_without_a_profiler():
    assert tracing.span(tracing.BUILD) is tracing.span(tracing.NORM)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.span(tracing.BUILD) is not tracing.span(tracing.BUILD)


def test_served_cloud_spans_nest(predictor, tmp_path):
    spans = _spans(_serve(predictor), tmp_path)
    _check_nesting(spans)
    names = collections.Counter(s[0] for s in spans)
    want = {tracing.SERVE_BATCH, tracing.BUILD, tracing.BUILD_LEVEL0, tracing.BUILD_COARSE, tracing.BUILD_TABLES,
            tracing.HOST_READ, tracing.MODEL, tracing.MODEL_DISTRIBUTE, tracing.MODEL_DOWN, tracing.MODEL_UP,
            tracing.MODEL_SLICE, tracing.NORM, tracing.NORM_FUSED}  # fmt: skip
    assert set(names) == want
    for name in want - {tracing.NORM, tracing.NORM_FUSED}:
        assert names[name] == 1, name
    # one host read, the simplex reps' overflow, inside the build
    (read,) = [s for s in spans if s[0] == tracing.HOST_READ]
    (build,) = [s for s in spans if s[0] == tracing.BUILD]
    assert build[1] <= read[1] and read[2] <= build[2]
    order = [s[0] for s in spans if s[3] is None]
    assert order == [tracing.SERVE_BATCH, tracing.BUILD, tracing.MODEL]


def test_train_step_spans_nest_in_order(trainer, tmp_path):
    spans = _spans(_step(trainer), tmp_path)
    _check_nesting(spans)
    top = [s[0] for s in spans if s[3] is None]
    assert top == [tracing.STEP_FORWARD_LOSS, tracing.STEP_BACKWARD, tracing.STEP_UPDATE]
    names = collections.Counter(s[0] for s in spans)
    assert names[tracing.BUILD] == names[tracing.MODEL] == 1 and names[tracing.NORM] > 0
    assert names[tracing.NORM_FUSED] == 0  # training keeps the composition
    reads = [s[3] for s in spans if s[0] == tracing.HOST_READ]
    assert reads == [tracing.BUILD_LEVEL0]  # the build's one read


@pytest.mark.parametrize("canonical", [False, True])
def test_fallback_spans_count_the_fast_paths_misses(canonical, tmp_path):
    # a level-0 table too small for the cloud: the simplex reps (or the
    # canonical build's runs) overflow, and the general branch runs
    pos, _, _ = _cloud()
    positions = torch.from_numpy(pos)
    if canonical:
        positions = positions[st.canonical_point_order(positions, SIGMA)]
    caps = (64, 2048, 1024)
    build = lambda: st.build_hierarchy(positions, SIGMA, 2, caps, canonical_points=canonical)  # noqa: E731
    spans = _spans(build, tmp_path)
    _check_nesting(spans)
    (fallback,) = [s for s in spans if s[0] == tracing.BUILD_FALLBACK]
    assert fallback[3] == (tracing.BUILD_LEVEL0 if canonical else tracing.BUILD_COARSE)
    (read,) = [s for s in spans if s[0] == tracing.HOST_READ]
    assert read[3] == tracing.BUILD_LEVEL0 and read[2] <= fallback[1]
    # a table that holds the cloud: no miss, no fallback span
    roomy = lambda: st.build_hierarchy(positions, SIGMA, 2, CAPS, canonical_points=canonical)  # noqa: E731
    assert tracing.BUILD_FALLBACK not in {s[0] for s in _spans(roomy, tmp_path)}


def test_norm_span_counts_every_group_norm_call(predictor, tmp_path, monkeypatch):
    calls = []
    norm = lnm.masked_group_norm

    def counted(*args, **kwargs):
        calls.append(1)
        return norm(*args, **kwargs)

    # nn.modules' composition and the fused norm's plain version, which the CPU runs
    monkeypatch.setattr(lnm, "masked_group_norm", counted)
    monkeypatch.setattr(k_norm, "masked_group_norm", counted)
    spans = _spans(_serve(predictor), tmp_path)
    assert len(calls) > 5
    assert sum(s[0] == tracing.NORM for s in spans) == len(calls)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_fused_norm_span_counts_every_inference_norm(mode, predictor, tmp_path):
    pos, vals, _ = _cloud()
    model = predictor.model
    h = st.build_hierarchy(torch.from_numpy(pos), SIGMA, MODEL["nr_downsamples"], CAPS)
    values = torch.from_numpy(vals)
    with getattr(torch, mode)():
        spans = _spans(lambda: model(h, torch.from_numpy(pos), values), tmp_path)
    _check_nesting(spans)
    names = collections.Counter(s[0] for s in spans)
    assert names[tracing.NORM] == names[tracing.NORM_FUSED] == 16


def _count_lookup2_launches(monkeypatch):
    """The plain version, which the CPU runs, counts a launch as the kernel does."""
    plain = k_lookup.lookup2_plain

    def counted(*args):
        k_lookup.lookup2.launches += 1
        return plain(*args)

    monkeypatch.setattr(k_lookup, "lookup2_plain", counted)


@pytest.mark.parametrize("levels", [1, 2])
def test_two_column_spans_count_the_d6_builds_sorts_and_lookups(levels, tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    positions = torch.from_numpy(rng.uniform(0.0, 1.0, (300, 6)).astype(np.float32))
    caps = (4096,) * (levels + 1)
    _count_lookup2_launches(monkeypatch)
    before = k_lookup.lookup2.launches
    spans = _spans(lambda: st.build_hierarchy(positions, 0.1, levels, caps), tmp_path)
    _check_nesting(spans)
    names = collections.Counter(s[0] for s in spans)
    # a lookup a same-level table (levels + 1) and a coarsen table (levels),
    # each one search; a key sort a level's build, none inside a lookup
    assert names[tracing.BUILD_LOOKUP2] == 2 * levels + 1
    assert k_lookup.lookup2.launches - before == 2 * levels + 1
    assert names[tracing.BUILD_SORT2] == levels + 1
    assert not any(s[3] == tracing.BUILD_LOOKUP2 for s in spans if s[0] == tracing.BUILD_SORT2)
    assert sum(s[3] == tracing.BUILD_LEVEL0 for s in spans if s[0] == tracing.BUILD_SORT2) == 1


@pytest.mark.parametrize("entry", ["serve", "step"])
def test_one_column_keys_enter_no_two_column_span(entry, predictor, trainer, monkeypatch):
    fn = _serve(predictor) if entry == "serve" else _step(trainer)
    with _Ops() as ops:
        fn()
    span = tracing.span

    def refusing(name):
        assert name not in (tracing.BUILD_SORT2, tracing.BUILD_LOOKUP2), name
        return span(name)

    monkeypatch.setattr(tracing, "span", refusing)
    _count_lookup2_launches(monkeypatch)
    before = k_lookup.lookup2.launches
    with _Ops() as again:
        fn()
    assert again.names == ops.names
    assert k_lookup.lookup2.launches == before


def _span_names_in_source():
    """(file, name) of every ``span(...)`` call's argument in the package."""
    found = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not ((isinstance(f, ast.Attribute) and f.attr == "span") or (isinstance(f, ast.Name) and f.id == "span")):
                continue
            (arg,) = node.args
            if isinstance(arg, ast.Attribute):
                name = getattr(tracing, arg.attr)
            elif isinstance(arg, ast.Name):
                name = getattr(tracing, arg.id, arg.id)
            else:
                name = arg.value
            found.append((path.relative_to(PACKAGE).as_posix(), name))
    return found


def test_every_span_in_the_source_is_in_SPANS():
    found = _span_names_in_source()
    used = {name for _, name in found if name != "name"}
    assert used == set(NAMES), used ^ set(NAMES)
    assert len(NAMES) == len(set(NAMES)) and all(n.startswith("lnt.") and meaning for n, meaning in tracing.SPANS)
    # no span name written out anywhere but tracing.py
    for path in PACKAGE.rglob("*.py"):
        if path.name != "tracing.py":
            assert '"lnt.' not in path.read_text(), path


def test_busy_us_counts_overlapping_intervals_once():
    assert profiling.busy_us([]) == 0.0
    # two streams: [0, 10) and [5, 12) overlap; [20, 25) alone; [21, 22) inside it
    assert profiling.busy_us([(20.0, 25.0), (0.0, 10.0), (21.0, 22.0), (5.0, 12.0)]) == 17.0
    assert profiling.busy_us(iter([(0.0, 1.0), (1.0, 2.0)])) == 2.0


def test_profile_reports_the_spans_on_the_cpu(predictor):
    out = profiling.profile(_serve(predictor), "cpu", reps=2)
    assert out["idle_share"] is None and out["device_ms"] is None
    spans = out["spans"]
    assert spans[tracing.BUILD]["calls"] == spans[tracing.MODEL]["calls"] == 2
    assert spans[tracing.NORM]["calls"] > 2 * 5
    assert 0 < spans[tracing.BUILD_LEVEL0]["wall_ms"] <= spans[tracing.BUILD]["wall_ms"] <= out["wall_ms"]
    assert np.isfinite(sum(s["wall_ms"] for s in spans.values()))
