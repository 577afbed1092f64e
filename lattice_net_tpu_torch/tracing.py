"""Named spans of the port's layers, on ``torch.profiler``'s clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records: the span is then a ``user_annotation`` event of the exported
Chrome trace, on the same clock as the device's kernels, copies and fills,
and ``key_averages()`` counts its calls.  Otherwise it is one shared no-op
context, which dispatches nothing: a ``TorchDispatchMode`` counts the same
ops with the spans as without them.  A recording profiler is the only
switch.

The names are the constants below; ``SPANS`` gives each its meaning.  A
span's count is the number of times it was entered.
"""

from __future__ import annotations

import contextlib

import torch

SERVE_BATCH = "lnt.serve.batch"
BUILD = "lnt.build"
BUILD_LEVEL0 = "lnt.build.level0"
BUILD_COARSE = "lnt.build.coarse"
BUILD_TABLES = "lnt.build.tables"
BUILD_FALLBACK = "lnt.build.fallback"
BUILD_SORT2 = "lnt.build.sort2"
BUILD_LOOKUP2 = "lnt.build.lookup2"
HOST_READ = "lnt.host_read"
MODEL = "lnt.model"
MODEL_DISTRIBUTE = "lnt.model.distribute"
MODEL_DOWN = "lnt.model.down"
MODEL_UP = "lnt.model.up"
MODEL_SLICE = "lnt.model.slice"
NORM = "lnt.norm"
NORM_FUSED = "lnt.norm.fused"
STEP_FORWARD_LOSS = "lnt.step.forward_loss"
STEP_BACKWARD = "lnt.step.backward"
STEP_UPDATE = "lnt.step.update"

SPANS = (
    (SERVE_BATCH, "Predictor._batch: the cloud's checks, its padding and its copy to the device"),
    (BUILD, "build_hierarchy, whole"),
    (BUILD_LEVEL0, "level 0: build_structure or the canonical fast build, and the simplex reps"),
    (BUILD_COARSE, "the coarse levels, one build_structure each"),
    (BUILD_TABLES, "the same-level, coarsen and finefy neighbour tables"),
    (BUILD_FALLBACK, "a general branch taken after a nonzero overflow read: one a fast path's miss"),
    (BUILD_SORT2, "_sort_packed's stable sorts of two-column keys (d > 3), one entry a sort"),
    (BUILD_LOOKUP2, "LatticeStructure.merge_lookup's call of ops_cuda.lookup.lookup2: two-column keys (d > 3)"),
    (HOST_READ, "the host blocked on a value read back from the device"),
    (MODEL, "LNN.forward, whole"),
    (MODEL_DISTRIBUTE, "distribute_sorted and PointNetModule_0"),
    (MODEL_DOWN, "the encoder's blocks and coarsenings, and the bottleneck"),
    (MODEL_UP, "the decoder's finefies, skips and blocks"),
    (MODEL_SLICE, "SliceFastModule_0 and the log-softmax"),
    (NORM, "a masked GroupNorm of the modules, every call: GroupNormLattice's forward and norm_act"),
    (NORM_FUSED, "inside lnt.norm: norm_act's call of ops_cuda.norm.group_norm_act (outside autograd)"),
    (STEP_FORWARD_LOSS, "data_parallel.forward_loss: builds, forwards and the loss"),
    (STEP_BACKWARD, "data_parallel.gradients: the backward, autograd's thread included"),
    (STEP_UPDATE, "data_parallel.apply_update: the optimizer's update"),
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
