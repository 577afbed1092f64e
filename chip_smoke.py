#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lattice_net_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no ``"ok"`` line); phases 2-9
run the default head (``LNT_HEAD_SEGVJP=0``) whatever the caller's
environment:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the eight ``csrc/*.cu`` (one nvcc per source, in
   parallel) and the native scan reader (``native/cloud_loader.cpp``, g++);
2. the forward kernels K1 and K2 against their plain PyTorch versions on
   the card, on exactly the inputs of each of their calls in one served
   scan (recorded during that forward): bit equality required; kernel,
   plain and library times by CUDA events.  K1 also runs twice, into
   blocks with every bit set, on each of its edge cases (``k1_cases``: widths
   1, 7, 13 and 29 in f32 and bf16 with and without the centre column, both
   of its layouts' extremes, ids = cap, > cap and negative, tables 4 and 8
   bytes past a 16-byte boundary, Q = 1, K = 1, K = 13, partial staged
   tiles with narrow tails, centre columns of a row block past the first),
   both outputs bit-equal to the plain version.  K2 runs twice on each of six
   cases, its outputs landing on NaN-filled blocks of the caching
   allocator, both outputs bit-equal to the plain version and to
   themselves: the recorded call, ties planted, ``PAD_EDGES`` edges in no
   run appended, ``LONG_RUN`` edges added to one vertex, ties planted on
   both sides of the 32-row chunk bounds of that long run (the later row
   must win), and ``NARROW_K2B`` random columns (the scalar kernel).  Its
   row also times one max-only ``torch.segment_reduce``, labelled as a
   reference: it computes no carry, so it is not K2's library call;
3. serving: ``Predictor.from_config`` on the SemanticKITTI eval config at
   full width (seeded random weights) answers five 2^17-point scans and one
   of 100000 points padded with a point mask; per request the latency, the
   per-level occupancy and the kernel launch counts, which must equal the
   model's 15 patch gathers and 1 max-pool;
4. the same scan with the kernels and with their plain versions (bf16 convs
   both; the fused GroupNorm on its kernel both sides, ``norm_on_its_kernel``,
   as in phases 15, 16c, 17 and 20a): labels agree on >= 99.9% of points,
   log-probabilities to 1e-3;
5. a small scan in f32 on the card against the plain path on the CPU (the
   path the CPU tests hold against the JAX package): log-probabilities to
   1e-3, labels on >= 99%;
6. all four kernels against their plain versions, on exactly the inputs of
   each of their calls in one train step of phase 7 (recorded during that
   step): K1's 43 calls (the forward's 15, and in each conv's backward the
   recomputed patch and the flipped conv of the cotangent) and K2 (on the
   cases of phase 2) bit-equal, K1-bwd (f32 atomics) to ``BWD_TOL`` on the
   recorded call and three cases built from it (the centre column on a
   same-level table, ids equal to cap and negative, ``NARROW_K1B`` random
   columns), twice each into NaN-filled blocks, with the gap between the
   two runs and the share of the head's rows whose destination repeats
   within 32 consecutive points; kernel, plain and library times and byte
   bounds per call, summed per step.  The max-pool's run lengths are
   printed (edges in runs, non-empty runs, mean, p99, max, a log2
   histogram).  K2-bwd runs twice on each of five cases, its outputs landing
   on blocks of the caching allocator filled with NaN: the recorded call,
   ties planted, ``PAD_EDGES`` edges in no run appended, ``LONG_RUN`` edges
   added to one vertex, and ``NARROW_K2B`` random columns (C % 4 != 0, the
   scalar kernel).  Its d_vals must be bit-equal to the plain version and to
   itself, its d_carry within ``BWD_TOL`` and bit-equal to itself;
7. training: the SemanticKITTI train config at full width (seeded random
   weights, bf16 convs, AdamW-amsgrad with cosine warm restarts) takes 10
   steps of ``make_train_step`` on one 2^17-point scan with its labels; per
   step the time, the loss, the level-0 occupancy, the overflow and the
   launches of the six kernels, which must equal 3 gathers per conv module
   plus the head's (43), 1 each of K1-bwd, K2 and K2-bwd, and no K3 or K4.
   The loss and the new parameters must stay finite, and the mean loss of
   the last 3 steps must be below that of the first 3;
8. one step's loss and gradients with the kernels and with their plain
   versions from the same state (bf16 convs both): loss to 1e-5, each
   parameter's gradient to ``TRAIN_PLAIN_GRAD_REL``.  Also printed: how far
   a second run with the kernels lies from the first, and how far a run
   lies when the flipped gather of one conv reads the wrong row for 1% of
   its queries (each conv in turn), which must exceed the tolerance;
9. a small f32 step on the card against the plain path on the CPU: loss to
   1e-5, each parameter's gradient to ``TRAIN_CPU_GRAD_REL``;
10. K3 and K4 against their plain versions, on exactly the inputs of their
    calls in one train step with the edge-sort head adjoint
    (``LNT_HEAD_SEGVJP=1``) of the preclassified head (f32 K4, K3 at
    C = 28): K4 bit-equal, K3 within ``BWD_TOL`` of its plain version
    (whose ``index_add_`` adds with atomics) and bit-equal to itself run
    twice, into NaN-filled blocks, on the recorded call and on the cases of
    phase 6 (``NARROW_K3`` random columns for the width); the run lengths of
    each call; kernel, plain and library times and byte bounds per call;
11. training with ``LNT_HEAD_SEGVJP=1``: from phase 7's state and scan,
    ``TRAIN_STEPS`` steps, each run right after a step of the default head
    from its own copy of that state, so that the two step medians come from
    interleaved runs.  Per step the time, the loss and the launches, which
    must equal the model's: K1 loses the head's gather (42), K4 and K3 one
    each, K1-bwd none, K2 and K2-bwd one each.  The loss must fall as in
    phase 7;
12. one segvjp step's loss and gradients against the default head's, against
    its plain versions (bf16 convs both), and card f32 against the CPU's
    plain path, at ``LOSS_ATOL``, ``TRAIN_PLAIN_GRAD_REL`` and
    ``TRAIN_CPU_GRAD_REL``.  Two faults are planted, and each must move the
    gradients past the tolerance: K3 sums one vertex's run into its
    neighbour's row (the vertex with the largest run sum), and it does so for
    1% of the vertices;
13. one train step with ``dropout_last_layer = 0.5`` and a Philox generator
    on the card: finite loss and parameters, one keep mask for one seed, and
    the same loss from two forwards with generators of one seed;
14. the training CLI's ``run`` on the card: ``config/lnn_train_synthkitti20.cfg``
    at full width (2^17-point procedural 20-class scenes, capacities
    65536/32768/16384, sigma 0.6, ``"auto"`` class weights,
    ``reduce_on_plateau``) with 8 train and 4 test scenes, checkpoints and a
    scene cache in a temporary directory, for 2 epochs testing after each;
    then ``run(..., max_epochs=3, resume=<dir>/last.ckpt)``.  The printed
    class weights must agree with line 43 of ``docs/runs/synthkitti20_r5.log``
    (the JAX run's) within ``CLASS_WEIGHT_ATOL`` (the entries equal to 3
    decimals are counted); every train and test loss must be
    finite; each train step must launch the default head's kernels (43 K1,
    1 K1-bwd, 1 K2, 1 K2-bwd, no K3 or K4) and each test forward no
    backward kernel (15 K1, 1 K2); ``last.ckpt`` and one ``model_e_*`` file
    must exist; ``last.ckpt`` must load bit-equal to the first run's final
    state; the second run must resume at step 16 (epoch 2) and end at step
    24, its plateau state equal to the saved one carried through its 8 step
    losses.  Printed per epoch: the train and test loss, the mIoU and the
    samples per second (the first train epoch's include the scene
    synthesis on the host);
15. SemanticKITTI evaluation: ``write_kitti_dir`` writes ``KITTI_SCANS``
    20-class 2^17-point scans in the dataset's layout (train in sequence 00,
    test in 11) in a temporary directory, which is also the working
    directory of the phase; the training CLI trains one epoch of
    ``config/lnn_train_semantic_kitti.cfg`` at full width on them (only the
    dataset and checkpoint paths overridden; its test phase falls back to
    sequence 11), then ``ln_eval`` runs ``config/lnn_eval_semantic_kitti.cfg``
    from its ``last.ckpt`` twice, at the default budget (one chunk a scan)
    and at ``EVAL_CHUNK`` points (two).  Each run must write one ``.label``
    per test scan at ``sequences/11/predictions/<scan>.label`` with one
    uint32 per velodyne point, every value one of ``LEARNING_MAP_INV``'s;
    launch 15 K1 and 1 K2 per chunk and no other kernel; label >= 99.9% of
    points as ``Predictor.forward(plain=True)`` does on the same chunks; and
    ``prepare_submission`` must accept its directory.  The one-chunk run's
    mIoU must be within ``EVAL_MIOU_ATOL`` of the trainer's test phase (the
    same weights and scans).  Printed: seconds per scan and scans/s and the
    mIoU of both budgets, beside the CPU ablation's gap
    (``docs/runs/eval_chunk_ablation.log``).  Then ``ln_eval_stream`` runs
    ``config/ln_eval_stream.cfg`` with seeded weights, ``STREAM_SCENES``
    scenes and ``STREAM_SCANS`` scans at ``STREAM_HZ`` for each wire (f32,
    f16, i16): one finite latency per scan, 15 K1 and 1 K2 launches per
    forward, the f32 wire's labels equal to ``Predictor.predict``'s on the
    same scans (the other wires' agreement printed), and its compute-only
    and H2D times, MB per scan, end-to-end p50/p95/max, misses and
    sustained scans/s printed;
16. ScanNet at full width (``config/lnn_train_scannet.cfg``, 8,975,297
    parameters).  (a) ``misc/scannet_scale_probe.run``: the build of
    ``make_indoor_scene(400000, seed=0)`` at the 5,242,880 schedule, its
    per-level occupancy printed beside the JAX probe's
    (``docs/runs/scannet_probe_full.log``), no overflow; one full-width forward at
    2^21 with the parameter count checked and the occupancy equal to the
    5M build's; K1 on that forward's head gather (its splat ids into a
    (2^21, 8 + 21) f32 table), bit-equal and timed.  (b) ``write_scannet_dir``
    writes ``SCANNET_SCENES`` rooms of
    400k points in a temporary working directory; the training CLI trains one
    epoch with ``capacity_mode=auto``, headroom 1.5 and ``--n-points 400000``
    (the JAX run's command, ``docs/runs/scannet_ln_train_r5.log``, whose scout
    line is printed beside the port's): 202/1/1/1 launches of K1/K1-bwd/
    K2/K2-bwd a train step, 68/0/1/0 a test forward, and the test phase reads
    the train scenes (ScanNet's ``val``, as in JAX).  Then K1, K2, K1-bwd and
    K2-bwd against their plain versions on the inputs of one ScanNet step (a
    400k-point scene in a 2^19 budget) as in phase 6, and ``SCANNET_STEPS``
    timed steps.  (c) ``ln_eval`` on ``config/lnn_eval_scannet.cfg`` from that
    ``last.ckpt`` at the config's 5,000,000-row tables over the test scenes:
    one ``<scene>.txt`` with a line per raw point (NYU40 ids), K1 launched once
    per conv row block (as the conv's block rule counts them) plus the head's,
    labels vs ``Predictor.forward(plain=True)`` >= 99.9%, and each scene's
    forward with row-chunked convs against the same forward with every conv in
    one block (``LNT_CONV_CHUNK_BYTES`` = ``SCANNET_UNCHUNKED``), in bf16 and
    once in f32: labels >= 99.9%, log-probabilities to 1e-3, with the blocks of
    each chunked conv, the K1 launches and the peak memory both ways printed.
    K1 is also held against its plain version and timed on one call of each
    shape of that forward (one row block each, and for a same-level conv one
    more past the first block, its centre column at a row offset);
17. ShapeNet part segmentation at full width
    (``config/ln_train_shapenet_example.cfg``, 5,034,115 parameters, batch 4,
    capacities 60000/30000/15000/7500, sigma 0.05, 7 classes), in a
    temporary working directory.  (a) ``write_benchmark_dir`` writes
    ``SHAPENET_SCENES`` motorbikes of ``SHAPENET_POINTS`` points; the training
    CLI trains one epoch of the config as written (the dataset and checkpoint
    paths overridden), through the native reader: the parameter count, no
    overflow, each train step launching the model's K1/K1-bwd/K2/K2-bwd
    counts once per batch slot (4) and each test forward no backward kernel;
    then ``ln_eval`` on ``config/lnn_eval_shapenet.cfg`` from its
    ``last.ckpt`` writes one ``pred_<stem>.txt`` per test cloud with a line
    per point, labels vs ``Predictor.forward(plain=True)`` >= 99.9%, seconds
    a cloud printed.  (b) K1, K2, K1-bwd (the head's C = 15) and K2-bwd
    against their plain versions on the inputs of one step of four train
    clouds, as in phase 6, summed over the step, and ``SHAPENET_STEPS`` timed
    steps.  (c) The JAX log's command (``docs/runs/shapenet_format_train.log``:
    ``SHAPENET_LOG_SCENES`` clouds, capacity 16384, 12 epochs testing every
    2), each epoch's occupancy and each held-out mIoU printed beside the
    log's, then ``ln_eval``'s mIoU beside ``docs/runs/shapenet_format_eval.log``;
    no overflow, and the last held-out mIoU above ``SHAPENET_LEARNED_MIOU``.
    (d) One train step in each ablation mode (``ABLATIONS``) from the same
    weights and batch: finite, with the launches of ``"none"``;
18. the rest of the single-card surface, each path's launches counted
    (``launches_phase18``).  (a) bench.py's ``LNT_CANONICAL=1`` program at
    its width (``BENCH_MODEL``, sigma 0.6, capacities 65536/32768/8192, a
    2^17-point scan): ``canonical_point_order`` on the card, the
    corner-dedup fast build, the distribute's row gather (K4), the forward
    and the labels scattered back to input order: 15/1/1 launches of
    K1/K2/K4, labels >= 99.9% equal to the default path's on the same
    reordered points (its edge sort equal too) and >= 90%
    (``CANONICAL_INPUT_ORDER_FLOOR``) equal on the input order, where the
    default path's local mean, an f32 prefix sum, rounds by the edge order;
    both builds' ms and the share of points where the host twin's order
    equals the card's are printed; every K1, K2 and K4 call held against
    its plain version.  (b) The scale probe's ``--train-step`` (the ScanNet
    model at 2^21 with and without ``remat_blocks``: ms, loss, peak memory,
    or that it does not fit), and one step at phase 16's auto capacities
    both ways: identical ``state_dict`` keys, loss within ``LOSS_ATOL``,
    gradients within ``TRAIN_PLAIN_GRAD_REL`` in f32 convs, and in bf16
    within ``REMAT_CONTROL_MARGIN`` times the gap of two bf16 steps without
    remat (never under ``TRAIN_PLAIN_GRAD_REL``); K1 launches the model's
    plus its blocks' recomputed convs.  (c) The training CLI on
    ``SYNTH_CONFIG`` (phase 14's scenes, one epoch) with ``LNT_CANONICAL_TRAIN=1`` and
    ``model.remat_blocks=true`` (one K4 a forward, the recomputed K1).  (d) The
    lattice library at KITTI scale (``LIB_CAPS``): bilateral blur, slice,
    gather, depthwise conv and each new block forward and backward against
    the plain path (forward 1e-3, gradients ``TRAIN_PLAIN_GRAD_REL``; every
    K1 call bit-equal), splat and segment max against the CPU, ``BatchNormLattice`` in training and evaluation,
    ``expand`` against the CPU, ``create_splatting_mask``, and a build with
    ``coarse_mode="resplat"`` whose tables and occupancy equal the default
    build's;
19. data and lattice parallelism over torch.distributed (``parallel/``),
    ranks spawned by ``mesh.launch`` after the kernels are built here, each
    main path's launches counted in its rank (``launches_phase19``, summed
    over the ranks).  One launch of 2 and one of 4 ranks share the card over
    gloo on CUDA tensors: (a) every collective of a 2-, a 4- and a 2x2 mesh
    and its gradient equal to plain sums (in rank order) and shifts; (b)
    the KITTI train config's model in f32 convs on a 2^17-point scan,
    striped at sp = 2 and 4 (the band check raises at 4, which then runs
    ``--sp-approx``): each rank's forward with 15/1 K1/K2 launches, against
    its plain version on the same stripes (``SERVE_TOL``), against the same
    stripes' forwards in threads here with the halo rows, owner masks and
    summed GroupNorm moments made apart from ``parallel/``
    (``P19_WITNESS_ATOL``), and against the single-card forward (labels at
    ``P19_SINGLE_CARD_FLOOR``, the JAX gates' numbers printed); one sharded
    step at sp = 2 a scan (43/1/1/1), the first against its plain version
    on the same stripes (``P19_GRAD_REL``), its loss and gradient norm
    against the single card's (``P19_GRAD_RATIO``); (c) ``P19_DP_STEPS`` DP
    steps on 2 ranks with the config's AdamW and as many with plain SGD,
    against the single-card steps on the same 2-scan batch: the averaged
    gradients within ``P19_GRAD_REL``, the SGD parameters within
    ``P19_PARAM_ATOL``, AdamW replayed here over the DP step's own
    gradients bit-equal to its parameters, and the AdamW gap to the single
    card printed beside two single-card runs' gap; then one hybrid dp2 x sp2
    step whose loss is the count-weighted mean of the per-scan sharded
    losses (``P19_LOSS_RTOL``) and whose gradients are that mean of theirs
    and equal to its plain version's (``P19_GRAD_REL``);
    (d) the ScanNet model at full width in f32 convs on one 400k-point room
    at phase 16's auto capacities, sp = 2: forward and one step, each
    against its plain version on the same stripes, occupancy, overflow
    (0), peak memory per rank, ms.  (f) NCCL at the card count: the DP step
    bit-equal to the single-card step (``LNT_HEAD_SEGVJP=1``, whose head
    adjoint adds in a fixed order; the single-card step twice is the
    control); with two cards or more (c)'s DP steps over NCCL too.  (e)
    ``ln_train --dp`` (2 ranks) and ``--sp 2``, one epoch of phase 14's cut
    of ``SYNTH_CONFIG``, then ``ln_eval --sp 2`` on 3 scans from the DP
    run's checkpoint against the unsharded eval (``P19_SINGLE_CARD_FLOOR``).
20. lattices of d > 3, the plain-gather switch, the batched build and the tools
    (``launches_phase20``; each main path's launches counted as in phase
    18).  (a) d = 4: ``lnn_eval_semantic_kitti.cfg``'s model with
    ``model.positions_mode=xyz+intensity`` serves ``P20_SCANS`` 2^17-point
    scans at capacities scouted on them (auto, headroom 1.5; no overflow),
    15/1 K1/K2 a scan, labels against plain (``SERVE_TOL``); two steps of
    ``lnn_train_semantic_kitti.cfg`` with the same override (43/1/1/1); K1
    (extents 11, the head at K = 5), K2, K1-bwd and K2-bwd on the inputs of
    the served scan and of a step against their plain versions; a step's
    gradients against plain in f32 convs (``P20_GRAD_REL``).  (b) d = 6:
    ``lnn_train_scannet.cfg`` with ``model.positions_mode=xyz+rgb`` on one
    ``synth_scannet`` room of ``P20_POINTS`` points (the config's 400000
    cut) at scouted capacities: one forward, one step (K1 one a row block of
    each conv), the kernels on a step's inputs (K1 one call a shape: extents
    15, the head at K = 7) and the gradients as in (a).  (c)
    ``P20_TIMED_STEPS`` steps with ``LNT_FAST_OPS=0`` (no K1, K1-bwd or K4;
    K2 and K2-bwd still) beside as many without, both step times.  (d)
    ``static_general_branches()`` builds bit-equal to the default ones at
    d = 4 and d = 3; ``batch_scaling_probe`` at ``P20_BATCHES``.  (e) Each
    new tool once: ``lnn_grad_check`` (f32 kernels vs plain),
    ``compute_class_frequency``, ``lnn_check_lattice_size`` and
    ``lnn_make_teaser`` on the toy config, ``profile_train`` on the KITTI
    config and on the ScanNet config at auto capacities (``SCANNET_POINTS``
    in a ``SCANNET_STEP_BUDGET`` budget), ``profile_forward`` and
    ``profile_build`` on the served scan.
21. the measuring tools (``launches_phase21``; each census and the traced
    forward counted as a main path, as in phase 18).  (a) ``op_census`` of
    the served scan and of a train step on the card at ``P21_POINTS``,
    beside the same censuses on the CPU (``--device cpu``, two background
    processes started first): every class side by side, the ``kernel:*``
    and ``host_sync`` counts equal; on the card each census's kernel counts
    equal to the wrappers' launches.  (b) The same two censuses on the card
    at ``P21_FULL_POINTS`` (``hlo_census``'s settings): each class's count
    and result MB, the top functions.  (c) ``profile_forward --trace DIR
    --trace-only`` on the KITTI eval config: ``parse_trace``'s device total
    of that file within ``P21_TRACE_RTOL`` of the same capture's
    ``device_ms``.  (d) ``prim_cost_chip`` at M = 2^19: every row's marginal
    ms, and each row's output on the card equal to the CPU's on the same
    input (ints exactly, float sums within ``P21_FLOAT_RTOL``).  (e)
    ``cache_key_probe --children 2``: equal keys, the first child builds
    every kernel into a fresh directory and the second none, each child's
    seconds to its first kernel call.
22. the fused masked GroupNorm + activation (``csrc/group_norm_act.cu``): on
    every call of a served SemanticKITTI sweep (16) and of a labelled
    ScanNet room of ``P22_ROOM_POINTS`` points at the 5M tables (82: each
    level, width and output dtype) the kernel against its plain version on
    the same inputs: f32 outputs within ``P22_F32_TOL`` of the largest
    output (the statistics sum in another order), bf16 outputs the kernel's
    f32 output rounded once and equal to the plain version's or 1 ulp from
    it (further only where the f32 outputs lie within the tolerance), two
    launches bit-equal.  The launches and the ``lnt.norm`` /
    ``lnt.norm.fused`` / ``lnt.host_read`` spans of one forward: 16/16/16/1
    a sweep, 82/82/82/0 a room; no launch and no fused span in a KITTI
    train step.  Each call's shape timed once (``device_ms``) beside its
    byte bound (``p22_bound_ms``) and the plain version, summed over the
    sweep and the room.  Edge cases: C = 7 in one group, a misaligned
    table, masks of no row, every row, a prefix and a scattered set.  End to
    end, a served sweep through the kernels against the plain path: in f32
    convs within ``SERVE_TOL``; in bf16 convs within ``P22_CONTROL_MARGIN``
    times the gap of a control (the plain path with the norm's statistics in
    float64), since bf16 convs carry the norm's last-bit differences through
    the net.
23. the lookup of two-column keys (``csrc/lookup2.cu``): one labelled 6-D
    room (``xyz+rgb``, ``P23_ROOM_POINTS`` points) at the 5M tables, its
    launches and spans (7 launches, 7 ``lnt.build.lookup2``, 4
    ``lnt.build.sort2``, no host read); at the build's level-0 same-level
    call (35M queries) and level-1 coarsen call (37.5M) the kernel twice, its
    plain version and the merged composition it replaced
    (``port_bench/reference``'s ``_merged``), all bit-equal, each timed
    (``device_ms``) beside the byte bound; the kernel against the plain
    version on small tables (``P23_EDGE_TABLES``: no row occupied, one, two,
    the occupied prefix on both sides of the shared-memory levels, every
    row), no query, and the wrapper refusing a misaligned table.

Each timed call has two times: ``ms`` (:func:`time_ms`, back-to-back calls
between two CUDA events, which counts the card's idle gaps where the host
issues a call more slowly than the card runs it) and ``device_ms``
(:func:`device_ms`, the same calls queued behind a sleeping kernel, so the
card alone); likewise ``plain_*`` and ``library_*``.

The next-to-last lines are the card (``nvidia-smi`` name, power limit) and
one JSON object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "lnn_eval_semantic_kitti.cfg"
TRAIN_CONFIG = ROOT / "config" / "lnn_train_semantic_kitti.cfg"
SYNTH_CONFIG = ROOT / "config" / "lnn_train_synthkitti20.cfg"
# the JAX run of SYNTH_CONFIG; its line 43 prints the "auto" class weights
JAX_RUN_LOG, JAX_WEIGHTS_LINE = ROOT / "docs" / "runs" / "synthkitti20_r5.log", 43
TRAINER_SCENES = dict(train=8, test=4)
# The JAX run's weights are those of scout scenes with a few points labelled
# otherwise: its 3-decimal weights imply label counts that differ from the
# generator's by whole points, 1-5 at the least of the scout's 4 * 2^17 in 8
# of the 20 classes, which moves those weights by up to 0.003
# (tests/test_torch_data.py::test_jax_scout_class_weights_against_the_r5_log
# pins the gaps).  The generator is unchanged since the run: the JAX package
# at that run's commit prints the port's weights on the CPU test host, and
# so does this card's host.  That run read its scout scenes from an
# LNT_SCENE_CACHE directory filled earlier, on a host and numpy the repo does
# not record.
CLASS_WEIGHT_ATOL = 5e-3
TRAINER_EPOCHS = 2
STREAM_CONFIG = ROOT / "config" / "ln_eval_stream.cfg"
CHUNK_ABLATION_LOG = ROOT / "docs" / "runs" / "eval_chunk_ablation.log"
KITTI_SCANS, KITTI_POINTS = dict(train=4, test=3), 1 << 17
EVAL_CHUNK = KITTI_POINTS // 2  # two chunks a scan
# the eval's one-chunk forward is the trainer's test forward on the same
# weights, scans and budget (bf16 convs both)
EVAL_MIOU_ATOL = 1e-3
STREAM_SCENES, STREAM_SCANS, STREAM_HZ = 8, 20, 10.0
SCANNET_TRAIN_CONFIG = ROOT / "config" / "lnn_train_scannet.cfg"
SCANNET_EVAL_CONFIG = ROOT / "config" / "lnn_eval_scannet.cfg"
# JAX runs of the same scene generator on a TPU, printed beside the port's
# numbers and not a gate but for the overflow: the probe's 5M-table build of
# make_indoor_scene(400000, seed=0), and the trainer's capacity scout
SCANNET_PROBE_LOG = ROOT / "docs" / "runs" / "scannet_probe_full.log"
SCANNET_TRAIN_LOG = ROOT / "docs" / "runs" / "scannet_ln_train_r5.log"
SCANNET_SCENES, SCANNET_POINTS = dict(train=4, test=2), 400000
SCANNET_PARAMS = 8_975_297  # the JAX init of the ScanNet model (SCANNET_PROBE_LOG)
SCANNET_STEPS = 6
SCANNET_STEP_BUDGET = 1 << 19  # 124,288 masked rows under a 400k-point scene
SCANNET_EVAL_CAPS = (5_000_000, 2_500_000, 1_250_000, 625_000)
SCANNET_UNCHUNKED = 1 << 40  # an LNT_CONV_CHUNK_BYTES that keeps every conv in one block
SHAPENET_TRAIN_CONFIG = ROOT / "config" / "ln_train_shapenet_example.cfg"
SHAPENET_EVAL_CONFIG = ROOT / "config" / "lnn_eval_shapenet.cfg"
SHAPENET_PARAMS = 5_034_115  # the JAX init of the ShapeNet model (SHAPENET_TRAIN_LOG)
SHAPENET_CLASSES = 7  # the motorbike's six parts and unlabeled
SHAPENET_SCENES, SHAPENET_POINTS = dict(train=8, test=4), 2500
SHAPENET_STEPS = 6
# The JAX package's run over procedural motorbikes in the benchmark's layout
# (write_benchmark_dir's defaults: 16 train and 8 test clouds, so 4 train
# forwards and one held-out forward of the 4 val clouds an epoch at batch 4,
# as its "[train] 4 samples" and "[test] 1 samples" lines say), at
# capacity 16384 for 12 epochs testing every 2, then ln_eval on the test
# split; its numbers are printed beside the port's, which start from other
# weights (a torch seed, not the flax init): the gate is learning, not parity
SHAPENET_TRAIN_LOG = ROOT / "docs" / "runs" / "shapenet_format_train.log"
SHAPENET_EVAL_LOG = ROOT / "docs" / "runs" / "shapenet_format_eval.log"
SHAPENET_LOG_SCENES = dict(train=16, test=8)
SHAPENET_LOG_CAPACITY, SHAPENET_LOG_EPOCHS, SHAPENET_LOG_EVAL_EVERY = 16384, 12, 2
SHAPENET_LEARNED_MIOU = 0.5  # the last held-out mIoU must exceed it
ABLATIONS = ("pointnet_no_local_mean", "pointnet_no_elevate_no_local_mean", "splat")
# phase 18: bench.py's model and capacities (bench.py:110-130), a 2^17-point
# scan; the lattice library at the eval config's level-0 capacity
BENCH_MODEL = dict(
    nr_classes=20, pointnet_channels_per_layer=(16, 32), pointnet_start_nr_channels=32, nr_downsamples=2,
    nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
    nr_levels_down_with_normal_resnet=3, nr_levels_up_with_normal_resnet=3,
)  # fmt: skip
BENCH_CAPS, BENCH_SIGMA, BENCH_POINTS = (1 << 16, 1 << 15, 1 << 13), 0.6, 1 << 17
LIB_CAPS, LIB_C = (100000, 50000), 16
NR_CLASSES = 20
KITTI_TRAIN_SCANS = 19130  # one epoch at batch size 1: the schedule's period is 3
TRAIN_STEPS = 10
KERNELS = ("patch_gather", "seg_max", "patch_scatter", "seg_max_bwd", "seg_sum", "take_rows", "group_norm_act",
           "lookup2")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the times of each kernel row: PR 4's yardstick (time_ms) and the card alone
# (device_ms), each for the kernel, its plain version and the library call
TIMES = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms", "library_device_ms",
         "bound_ms")
SERVE_TOL = dict(logp_max_abs=1e-3, label_agreement=0.999)
CPU_TOL = dict(logp_max_abs=1e-3, label_agreement=0.99)
# canonical serving vs the default path on the input order: the default
# path's labels follow the point order (0.937 on the card at 2^17 points in
# bf16; JAX's own programs 0.992 on the CPU at 2^12 in f32), so a floor
# under both readings
CANONICAL_INPUT_ORDER_FLOOR = 0.9
# f32 atomics (K1-bwd, and K3's plain version's index_add_) and a
# warp-shuffle sum over channels (K2-bwd's d_carry) add in another order than
# the other side: each entry within 1e-4 of itself plus 1e-6 of the largest
# entry
BWD_TOL = dict(rtol=1e-4, atol_of_max=1e-6)
LOSS_ATOL = 1e-5
# kernels vs plain, bf16 convs: about twice the largest reading on an H100
# (1.56e-3 to 2.01e-3).  K1-bwd's atomics and K2-bwd's d_carry add in another
# order than the plain versions, and the phase prints how far two runs with
# the kernels lie apart for that reason alone.  A flipped gather wrong on 1% of
# its rows must fail this limit: the phase plants that fault in each conv.
TRAIN_PLAIN_GRAD_REL = 4e-3
# remat vs no remat, bf16 convs: the limit is this many times the gap of two
# steps without remat (the control: K1-bwd's f32 atomics add in another order
# each run, and bf16 cotangents round that up), and never under
# TRAIN_PLAIN_GRAD_REL
REMAT_CONTROL_MARGIN = 2.0
# card vs CPU, f32: every GEMM, norm and scatter sums in another order, and
# the deep layers' f32 gradients are only good to ~1e-3 on any device (the
# CPU's own are up to 6e-4 from f64 there: misc/grad_precision.py)
TRAIN_CPU_GRAD_REL = 5e-3
DROPOUT = 0.5
# cases built from a recorded K2, K2-bwd or K3 call: edges in no run
# appended, edges added to one vertex's run; and for those and K1-bwd,
# widths with C % 4 != 0 (13; 13 + 8 for K3, whose vector path starts above
# C = 8)
PAD_EDGES = 4096
LONG_RUN = 8192
NARROW_K2B = 13
NARROW_K1B = 13
NARROW_K3 = 13 + 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` back-to-back calls, by CUDA events.
    Where the host takes longer to issue a call than the card to run it,
    this counts the card's idle time between the calls too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters=20, warmup=3, sleep_cycles=20_000_000):
    """Mean ms per call on the card alone: ``iters`` calls queued behind a
    kernel that spins while the host issues them, so that the card runs
    them back to back whatever the host's pace.  The sleep grows until it
    outlasts the host's issuing; None where it never does, because the
    calls wait for the card themselves (``segment_reduce`` reads its output
    size back to the host)."""
    for _ in range(warmup):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(3):
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(sleep_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        sleep_cycles *= 4
    return None


def timings(torch, kernel, plain, library=None):
    """``ms``/``plain_ms``/``library_ms`` as :func:`time_ms` reads them, and
    the same three as :func:`device_ms` reads them (``*device_ms``)."""
    row = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        row[key] = None if fn is None else time_ms(torch, fn)
        row[key.replace("ms", "device_ms")] = None if fn is None else device_ms(torch, fn)
    return row


def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )  # fmt: skip
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    import numpy

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"numpy {numpy.__version__}")  # fmt: skip
    from lattice_net_tpu_torch.ops_cuda import _build

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    names = ", ".join(f"csrc/{k}.cu" for k in KERNELS)
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    from lattice_net_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    lib = native_loader.build_native()
    print(f"built the native scan reader {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    return card


def scan(pred, n_points, seed):
    """(positions, values) of one synthetic LiDAR scan, per the config's modes."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud

    positions, values, _ = prepare_cloud(make_scene(n_points, seed=seed), pred.params)
    return positions, values


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables (the head's switches) inside the block."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def segvjp():
    return environ(LNT_HEAD_SEGVJP="1")


def default_head():
    return environ(LNT_HEAD_SEGVJP="0")


@contextlib.contextmanager
def norm_on_its_kernel():
    """Inside the block a forward with ``plain=True`` keeps the fused
    GroupNorm on its kernel.  The end-to-end kernels-vs-plain checks hold
    the kernels that equal their plain versions bit for bit (K1-K4): the
    norm's plain version sums its statistics in another order, a last-bit
    difference that bf16 convs carry through the net, so both sides run the
    same norm there, and phase 22 holds the norm against its plain version,
    per call and end to end beside a control."""
    from lattice_net_tpu_torch.ops_cuda import norm

    plain = norm.group_norm_act_plain
    norm.group_norm_act_plain = lambda lv, *args: (plain if lv.device.type == "cpu" else norm._group_norm_act)(lv, *args)
    try:
        yield
    finally:
        norm.group_norm_act_plain = plain


@contextlib.contextmanager
def recording_kernel_inputs(torch, keep_k1=None):
    """Records the inputs of every kernel call made inside the block, in call
    order, copied as the caller passed them (K1's only where ``keep_k1(values,
    neighbors, include_center, row0)`` is true, if given): yields ``(calls, phase)`` with
    ``calls = {"k1": [(values, table, include_center, role, row0), ...], "k2":
    [...], "k1b": [...], "k2b": [...], "k3": [...], "k4": [...]}``.  K1
    calls made after the caller sets ``phase[0] = "backward"`` alternate
    between the two of each conv's backward: the recomputed patch of the
    weight gradient, then the flipped conv of the value gradient (the order
    of ``ops._ConvFlip.backward``)."""
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.ops_cuda import patch, segment

    calls = dict(k1=[], k2=[], k1b=[], k2b=[], k3=[], k4=[])
    phase = ["forward"]
    k1, k2, k3, k4 = ops.patch_gather, ops.seg_max_carry, ops.seg_sum_sorted_fast, ops.take_rows
    k1b, k2b = patch.patch_scatter, segment.seg_max_carry_bwd

    def recording_k1(values, neighbors, include_center, plain=False, row0=0):
        role = phase[0]
        if role == "backward":
            n_bwd = sum(c[3] != "forward" for c in calls["k1"])
            role = ("backward: patch of d_w", "backward: flipped conv of d_values")[n_bwd % 2]
        if keep_k1 is None or keep_k1(values, neighbors, include_center, row0):
            calls["k1"].append((values.detach().clone(), neighbors.clone(), include_center, role, row0))
        return k1(values, neighbors, include_center, plain=plain, row0=row0)

    def recording_k2(*args, plain=False):
        calls["k2"].append(tuple(t.detach().clone() for t in args))
        return k2(*args, plain=plain)

    def recording_k3(vals, ids, run_end, cap, plain=False):
        calls["k3"].append((vals.detach().clone(), ids.clone(), run_end.clone(), cap))
        return k3(vals, ids, run_end, cap, plain=plain)

    def recording_k4(values, idx, plain=False):
        calls["k4"].append((values.detach().clone(), idx.clone()))
        return k4(values, idx, plain=plain)

    def recording_k1b(g, neighbors, cap, include_center):
        calls["k1b"].append((g.clone(), neighbors.clone(), cap, include_center))
        return k1b(g, neighbors, cap, include_center)

    def recording_k2b(*args):
        calls["k2b"].append(tuple(t.clone() for t in args))
        return k2b(*args)

    # the backward wrappers count on the module names they are called by,
    # which are the recorders' here: give those counts a home (a recording
    # run is not the main path, whose counts start at 0 later)
    recording_k1b.launches = recording_k2b.launches = 0
    ops.patch_gather, ops.seg_max_carry = recording_k1, recording_k2
    ops.seg_sum_sorted_fast, ops.take_rows = recording_k3, recording_k4
    patch.patch_scatter, segment.seg_max_carry_bwd = recording_k1b, recording_k2b
    try:
        yield calls, phase
    finally:
        ops.patch_gather, ops.seg_max_carry = k1, k2
        ops.seg_sum_sorted_fast, ops.take_rows = k3, k4
        patch.patch_scatter, segment.seg_max_carry_bwd = k1b, k2b


def check_k1(torch, calls, dev, where):
    """K1 against its plain version and ``index_select`` on each recorded
    call ``(values, table, include_center, role, row0)``, bit-equal, and
    timed there with its byte bound.  Returns the sums over the calls and
    prints them with the share of the bound."""
    from lattice_net_tpu_torch.ops_cuda.patch import _check, patch_gather, patch_gather_plain

    tot = dict(calls=len(calls), max_abs_err=0.0, **dict.fromkeys(TIMES, 0.0))
    for v, table, center, role, row0 in calls:
        (cap, c), (q, k) = v.shape, table.shape
        label = f"cap={cap} C={c} Q={q} K={k}{'+centre' if center else ''}{f' row0={row0}' if row0 else ''}"
        got = patch_gather(v, table, center, row0=row0)
        want = patch_gather_plain(v, table, center, row0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"K1 {where} {role} {label}: kernel != plain (max abs {err})")
        # yardstick: one index_select on the table with a zero row appended
        ids = torch.where((table >= 0) & (table < cap), table, cap)
        if center:
            ids = torch.cat([ids, torch.arange(row0, row0 + q, device=dev, dtype=ids.dtype)[:, None]], 1)
        ids = ids.reshape(-1).long()
        vz = torch.cat([v, v.new_zeros(1, c)])
        check(torch.equal(vz.index_select(0, ids).reshape(got.shape), got),
              f"K1 {where} {role} {label}: library")  # fmt: skip
        # bytes this call needs: each value row that some id (or the centre
        # column) references, read once; the id table; the patch, written once
        rows_read = int(torch.unique(ids[ids < cap]).numel())
        nbytes = rows_read * c * v.element_size() + table.numel() * 4
        nbytes += got.numel() * got.element_size()
        row = dict(
            kernel="K1 patch_gather", where=where, role=role, shape=label,
            dtype=str(v.dtype).removeprefix("torch."), rows_read=rows_read,
            plan=_check(v, table, center, row0)._asdict(),
            **timings(torch, lambda: patch_gather(v, table, center, row0=row0),
                      lambda: patch_gather_plain(v, table, center, row0),
                      lambda: vz.index_select(0, ids)),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
        )  # fmt: skip
        emit(row)
        for key in TIMES:  # None (not measurable) in any call leaves the sum None
            tot[key] = None if None in (tot[key], row[key]) else tot[key] + row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    share = None if not tot["device_ms"] else tot["bound_ms"] / tot["device_ms"]
    emit(dict(check=f"K1 {where}: sums over {len(calls)} calls", bound_share_device=share,
              **{k: v for k, v in tot.items() if k != "calls"}))  # fmt: skip
    return tot


def k1_cases(torch, calls, dev):
    """K1's edge cases as ``(name, values, table, include_center, row0)``,
    built from a served scan's recorded calls: the same-level table
    (Q = cap, K = 8) and the head's (K = 4).  Widths 1, 7, 13 and 29 in
    f32 and bf16 with and without the centre column (the staged layout),
    the 16-byte layout at one chunk a row and at 64 (a query's patch row
    wider than a block's pass), ids = cap, > cap and negative, tables 4 and
    8 bytes past a 16-byte boundary (a C = 29 f32 table 116 bytes into its
    allocation), Q = 1, K = 1, K = 13, row counts that end in a partial
    staged tile with a narrow tail, and centre columns of a row block past
    the first at odd widths."""
    same = next(c[1] for c in calls if c[2] and not c[4])
    head = next(c[1] for c in calls if not c[2] and c[1].shape[1] == 4)
    cap = same.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)

    def vals(c, dtype, n=cap):
        return torch.randn(n, c, generator=gen, device=dev).to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for c in (1, 7, 13, 29):
            for center in (False, True):
                yield f"C={c} {str(dtype)[6:]}", vals(c, dtype), same, center, 0
    yield "16-byte rows, one chunk (bf16 C=8)", vals(8, bf16), same, True, 0
    yield "16-byte rows, 64 chunks (f32 C=256)", vals(256, f32), same, True, 0
    bad = same.clone()
    bad[::7, 1] = cap
    bad[::11, 2] = -1
    bad[::13, 0] = -cap - 3
    bad[::17, 3] = cap + 5
    for c, dtype in ((29, f32), (32, bf16), (7, bf16)):
        yield f"ids = cap, > cap, negative (C={c} {str(dtype)[6:]})", vals(c, dtype), bad, True, 0
    hcap = int(head.max()) + 1
    yield "C=29 f32 table 116 bytes into its allocation", vals(29, f32, hcap + 1)[1:], head, False, 0
    yield "C=32 f32 table 4 bytes past 16", vals(32 * hcap + 1, f32, 1).view(-1)[1:].view(hcap, 32), head, False, 0
    yield "C=32 f32 table 8 bytes past 16", vals(32 * hcap + 2, f32, 1).view(-1)[2:].view(hcap, 32), head, False, 0
    for c, dtype in ((29, f32), (64, bf16)):
        yield f"Q=1 (C={c} {str(dtype)[6:]})", vals(c, dtype), same[:1].contiguous(), True, 0
        yield f"K=1 (C={c} {str(dtype)[6:]})", vals(c, dtype), same[:, :1].contiguous(), False, 0
    yield "K=13 (bf16 C=64)", vals(64, bf16), torch.cat([same, same[:, :5]], 1).contiguous(), True, 0
    yield "K=3 Q=1001, a narrow tail (f32 C=29)", vals(29, f32), head[:1001, :3].contiguous(), False, 0
    yield "Q=999, a narrow tail (bf16 C=7)", vals(7, bf16), same[:999].contiguous(), True, 0
    for c, dtype in ((7, bf16), (29, f32), (64, bf16)):
        yield f"row0={cap // 2} (C={c} {str(dtype)[6:]})", vals(c, dtype), same[: cap // 3].contiguous(), True, cap // 2


def check_k1_cases(torch, calls, dev):
    """K1 on each of :func:`k1_cases`, run twice into blocks with every bit
    set: both outputs bit-equal to the plain version (a byte the kernel
    does not write stays NaN)."""
    from lattice_net_tpu_torch.ops_cuda.patch import _check, patch_gather, patch_gather_plain

    n = 0
    for name, v, table, center, row0 in k1_cases(torch, calls, dev):
        q, k = table.shape
        want = patch_gather_plain(v, table, center, row0)
        for run in range(2):
            ptr = nan_blocks(torch, [(-(-want.numel() * want.element_size() // 4),)], dev)[0]
            got = patch_gather(v, table, center, row0=row0)
            torch.cuda.synchronize()
            check(got.data_ptr() == ptr, f"K1 case {name}: output off the NaN block")
            check(torch.equal(got, want), f"K1 case {name}, run {run}: kernel != plain")
        emit(dict(check=f"K1 case: {name}", shape=f"cap={v.shape[0]} C={v.shape[1]} Q={q} K={k}"
                  f"{'+centre' if center else ''}{f' row0={row0}' if row0 else ''}",
                  dtype=str(v.dtype)[6:], table_offset_mod_16=v.data_ptr() % 16,
                  plan=_check(v, table, center, row0)._asdict(), bit_equal=True))  # fmt: skip
        n += 1
    return n


def k2_cases(torch, args):
    """The recorded K2 call ``(feats, carry, ids, run_end)`` and the cases
    built from it, as ``(name, args, winners)``: ties planted (the values
    rounded to quarters repeat within runs), :func:`extra_cases` (the carry
    rides along as a last column), ties across the 32-row chunk bounds of
    the long run (:func:`chunk_ties`, whose ``winners`` are not None) and
    ``NARROW_K2B`` random columns (the scalar kernel)."""
    feats, carry, ids, run_end = args
    yield "recorded", args, None
    yield "ties planted", (torch.round(feats * 4) / 4, carry, ids, run_end), None
    both = torch.cat([feats, carry[:, None]], 1)
    for name, v, i, r in extra_cases(torch, both, ids, run_end, seed=11):
        case = (v[:, :-1].contiguous(), v[:, -1].contiguous(), i, r)
        yield name, case, None
        if name.startswith("long run"):
            yield chunk_ties(torch, case)
    cols = random_columns(torch, NARROW_K2B, feats.shape[1], 12, feats.device)
    yield f"C={NARROW_K2B} random columns", (feats[:, cols].contiguous(), carry, ids, run_end), None


def chunk_ties(torch, args):
    """A case with a new maximum planted twice in each channel of the
    longest run, on both sides of the edge array's 32-row chunk bounds,
    where the kernel cuts the run into pieces: rows b - 1 and b (channels
    0, 3, ...), b' - 1 and b' (1, 4, ...), and b - 1 and b' + 7 (2, 5, ...),
    with b and b' multiples of 32 five chunks apart.  The later row of each
    pair must win.  Returns ``(name, args, (vertex, winning row of each
    channel))``."""
    feats, carry, ids, run_end = args
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    v0 = int((run_end - prev).argmax())
    start, end = int(prev[v0]) + 1, int(run_end[v0])
    b = (start // 32 + 2) * 32
    b2 = b + 5 * 32
    check(b2 + 7 <= end, f"chunk ties: the run of vertex {v0} ({start}-{end}) is too short")
    feats = feats.clone()
    pairs = [(b - 1, b), (b2 - 1, b2), (b - 1, b2 + 7)]
    rows = [pairs[ch % 3] for ch in range(feats.shape[1])]
    top = feats[start : end + 1].max() + 1
    for ch, pair in enumerate(rows):
        feats[list(pair), ch] = top
    name = f"ties across chunk bounds (vertex {v0}, rows {start}-{end}, b = {b}, b' = {b2})"
    return name, (feats, carry, ids, run_end), (v0, [last for _, last in rows])


def check_k2_case(torch, name, args, dev, where):
    """K2 run twice into NaN-filled blocks: both outputs bit-equal to the
    plain version and to themselves.  Returns the first run's outputs and
    their largest difference from the plain version's."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    feats = args[0]
    cap, c = args[3].shape[0], feats.shape[1]
    runs = []
    for _ in range(2):
        ptrs = nan_blocks(torch, [(cap, c), (cap, c)], dev)
        got = seg_max_carry(*args)
        check(sorted(t.data_ptr() for t in got) == sorted(ptrs),
              f"K2 {where} {name}: outputs off the NaN blocks")  # fmt: skip
        runs.append(got)
    want = seg_max_carry_plain(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(runs[0], want))
    check(all(torch.equal(a, b) for a, b in zip(runs[0], want)),
          f"K2 {where} {name}: kernel != plain (max abs {err})")  # fmt: skip
    check(all(torch.equal(a, b) for a, b in zip(*runs)), f"K2 {where} {name}: two runs differ")
    emit(dict(check=f"K2 {where} {name}", shape=f"M={feats.shape[0]} C={c}", max_abs_err=err))
    return runs[0], err


def check_k2(torch, args, where, dev):
    """K2 against its plain version on one recorded call and the cases built
    from it (:func:`k2_cases`), bit-equal, into NaN-filled blocks; timed on
    the recorded inputs with its byte bound.  Beside it, labelled as a
    reference and not as K2's library call: one ``torch.segment_reduce(...,
    "max", lengths=...)``, which gives the max without the carry."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry, seg_max_carry_plain

    err = 0.0
    for name, case, winners in k2_cases(torch, args):
        (_, out_carry), e = check_k2_case(torch, name, case, dev, where)
        err = max(err, e)
        if winners is not None:  # the later row of each tied pair won
            v0, rows = winners
            want = case[1][torch.tensor(rows, device=dev)]
            check(torch.equal(out_carry[v0], want), f"K2 {where} {name}: not the latest winner")
    feats, carry, ids, run_end = args
    # bytes: the rows of edges that lie in some vertex's run, their carry,
    # the run ends, and the two outputs
    (m, c), cap = feats.shape, run_end.shape[0]
    in_runs = int((ids < cap).sum())
    nbytes = (in_runs * (c + 1) + run_end.numel() + 2 * cap * c) * 4
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    lengths = (run_end - prev).long()
    head = feats[:in_runs]
    ref = lambda: torch.segment_reduce(head, "max", lengths=lengths)  # noqa: E731
    maxed = seg_max_carry_plain(feats, carry, ids, run_end)[0]
    present = lengths > 0
    check(torch.equal(ref()[present], maxed[present]), f"K2 {where}: segment_reduce max != plain")
    row = dict(
        kernel="K2 seg_max_carry", where=where, shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs,
        **timings(torch, lambda: seg_max_carry(feats, carry, ids, run_end),
                  lambda: seg_max_carry_plain(feats, carry, ids, run_end)),
        max_only_segment_reduce_ms=time_ms(torch, ref),
        max_only_segment_reduce_device_ms=device_ms(torch, ref),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def kernels_vs_plain(torch, pred, dev):
    """K1 and K2 against their plain versions, and timed, on exactly the
    inputs one served 2^17-point scan (seed 0) gives them."""
    pos, vals = scan(pred, 1 << 17, seed=0)
    with recording_kernel_inputs(torch) as (calls, _):
        pred.forward(pos, vals)
    k1 = check_k1(torch, calls["k1"], dev, "served scan")
    k1["edge_cases"] = check_k1_cases(torch, calls["k1"], dev)
    check(len(calls["k2"]) == 1, f"{len(calls['k2'])} max-pools in one forward, expected 1")
    return k1, check_k2(torch, calls["k2"][0], "served scan", dev)


def conv_modules(model):
    from lattice_net_tpu_torch.nn.modules import ConvIm2Row, _CrossLevelConv

    return sum(isinstance(m, (ConvIm2Row, _CrossLevelConv)) for m in model.modules())


def patch_gathers_per_scan(model):
    """K1 launches one forward must make: one per lattice conv module, plus
    the head's per-point gather."""
    return conv_modules(model) + 1


def patch_gathers_per_step(model):
    """K1 launches one train step must make: the forward's, and two more per
    conv module in the backward (the recomputed patch of the weight
    gradient, the flipped conv of the value gradient)."""
    return patch_gathers_per_scan(model) + 2 * conv_modules(model)


def launches_per_step(model, segvjp):
    """Every kernel's launches in one train step.  Each head makes one row
    gather and one adjoint: K1 and K1-bwd by default; with the edge-sort
    adjoint K4 forward and K3 backward instead.  The PointNet max-pool is
    one K2 and one K2-bwd."""
    from lattice_net_tpu_torch.nn.modules import SliceFastModule

    heads = sum(isinstance(m, SliceFastModule) for m in model.modules())
    if not segvjp:
        return dict(k1=patch_gathers_per_step(model), k1b=heads, k2=1, k2b=1, k3=0, k4=0)
    return dict(k1=patch_gathers_per_step(model) - heads, k1b=0, k2=1, k2b=1, k3=heads, k4=heads)


def counters():
    from lattice_net_tpu_torch.ops_cuda.gather import take_rows
    from lattice_net_tpu_torch.ops_cuda.patch import patch_gather, patch_scatter
    from lattice_net_tpu_torch.ops_cuda.segment import (
        seg_max_carry,
        seg_max_carry_bwd,
        seg_sum_sorted_fast,
    )

    return dict(
        k1=patch_gather, k1b=patch_scatter, k2=seg_max_carry, k2b=seg_max_carry_bwd,
        k3=seg_sum_sorted_fast, k4=take_rows,
    )  # fmt: skip


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def serve(torch, pred, k1_per_scan):
    requests = [(1 << 17, s) for s in range(5)] + [(100000, 5)]
    totals = dict(k1=0, k2=0)
    latencies = []
    for i, (n, seed) in enumerate(requests):
        pos, vals = scan(pred, n, seed)
        zero_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logp, h = pred.forward(pos, vals)
        labels = torch.argmax(logp, dim=-1)[:n]
        stop.record()
        labels = labels.cpu()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        k1, k2 = counts["k1"], counts["k2"]
        check(
            counts["k1b"] == counts["k2b"] == counts["k3"] == counts["k4"] == 0,
            f"request {i} launched kernels off the serving path: {counts}",
        )
        totals["k1"] += k1
        totals["k2"] += k2
        ms = start.elapsed_time(stop)
        latencies.append(ms)
        occ = [int(s.nr_verts) for s in h.structures]
        ovf = [int(s.nr_overflow) for s in h.structures]
        emit(dict(
            request=i, points=n, seed=seed, latency_ms=ms, host_ms=host_ms,
            occupancy=occ, capacities=list(pred.capacities), overflow=ovf,
            k1_launches=k1, k2_launches=k2,
        ))  # fmt: skip
        check(
            k1 == k1_per_scan and k2 == 1,
            f"request {i}: launches K1={k1} K2={k2}, expected {k1_per_scan} and 1",
        )
        check(tuple(logp.shape) == (pred.n_points, NR_CLASSES), f"logp shape {tuple(logp.shape)}")
        check(bool(torch.isfinite(logp).all()), f"request {i}: non-finite log-probabilities")
        check(int(labels.min()) >= 0 and int(labels.max()) < NR_CLASSES, "labels out of range")
    steady = sorted(latencies[1:])
    emit(dict(
        serving="SemanticKITTI eval config, 2^17-point budget", requests=len(requests),
        first_ms=latencies[0], steady_median_ms=steady[len(steady) // 2],
        steady_min_ms=steady[0], steady_max_ms=steady[-1],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ))  # fmt: skip
    return totals


def kernels_vs_plain_end_to_end(torch, pred):
    pos, vals = scan(pred, 1 << 17, seed=0)
    logp_k, _ = pred.forward(pos, vals)
    zero_counts()
    with norm_on_its_kernel():
        logp_p, _ = pred.forward(pos, vals, plain=True)
    check(not any(read_counts().values()), "plain run launched kernels")
    n = len(pos)
    agree = (logp_k[:n].argmax(-1) == logp_p[:n].argmax(-1)).float().mean().item()
    diff = (logp_k[:n] - logp_p[:n]).abs().max().item()
    emit(dict(check="kernels vs plain, whole path, bf16 convs", label_agreement=agree,
              logp_max_abs=diff, tolerance=SERVE_TOL))  # fmt: skip
    check(agree >= SERVE_TOL["label_agreement"], f"label agreement {agree}")
    check(diff <= SERVE_TOL["logp_max_abs"], f"logp max abs {diff}")


def card_vs_cpu(torch, dev):
    from lattice_net_tpu_torch.serve import Predictor

    small = dict(nr_classes=NR_CLASSES, conv_dtype=torch.float32, seed=1, n_points=1 << 13)
    gpu = Predictor.from_config(CONFIG, device=dev, **small)
    cpu = Predictor.from_config(CONFIG, device="cpu", **small)
    pos, vals = scan(cpu, 6000, seed=11)
    logp_g, _ = gpu.forward(pos, vals)
    logp_c, _ = cpu.forward(pos, vals)
    n = len(pos)
    logp_g = logp_g[:n].cpu()
    agree = (logp_g.argmax(-1) == logp_c[:n].argmax(-1)).float().mean().item()
    diff = (logp_g - logp_c[:n]).abs().max().item()
    emit(dict(check="card vs CPU plain path, f32, 6000 points", label_agreement=agree,
              logp_max_abs=diff, tolerance=CPU_TOL))  # fmt: skip
    check(agree >= CPU_TOL["label_agreement"], f"card vs CPU label agreement {agree}")
    check(diff <= CPU_TOL["logp_max_abs"], f"card vs CPU logp max abs {diff}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_batch(torch, dev, n_points, budget, seed):
    """One synthetic scan with its labels, padded to ``budget`` points as the
    trainer's batcher does (the train config's values mode is "none")."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import ModelParams, prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import make_batch

    cloud = prepare_cloud(make_scene(n_points, seed=seed), ModelParams(values_mode="none"))
    return make_batch([cloud], budget, device=dev)


def close(torch, got, want):
    """Max abs error, and whether it is within ``BWD_TOL``."""
    err = (got - want).abs()
    bound = BWD_TOL["rtol"] * want.abs() + BWD_TOL["atol_of_max"] * want.abs().max()
    return err.max().item(), bool((err <= bound).all())


def runs_from_ids(torch, ids, cap):
    """``EdgeSort.run_end`` from sorted vertex ids: for each vertex v the last
    position with an id <= v (-1 before the first edge)."""
    v = torch.arange(cap, device=ids.device, dtype=ids.dtype)
    return (torch.searchsorted(ids, v, right=True) - 1).to(torch.int32)


def run_length_stats(torch, run_end, where):
    """Prints the run lengths of one call's ``run_end``: edges in runs,
    non-empty runs, mean, p99 and max, and per log2 bin [2^k, 2^(k+1)) the
    runs and the edges they hold."""
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    n = (run_end - prev).long()
    nz = n[n > 0]
    check(nz.numel() > 0, f"{where}: no edge in any run")
    bins = torch.floor(torch.log2(nz.double())).long()
    runs = torch.bincount(bins).tolist()
    edges = torch.zeros(len(runs), dtype=torch.long, device=n.device).index_add_(0, bins, nz).tolist()
    row = dict(
        run_lengths=where, cap=run_end.shape[0], edges_in_runs=int(nz.sum()),
        nonempty_runs=int(nz.numel()), mean=float(nz.double().mean()),
        p99=float(torch.quantile(nz.double(), 0.99)), max=int(nz.max()),
        log2_bins_runs_edges={f"{1 << k}-{(2 << k) - 1}": [r, e]
                              for k, (r, e) in enumerate(zip(runs, edges)) if r},
    )  # fmt: skip
    emit(row)
    return row


def extra_cases(torch, vals, ids, run_end, seed):
    """Two cases built from one recorded call ``(vals, ids, run_end)``, as
    ``(name, vals, ids, run_end)``: ``PAD_EDGES`` edges with id = cap
    appended after the last run, and ``LONG_RUN`` edges added to the run of
    the vertex at the middle edge.  New rows are normal at the recorded
    values' spread."""
    m, c = vals.shape
    cap = run_end.shape[0]
    check(torch.equal(runs_from_ids(torch, ids, cap), run_end), "recorded run_end != runs of the ids")
    gen = torch.Generator(device=vals.device).manual_seed(seed)

    def rows(n):
        return torch.randn(n, c, generator=gen, device=vals.device) * vals.std()

    yield ("padded tail", torch.cat([vals, rows(PAD_EDGES)]),
           torch.cat([ids, ids.new_full((PAD_EDGES,), cap)]), run_end)  # fmt: skip
    v0 = int(ids[int((ids < cap).sum()) // 2])
    p = int(run_end[v0]) + 1
    ids_l = torch.cat([ids[:p], ids.new_full((LONG_RUN,), v0), ids[p:]])
    vals_l = torch.cat([vals[:p], rows(LONG_RUN), vals[p:]])
    yield f"long run (vertex {v0})", vals_l, ids_l, runs_from_ids(torch, ids_l, cap)


def random_columns(torch, n, c, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(c, generator=gen)[:n].sort().values.to(device)


def nan_blocks(torch, shapes, dev):
    """Leaves the caching allocator a free block of each shape of 4-byte
    elements with every bit set (NaN in f32 and in bf16), so that outputs
    of those sizes allocated next land on them: an element a kernel fails
    to write stays NaN.  Returns their pointers, for the caller to
    confirm."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(s, -1, dtype=torch.int32, device=dev) for s in shapes]
    ptrs = [b.data_ptr() for b in blocks]
    del blocks
    return ptrs


def check_k2b_case(torch, name, args, dev):
    """K2-bwd run twice into NaN-filled blocks: d_vals bit-equal to the
    plain version and to itself, d_carry within ``BWD_TOL`` and bit-equal
    to itself.  Returns the largest difference from the plain version."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_bwd, seg_max_carry_bwd_plain

    m, c = args[0].shape
    runs = []
    for _ in range(2):
        ptrs = nan_blocks(torch, [(m, c), (m,)], dev)
        got = seg_max_carry_bwd(*args)
        check([t.data_ptr() for t in got] == ptrs, f"K2-bwd {name}: outputs off the NaN blocks")
        runs.append(got)
    want = seg_max_carry_bwd_plain(*args)
    torch.cuda.synchronize()
    (d_vals, d_carry), (d_vals2, d_carry2) = runs
    check(torch.equal(d_vals, want[0]), f"K2-bwd {name}: d_vals kernel != plain")
    err, ok = close(torch, d_carry, want[1])
    check(ok, f"K2-bwd {name}: d_carry kernel != plain beyond {BWD_TOL} (max abs {err})")
    same = torch.equal(d_vals, d_vals2) and torch.equal(d_carry, d_carry2)
    check(same, f"K2-bwd {name}: two runs differ")
    emit(dict(check=f"K2-bwd {name}", shape=f"M={m} C={c}", d_carry_max_abs_err=err))
    return err


def k2b_cases(torch, args):
    """The recorded K2-bwd call and the cases built from it, as ``(name,
    args)``: ties planted, :func:`extra_cases` (maxima taken anew) and
    ``NARROW_K2B`` random columns."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_plain

    vals, ids, run_end, maxed, g_max, g_carry = args

    def maxima(v, i, r):
        return seg_max_carry_plain(v, torch.zeros_like(v[:, 0]), i, r)[0]

    yield "recorded", args
    # ties: the same values rounded to quarters repeat within runs, and the
    # maxima are taken anew from them
    vals_q = torch.round(vals * 4) / 4
    yield "ties planted", (vals_q, ids, run_end, maxima(vals_q, ids, run_end), g_max, g_carry)
    for name, v, i, r in extra_cases(torch, vals, ids, run_end, seed=7):
        yield name, (v, i, r, maxima(v, i, r), g_max, g_carry)
    cols = random_columns(torch, NARROW_K2B, vals.shape[1], 8, vals.device)
    yield (f"C={NARROW_K2B} random columns",
           tuple(t[:, cols].contiguous() if t.dim() == 2 else t for t in args))  # fmt: skip


def tied_pairs(torch, vals, ids, run_end, maxed):
    """(vertex, channel) pairs whose run holds more than one winner."""
    cap = run_end.shape[0]
    idc = ids.long().clamp(max=cap - 1)
    hits = ((vals == maxed[idc]) & (ids < cap)[:, None]).float()
    per = torch.zeros(cap + 1, vals.shape[1], device=vals.device)
    return int((per.index_add_(0, ids.long().clamp(max=cap), hits)[:cap] > 1).sum())


def dest_repeat_share(torch, table, cap, window=32):
    """The share of the valid rows of an id table whose destination already
    appears in the same slot among the ``window`` consecutive queries (a
    warp's worth of points): the atomics that aggregating same-destination
    rows inside a warp would save."""
    q, k = table.shape
    valid = (table >= 0) & (table < cap)
    w = torch.arange(q, device=table.device)[:, None] // window
    key = ((w * k + torch.arange(k, device=table.device)) * (cap + 1) + table.long())[valid]
    n = int(valid.sum())
    return (n - int(torch.unique(key).numel())) / max(n, 1)


def k1b_cases(torch, args, k1_calls):
    """The recorded K1-bwd call ``(g, table, cap, include_center)`` and three
    cases built from it, as ``(name, args)``: the centre column on a
    same-level table of the step (the first recorded K1 call with one, with
    a cotangent at the recorded values' spread), ids equal to cap and
    negative ids (which drop), and ``NARROW_K1B`` random columns (scalar
    atomics)."""
    g, table, cap, center = args
    yield "recorded", args
    values, same = next(c for c in k1_calls if c[2] and not c[4])[:2]
    q, k = same.shape
    gen = torch.Generator(device=g.device).manual_seed(13)
    g_c = torch.randn(q, k + 1, g.shape[2], generator=gen, device=g.device) * g.std()
    yield f"centre column, same-level table (Q={q} K={k})", (g_c, same, values.shape[0], True)
    bad = table.clone()
    bad[::7, 1] = cap
    bad[::11, 2] = -1
    bad[::13, 0] = -cap - 3
    yield "ids = cap and negative ids", (g, bad, cap, center)
    cols = random_columns(torch, NARROW_K1B, g.shape[2], 14, g.device)
    yield f"C={NARROW_K1B} random columns", (g[:, :, cols].contiguous(), table, cap, center)


def check_k1b(torch, args, k1_calls, dev, where="train step"):
    """K1-bwd against its plain version on the recorded call and the cases of
    :func:`k1b_cases`, within ``BWD_TOL``, run twice into NaN-filled blocks
    (the kernel zeroes its output itself); the gap between the two runs (the
    atomics' order) is printed.  Timed on the recorded call with its byte
    bound; library: one ``index_add_`` into a table with a row for the
    dropped ids.  Also printed: the destination-repeat share of the
    recorded table (:func:`dest_repeat_share`), and the card's time for the
    same cotangent into ids drawn uniformly from the vertices the call
    reaches (no hot vertex), which shows what the destinations' skew
    costs."""
    from lattice_net_tpu_torch.ops_cuda.patch import patch_scatter, patch_scatter_plain

    err, gap = 0.0, 0.0
    for name, (g_, t_, cap_, center_) in k1b_cases(torch, args, k1_calls):
        outs = []
        for _ in range(2):
            ptrs = nan_blocks(torch, [(cap_, g_.shape[2])], dev)
            outs.append(patch_scatter(g_, t_, cap_, center_))
            check(outs[-1].data_ptr() == ptrs[0], f"K1-bwd {name}: output off the NaN block")
        want = patch_scatter_plain(g_, t_, cap_, center_)
        torch.cuda.synchronize()
        e, ok = close(torch, outs[0], want)
        check(ok, f"K1-bwd {name}: kernel != plain beyond {BWD_TOL} (max abs {e})")
        check(close(torch, outs[1], want)[1], f"K1-bwd {name}: second run != plain beyond {BWD_TOL}")
        run_gap = (outs[0] - outs[1]).abs().max().item()
        emit(dict(check=f"K1-bwd {where} {name}", shape=f"Q={t_.shape[0]} K={t_.shape[1]}"
                  f"{'+centre' if center_ else ''} C={g_.shape[2]} cap={cap_}", max_abs_err=e,
                  two_runs_max_abs_gap=run_gap))  # fmt: skip
        err, gap = max(err, e), max(gap, run_gap)
    g, table, cap, center = args
    (q, kk, c), k = g.shape, table.shape[1]
    check(not center, "K1-bwd runs for the head gather, which has no centre column")
    # yardstick: one index_add_ into a table with a row for the dropped ids
    ids = torch.where((table >= 0) & (table < cap), table, cap).reshape(-1).long()
    g_rows = g[:, :k].reshape(-1, c)
    lib = lambda: torch.zeros(cap + 1, c, device=g.device).index_add_(0, ids, g_rows)  # noqa: E731
    check(close(torch, lib()[:cap], patch_scatter_plain(g, table, cap, center))[1],
          "K1-bwd: library call != plain")  # fmt: skip
    # the destinations' skew: the same cotangent into ids drawn uniformly
    # from the vertices the call reaches
    used = torch.unique(table[(table >= 0) & (table < cap)])
    gen = torch.Generator(device=g.device).manual_seed(15)
    uniform = used[torch.randint(0, used.numel(), table.shape, generator=gen, device=g.device)]
    uniform = uniform.to(table.dtype)
    nbytes = (g.numel() + table.numel() + cap * c) * 4
    row = dict(
        kernel="K1-bwd patch_scatter", where=where, shape=f"Q={q} K={k} C={c} cap={cap}",
        **timings(torch, lambda: patch_scatter(g, table, cap, center),
                  lambda: patch_scatter_plain(g, table, cap, center), lib),
        device_ms_uniform_ids=device_ms(torch, lambda: patch_scatter(g, uniform, cap, center)),
        dest_repeat_share_32=dest_repeat_share(torch, table, cap),
        two_runs_max_abs_gap=gap, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def sum_rows(rows):
    """One kernel's timed rows summed: each time (None if any call's is),
    the bound, the largest error; a single row is returned as it is."""
    if len(rows) == 1:
        return rows[0]
    tot = dict(calls=len(rows), max_abs_err=max(r["max_abs_err"] for r in rows))
    for key in TIMES:
        tot[key] = None if any(r[key] is None for r in rows) else sum(r[key] for r in rows)
    return tot


def check_k2b(torch, args, dev, where):
    """K2-bwd on one recorded call ``(vals, ids, run_end, maxed, g_max,
    g_carry)`` and the cases built from it (:func:`k2b_cases`), timed on the
    recorded inputs with its byte bound; returns its row."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_max_carry_bwd, seg_max_carry_bwd_plain

    vals, ids, run_end, maxed, g_max, g_carry = args
    cap = run_end.shape[0]
    run_length_stats(torch, run_end, f"{where}, max-pool (K2, K2-bwd)")
    err, ties = 0.0, 0
    for name, case in k2b_cases(torch, args):
        err = max(err, check_k2b_case(torch, name, case, dev))
        if name == "ties planted":
            ties = tied_pairs(torch, *case[:4])
    check(ties > 0, "the tie-planted K2-bwd case has no tie")
    (m, c) = vals.shape
    in_runs = int((ids < cap).sum())
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    present = int((run_end > prev).sum())
    nbytes = (in_runs * c + cap + 3 * present * c + m * c + m) * 4
    row = dict(
        kernel="K2-bwd seg_max_carry_bwd", where=where, shape=f"M={m} C={c} cap={cap}",
        edges_in_runs=in_runs, vertices_with_runs=present, tied_pairs_planted=ties,
        **timings(torch, lambda: seg_max_carry_bwd(vals, ids, run_end, maxed, g_max, g_carry),
                  lambda: seg_max_carry_bwd_plain(vals, ids, run_end, maxed, g_max, g_carry)),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def train_step_kernels_vs_plain(torch, run, state, batch, dev, where="train step"):
    """Every kernel against its plain version, and timed, on exactly the
    inputs one train step's forward and backward (the step's own stages)
    give it: K1's forward and backward calls, the forward's K2, K1-bwd and
    K2-bwd, for each cloud of the batch.  Returns each kernel's sums over
    the step (its one row for a batch of one cloud)."""
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    clouds = batch["positions"].shape[0]
    with recording_kernel_inputs(torch) as (calls, phase):
        leaves, loss, _ = forward_loss(run.loss_fn(), state.params, batch)
        phase[0] = "backward"
        gradients(loss, leaves)
    roles = [c[3] for c in calls["k1"]]
    n_conv = conv_modules(run.model)
    per_scan, per_step = patch_gathers_per_scan(run.model), patch_gathers_per_step(run.model)
    check(
        roles.count("forward") == clouds * per_scan and len(roles) == clouds * per_step,
        f"K1 calls in one step of {clouds} clouds: {len(roles)}, {roles.count('forward')} in the forward; "
        f"expected {clouds} x {per_step} and {clouds} x {per_scan} ({n_conv} convs and a head)",
    )
    k1 = check_k1(torch, calls["k1"], dev, where)
    for key in ("k2", "k1b", "k2b"):
        check(len(calls[key]) == clouds, f"{len(calls[key])} {key} calls in one step, expected {clouds}")

    def each(key, fn):
        return [fn(c, where if clouds == 1 else f"{where}, cloud {i}") for i, c in enumerate(calls[key])]

    k2 = sum_rows(each("k2", lambda c, w: check_k2(torch, c, w, dev)))
    k1b = sum_rows(each("k1b", lambda c, w: check_k1b(torch, c, calls["k1"], dev, w)))
    k2b = sum_rows(each("k2b", lambda c, w: check_k2b(torch, c, dev, w)))
    if clouds > 1:
        emit(dict(check=f"{where}: sums over the step's {clouds} clouds", k2=k2, k1b=k1b, k2b=k2b))
    return k1, k2, k1b, k2b


def all_finite(torch, tensors):
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def train(torch, run, state, batch, what="SemanticKITTI train config, one 2^17-point scan",
          steps=TRAIN_STEPS):  # fmt: skip
    """The main training path: ``steps`` steps of ``make_train_step``, each
    launching the model's kernels once per cloud of the batch."""
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy

    model = run.model
    clouds = batch["positions"].shape[0]
    expected = {k: n * clouds for k, n in launches_per_step(model, segvjp=False).items()}
    b = {k: v[0] for k, v in batch.items()}
    h = build_hierarchy(
        b["positions"], run.sigma, model.params.nr_downsamples, run.capacities,
        point_mask=b["point_mask"], point_feats=b["values"],
    )  # fmt: skip
    emit(dict(
        training=what, capacities=list(run.capacities),
        occupancy=[int(s.nr_verts) for s in h.structures],
        overflow=[int(s.nr_overflow) for s in h.structures], expected_launches=expected,
    ))  # fmt: skip
    step = run.train_step()
    totals = dict.fromkeys(expected, 0)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()  # peak_mem_gb: these steps' own
    for i in range(steps):
        zero_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        stop.synchronize()
        counts = read_counts()
        for k in totals:
            totals[k] += counts[k]
        times.append(start.elapsed_time(stop))
        losses.append(float(metrics["loss"]))
        emit(dict(
            step=i, step_ms=times[-1], loss=losses[-1], acc=float(metrics["acc"]),
            occupancy_level0=float(metrics["nr_verts_mean"]),
            overflow=float(metrics["nr_overflow_mean"]), launches=counts,
        ))  # fmt: skip
        check(counts == expected, f"step {i}: launches {counts}, expected {expected}")
        check(math.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}")
        check(all_finite(torch, state.params.values()), f"step {i}: non-finite parameters")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    steady = sorted(times[1:])
    emit(dict(
        training=what, training_steps=steps, first_step_ms=times[0], steady_median_ms=steady[len(steady) // 2],
        steady_min_ms=steady[0], steady_max_ms=steady[-1], loss_first3=first, loss_last3=last,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    ))  # fmt: skip
    check(last < first, f"loss did not fall: first 3 steps {first}, last 3 {last}")
    return totals, expected


def loss_and_grads(torch, loss_fn, params, batch, plain=False):
    """The loss and gradients of one step, by the train step's own stages."""
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    leaves, loss, _ = forward_loss(loss_fn, params, batch, plain=plain)
    return loss.item(), gradients(loss, leaves)


def worst_rel_l2(torch, got, want):
    """The parameter whose gradient is furthest from ``want``'s, by relative
    L2 error, and that error."""
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        w = w.double().cpu()
        rel = ((got[k].double().cpu() - w).norm() / w.norm().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, k
    return worst, worst_name


def compare_grads(torch, got, want, tol, what):
    worst, worst_name = worst_rel_l2(torch, got, want)
    check(all_finite(torch, list(got.values())), f"{what}: non-finite gradients")
    check(worst <= tol, f"{what}: gradient of {worst_name} off by {worst} (rel L2 > {tol})")
    return worst, worst_name


def faulty_grads(torch, loss_fn, params, batch, conv):
    """Gradients with the kernels, but with the flipped conv of the value
    gradient of one conv module (``conv``-th in backward order) reading the
    next row of the cotangent for every 100th query: a K1 call that is
    wrong on 1% of its rows."""
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    k1 = ops.patch_gather
    n_bwd = [0]

    def faulty_k1(values, neighbors, include_center, plain=False, row0=0):
        if n_bwd[0] == 2 * conv + 1:
            cap = values.shape[0]
            neighbors = neighbors.clone()
            rows = neighbors[::100]
            neighbors[::100] = torch.where((rows >= 0) & (rows < cap), (rows + 1) % cap, rows)
        n_bwd[0] += 1
        return k1(values, neighbors, include_center, plain=plain, row0=row0)

    leaves, loss, _ = forward_loss(loss_fn, params, batch)
    ops.patch_gather = faulty_k1  # every K1 call from here on is the backward's
    try:
        grads = gradients(loss, leaves)
    finally:
        ops.patch_gather = k1
    check(n_bwd[0] > 2 * conv + 1, f"the backward made only {n_bwd[0]} patch gathers")
    return grads


def train_kernels_vs_plain(torch, run, state, batch):
    """One step's loss and gradients with the kernels against the plain
    versions, bf16 convs both.  Two readings frame the tolerance: a second
    run with the kernels (K1-bwd's atomics and K2-bwd's shuffle sums add in
    another order each time, nothing else differs), and each conv's flipped
    gather made wrong on 1% of its rows, which the tolerance must fail."""
    loss_fn = run.loss_fn()
    loss_k, grads_k = loss_and_grads(torch, loss_fn, state.params, batch)
    _, grads_k2 = loss_and_grads(torch, loss_fn, state.params, batch)
    zero_counts()
    loss_p, grads_p = loss_and_grads(torch, loss_fn, state.params, batch, plain=True)
    check(not any(read_counts().values()), "the plain step launched kernels")
    repeat, repeat_name = worst_rel_l2(torch, grads_k2, grads_k)
    faults = [worst_rel_l2(torch, faulty_grads(torch, loss_fn, state.params, batch, j), grads_p)
              for j in range(conv_modules(run.model))]  # fmt: skip
    weakest = min(range(len(faults)), key=lambda j: faults[j][0])
    worst, name = worst_rel_l2(torch, grads_k, grads_p)
    emit(dict(check="train step, kernels vs plain, bf16 convs", loss=loss_k,
              loss_abs_diff=abs(loss_k - loss_p), worst_grad_rel_l2=worst, worst_param=name,
              kernels_vs_kernels_rel_l2=repeat, kernels_vs_kernels_param=repeat_name,
              planted_fault_rel_l2=[f[0] for f in faults], planted_fault_weakest=weakest,
              planted_fault_weakest_param=faults[weakest][1],
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_PLAIN_GRAD_REL)))  # fmt: skip
    compare_grads(torch, grads_k, grads_p, TRAIN_PLAIN_GRAD_REL, "kernels vs plain")
    check(abs(loss_k - loss_p) <= LOSS_ATOL, f"kernels vs plain loss {loss_k} vs {loss_p}")
    check(
        faults[weakest][0] > TRAIN_PLAIN_GRAD_REL,
        f"a flipped gather wrong on 1% of its rows (conv {weakest} in backward order) moved the "
        f"gradients by only {faults[weakest][0]}: the tolerance {TRAIN_PLAIN_GRAD_REL} would pass it",
    )


def train_card_vs_cpu(torch, dev, what="train step"):
    from lattice_net_tpu_torch.train.setup import TrainSetup

    small = dict(conv_dtype=torch.float32, seed=1)
    gpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, **small)
    cpu = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device="cpu", **small)
    batch_g, batch_c = (train_batch(torch, d, 6000, 1 << 13, seed=11) for d in (dev, "cpu"))
    loss_g, grads_g = loss_and_grads(torch, gpu.loss_fn(), gpu.model.state_dict(), batch_g)
    loss_c, grads_c = loss_and_grads(torch, cpu.loss_fn(), cpu.model.state_dict(), batch_c)
    worst, name = compare_grads(torch, grads_g, grads_c, TRAIN_CPU_GRAD_REL, f"{what}, card vs CPU")
    emit(dict(check=f"{what}, card vs CPU plain path, f32, 6000 points", loss=loss_g,
              loss_abs_diff=abs(loss_g - loss_c), worst_grad_rel_l2=worst, worst_param=name,
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_CPU_GRAD_REL)))  # fmt: skip
    check(abs(loss_g - loss_c) <= LOSS_ATOL, f"card vs CPU loss {loss_g} vs {loss_c}")


# ---------------------------------------------------------------------------
# the edge-sort head adjoint (K3, K4) and dropout
# ---------------------------------------------------------------------------


def check_k4(torch, args, where):
    """K4 against its plain version on one recorded call ``(values, idx)``,
    bit-equal, and timed there with its byte bound.  Library: one
    ``index_select`` on the clamped ids (the clamp made beforehand)."""
    from lattice_net_tpu_torch.ops_cuda.gather import take_rows, take_rows_plain

    values, idx = args
    (cap, c), m = values.shape, idx.shape[0]
    got = take_rows(values, idx)
    want = take_rows_plain(values, idx)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"K4 {where}: kernel != plain (max abs {err})")
    idc = idx.long().clamp(0, cap - 1)
    check(torch.equal(values.index_select(0, idc), got), f"K4 {where}: library")
    # bytes: each row some id references, read once; the ids; the output
    rows_read = int(torch.unique(idc).numel())
    nbytes = rows_read * c * values.element_size() + m * 4 + got.numel() * got.element_size()
    row = dict(
        kernel="K4 take_rows", where=where, shape=f"cap={cap} C={c} m={m}",
        dtype=str(values.dtype).removeprefix("torch."), rows_read=rows_read,
        **timings(torch, lambda: take_rows(values, idx), lambda: take_rows_plain(values, idx),
                  lambda: values.index_select(0, idc)),
        library="index_select of the clamped ids", bytes=nbytes,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def check_k3(torch, args, where):
    """K3 against its plain version (an ``index_add_``, atomics on the card)
    on one recorded call ``(vals, ids, run_end, cap)`` and the cases built
    from it (:func:`extra_cases`, ``NARROW_K3`` random columns), within
    ``BWD_TOL``; twice each, into NaN-filled blocks, bit-equal to itself;
    timed on the recorded call with its byte bound.  Library: one
    ``torch.segment_reduce(..., "sum", lengths=...)`` over the edges in runs
    with each vertex's run length (both made beforehand)."""
    from lattice_net_tpu_torch.ops_cuda.segment import seg_sum_sorted_fast, seg_sum_sorted_plain

    vals, ids, run_end, cap = args
    m, c = vals.shape
    dev = vals.device
    run_length_stats(torch, run_end, f"{where}, K3")

    def case(name, v, i, r):
        outs = []
        for _ in range(2):
            ptrs = nan_blocks(torch, [(cap, v.shape[1])], dev)
            outs.append(seg_sum_sorted_fast(v, i, r, cap))
            check(outs[-1].data_ptr() == ptrs[0], f"K3 {where} {name}: output off the NaN block")
        want = seg_sum_sorted_plain(v, i, cap)
        torch.cuda.synchronize()
        e, ok = close(torch, outs[0], want)
        check(ok, f"K3 {where} {name}: kernel != plain beyond {BWD_TOL} (max abs {e})")
        check(torch.equal(outs[0], outs[1]), f"K3 {where} {name}: two runs differ")
        emit(dict(check=f"K3 {where} {name}", shape=f"M={v.shape[0]} C={v.shape[1]}", max_abs_err=e))
        return e, want

    err, want = case("recorded", vals, ids, run_end)
    cols = random_columns(torch, NARROW_K3, c, 9, dev)
    narrow = (f"C={NARROW_K3} random columns", vals[:, cols].contiguous(), ids, run_end)
    for name, v, i, r in [*extra_cases(torch, vals, ids, run_end, seed=10), narrow]:
        err = max(err, case(name, v, i, r)[0])
    prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
    lengths = (run_end - prev).long()
    in_runs = int(lengths.sum())
    head = vals[:in_runs].float()
    lib = lambda: torch.segment_reduce(head, "sum", lengths=lengths)  # noqa: E731
    check(close(torch, lib(), want)[1], f"K3 {where}: library call != plain")
    nbytes = (in_runs * c + cap + cap * c) * 4
    row = dict(
        kernel="K3 seg_sum", where=where, shape=f"M={m} C={c} cap={cap}", edges_in_runs=in_runs,
        vertices_with_runs=int((lengths > 0).sum()),
        **timings(torch, lambda: seg_sum_sorted_fast(vals, ids, run_end, cap),
                  lambda: seg_sum_sorted_plain(vals, ids, cap), lib),
        library="segment_reduce sum over the edges in runs",
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
    )  # fmt: skip
    emit(row)
    return row


def segvjp_kernels_vs_plain(torch, run, state, batch):
    """K3 and K4 on exactly the inputs one segvjp train step gives them."""
    from lattice_net_tpu_torch.parallel.data_parallel import forward_loss, gradients

    where = "segvjp step"
    with segvjp(), recording_kernel_inputs(torch) as (calls, _):
        leaves, loss, _ = forward_loss(run.loss_fn(), state.params, batch)
        gradients(loss, leaves)
    n = {k: len(v) for k, v in calls.items()}
    check(n["k3"] == n["k4"] == 1 and n["k1b"] == 0, f"{where}: kernel calls {n}")
    return check_k4(torch, calls["k4"][0], where), check_k3(torch, calls["k3"][0], where)


def train_segvjp(torch, run, state, batch):
    """``TRAIN_STEPS`` segvjp steps from ``state``, each right after a step of
    the default head from its own copy of ``state``: both step medians from
    interleaved runs.  Returns the segvjp run's launch totals."""
    model = run.model
    heads = dict(default=(default_head, launches_per_step(model, segvjp=False)),
                 segvjp=(segvjp, launches_per_step(model, segvjp=True)))  # fmt: skip
    step = run.train_step()
    states = dict.fromkeys(heads, state)
    times = {k: [] for k in heads}
    losses = {k: [] for k in heads}
    totals = dict.fromkeys(heads["segvjp"][1], 0)
    for i in range(TRAIN_STEPS):
        for name, (env, expected) in heads.items():
            with env():
                zero_counts()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                states[name], metrics = step(states[name], batch)
                stop.record()
                stop.synchronize()
                counts = read_counts()
            times[name].append(start.elapsed_time(stop))
            losses[name].append(float(metrics["loss"]))
            emit(dict(head=name, step=i, step_ms=times[name][-1], loss=losses[name][-1],
                      launches=counts))  # fmt: skip
            check(counts == expected, f"{name} step {i}: launches {counts}, expected {expected}")
            check(math.isfinite(losses[name][-1]), f"{name} step {i}: loss {losses[name][-1]}")
            if name == "segvjp":
                for k in totals:
                    totals[k] += counts[k]
    check(all_finite(torch, states["segvjp"].params.values()), "segvjp: non-finite parameters")
    summary = {}
    for name in heads:
        steady = sorted(times[name][1:])
        first, last = sum(losses[name][:3]) / 3, sum(losses[name][-3:]) / 3
        summary[name] = dict(steady_median_ms=steady[len(steady) // 2], steady_min_ms=steady[0],
                             steady_max_ms=steady[-1], loss_first3=first, loss_last3=last)  # fmt: skip
        check(last < first, f"{name}: loss did not fall: first 3 steps {first}, last 3 {last}")
    emit(dict(training="segvjp vs default head, interleaved", steps=TRAIN_STEPS,
              expected_launches={k: v[1] for k, v in heads.items()}, **summary))  # fmt: skip
    return totals


def faulty_k3_grads(torch, loss_fn, params, batch, pick):
    """Gradients with the kernels, but with K3 summing the runs of the
    vertices ``pick(out, run_end)`` chooses into their next vertex's row."""
    from lattice_net_tpu_torch.lattice import ops

    k3 = ops.seg_sum_sorted_fast
    picked = []

    def faulty(vals, ids, run_end, cap, plain=False):
        out = k3(vals, ids, run_end, cap, plain=plain).clone()
        v = pick(out, run_end)
        out[v + 1] += out[v]
        out[v] = 0.0
        picked.append(int(v.numel()))
        return out

    ops.seg_sum_sorted_fast = faulty
    try:
        _, grads = loss_and_grads(torch, loss_fn, params, batch)
    finally:
        ops.seg_sum_sorted_fast = k3
    check(len(picked) == 1, f"the faulty K3 ran {len(picked)} times in one step")
    return grads, picked[0]


def segvjp_gradients(torch, run, state, batch, dev):
    """One segvjp step against the default head, against its plain versions
    and (f32) against the CPU; and two planted K3 faults."""
    loss_fn = run.loss_fn()
    with default_head():
        loss_d, grads_d = loss_and_grads(torch, loss_fn, state.params, batch)
    with segvjp():
        loss_s, grads_s = loss_and_grads(torch, loss_fn, state.params, batch)
        zero_counts()
        loss_p, grads_p = loss_and_grads(torch, loss_fn, state.params, batch, plain=True)
        check(not any(read_counts().values()), "the plain segvjp step launched kernels")

        def largest(out, run_end):
            return out.norm(dim=1)[:-1].argmax()[None]

        def one_percent(out, run_end):
            prev = torch.cat([run_end.new_full((1,), -1), run_end[:-1]])
            with_runs = torch.nonzero(run_end[:-1] > prev[:-1]).flatten()
            return with_runs[::100]

        faults = {name: faulty_k3_grads(torch, loss_fn, state.params, batch, pick)
                  for name, pick in (("one_vertex", largest), ("one_percent", one_percent))}  # fmt: skip
    fault_rel = {k: worst_rel_l2(torch, g, grads_s)[0] for k, (g, _) in faults.items()}
    vs_default, vs_default_name = worst_rel_l2(torch, grads_s, grads_d)
    vs_plain, vs_plain_name = worst_rel_l2(torch, grads_s, grads_p)
    emit(dict(check="segvjp train step, bf16 convs", loss=loss_s,
              loss_abs_diff_default=abs(loss_s - loss_d), loss_abs_diff_plain=abs(loss_s - loss_p),
              vs_default_rel_l2=vs_default, vs_default_param=vs_default_name,
              vs_plain_rel_l2=vs_plain, vs_plain_param=vs_plain_name,
              planted_k3_fault_rel_l2=fault_rel,
              planted_k3_fault_vertices={k: n for k, (_, n) in faults.items()},
              tolerance=dict(loss=LOSS_ATOL, grad_rel_l2=TRAIN_PLAIN_GRAD_REL)))  # fmt: skip
    compare_grads(torch, grads_s, grads_d, TRAIN_PLAIN_GRAD_REL, "segvjp vs default head")
    compare_grads(torch, grads_s, grads_p, TRAIN_PLAIN_GRAD_REL, "segvjp kernels vs plain")
    check(abs(loss_s - loss_d) <= LOSS_ATOL, f"segvjp vs default loss {loss_s} vs {loss_d}")
    check(abs(loss_s - loss_p) <= LOSS_ATOL, f"segvjp kernels vs plain loss {loss_s} vs {loss_p}")
    for name, rel in fault_rel.items():
        check(
            rel > TRAIN_PLAIN_GRAD_REL,
            f"K3 summing runs into the next vertex ({name}) moved the gradients by only {rel}: "
            f"the tolerance {TRAIN_PLAIN_GRAD_REL} would pass it",
        )
    with segvjp():
        train_card_vs_cpu(torch, dev, "segvjp train step")


def dropout_step(torch, run, state, batch, dev):
    """One train step of the model with ``dropout_last_layer = DROPOUT`` (the
    same weights), its masks drawn from a Philox generator on the card."""
    import dataclasses

    from lattice_net_tpu_torch.models.lnn import LNN
    from lattice_net_tpu_torch.nn.modules import channel_keep_mask
    from lattice_net_tpu_torch.parallel.data_parallel import (
        forward_loss,
        make_loss_fn,
        make_train_step,
    )

    mp = dataclasses.replace(run.model.params, dropout_last_layer=DROPOUT)
    model = LNN(mp, torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(state.params)
    step = make_train_step(model, run.tx, run.sigma, mp.nr_downsamples, run.capacities)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    c = model.SliceFastModule_0.classify_kernel.shape[1]
    masks = [channel_keep_mask(c, DROPOUT, gen(s), dev) for s in (5, 5, 6)]
    check(torch.equal(masks[0], masks[1]), "one seed gave two keep masks")
    loss_fn = make_loss_fn(model, run.sigma, mp.nr_downsamples, run.capacities)
    with default_head():
        new, metrics = step(state, batch, gen(5))
        dropped = [forward_loss(loss_fn, state.params, batch, gen(5))[1].item() for _ in range(2)]
        plain_loss = forward_loss(run.loss_fn(), state.params, batch)[1].item()
    loss = float(metrics["loss"])
    emit(dict(check="train step with channel dropout", dropout=DROPOUT, channels=c,
              kept=int(masks[0].sum()), seeds_5_6_masks_differ=not torch.equal(masks[0], masks[2]),
              loss=loss, loss_without_dropout=plain_loss,
              same_seed_loss_diff=abs(dropped[0] - dropped[1])))  # fmt: skip
    check(math.isfinite(loss), f"dropout step: loss {loss}")
    check(all_finite(torch, new.params.values()), "dropout step: non-finite parameters")
    check(abs(dropped[0] - dropped[1]) <= LOSS_ATOL, f"one seed gave losses {dropped}")


class _Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.copy.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def trainer_probe(records):
    """Records the trainer's steps and epochs by wrapping ``StateCallback``'s
    hooks: every forward's loss and kernel launches (the counts are set to 0
    when an epoch starts and after each forward), and every epoch's loss,
    mIoU, samples, seconds and median step period (the wall time from one
    forward's loss read to the next, the first from the epoch's start)."""
    from lattice_net_tpu_torch.train.callbacks import StateCallback

    orig = {k: getattr(StateCallback, k) for k in ("epoch_started", "after_forward_pass", "epoch_ended")}
    t0, last, step_ms = [0.0], [0.0], []

    def epoch_started(self, phase=None, **kw):
        orig["epoch_started"](self, phase=phase, **kw)
        zero_counts()
        t0[0] = last[0] = time.perf_counter()
        step_ms.clear()

    def after_forward_pass(self, phase=None, loss=0.0, **kw):
        orig["after_forward_pass"](self, phase=phase, loss=loss, **kw)  # reads the loss: a sync
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        records["steps"].append(dict(phase=phase.name, loss=float(loss), launches=read_counts()))
        zero_counts()

    def epoch_ended(self, phase=None, **kw):
        n = phase.samples_processed_this_epoch
        seconds = time.perf_counter() - t0[0]
        records["epochs"].append(dict(
            phase=phase.name, epoch=phase.epoch_nr, loss=phase.loss_acum_per_epoch / max(n, 1),
            miou=phase.scores.avg_class_iou(), samples=n, seconds=seconds, samples_per_s=n / seconds,
            step_ms_median=statistics.median(step_ms) if step_ms else None,
        ))  # fmt: skip
        orig["epoch_ended"](self, phase=phase, **kw)

    StateCallback.epoch_started, StateCallback.after_forward_pass = epoch_started, after_forward_pass
    StateCallback.epoch_ended = epoch_ended
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(StateCallback, k, fn)


def jax_run_class_weights():
    lines = JAX_RUN_LOG.read_text().splitlines()
    line = lines[JAX_WEIGHTS_LINE - 1]
    check(line.startswith("class weights: "), f"{JAX_RUN_LOG.name}:{JAX_WEIGHTS_LINE} is {line[:60]!r}")
    return json.loads(line[len("class weights: "):])


def printed_class_weights(text):
    found = [json.loads(l[len("class weights: "):]) for l in text.splitlines()
             if l.startswith("class weights: ")]  # fmt: skip
    check(len(found) == 1, f"the trainer printed {len(found)} class-weight lines")
    return found[0]


def trainer_run(torch, config, records, **kw):
    """One ``ln_train.run`` on the card, its output kept; returns the final
    state and the printed text."""
    from lattice_net_tpu_torch.train.ln_train import run

    tee = _Tee(sys.stdout)
    with trainer_probe(records), contextlib.redirect_stdout(tee):
        state = run(config, **kw)
    torch.cuda.synchronize()
    return state, tee.copy.getvalue()


def states_equal(torch, a, b):
    """Bit equality of two train states: step, parameters, optimizer state."""
    def same(x, y):
        return x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y))

    if a.step != b.step or a.opt_state["count"] != b.opt_state["count"]:
        return False
    if set(a.opt_state) != set(b.opt_state):
        return False
    pairs = [(a.params, b.params)] + [(a.opt_state[k], b.opt_state[k]) for k in ("mu", "nu", "nu_max")]
    if "plateau" in a.opt_state:
        pairs.append((a.opt_state["plateau"], b.opt_state["plateau"]))
    return all(set(x) == set(y) and all(same(x[k], y[k]) for k in x) for x, y in pairs)


def trainer_cli(torch, dev):
    """Phase 14: the training CLI on the card, two epochs, then a resume."""
    import os

    from lattice_net_tpu_torch.train.checkpoint import load_checkpoint
    from lattice_net_tpu_torch.train.setup import TrainSetup

    steps_per_epoch = TRAINER_SCENES["train"]
    run = TrainSetup.from_config(SYNTH_CONFIG, NR_CLASSES, steps_per_epoch, device=dev)
    expected_step = launches_per_step(run.model, segvjp=False)
    expected_test = dict(k1=patch_gathers_per_scan(run.model), k1b=0, k2=1, k2b=0, k3=0, k4=0)
    plateau_tx = run.tx.plateau
    del run
    want_weights = jax_run_class_weights()
    totals = dict.fromkeys(counters(), 0)
    with tempfile.TemporaryDirectory() as tmp, environ(LNT_SCENE_CACHE=os.path.join(tmp, "scenes")):
        overrides = [
            f"loader_synth_kitti.nr_samples={TRAINER_SCENES['train']}",
            f"loader_synth_kitti.nr_samples_test={TRAINER_SCENES['test']}",
            f"train.checkpoint_path={tmp}/ckpt",
        ]
        first, second = dict(steps=[], epochs=[]), dict(steps=[], epochs=[])
        t0 = time.perf_counter()
        state1, text1 = trainer_run(torch, str(SYNTH_CONFIG), first, max_epochs=TRAINER_EPOCHS,
                                    eval_every=1, overrides=overrides)  # fmt: skip
        first_s = time.perf_counter() - t0
        got_weights = printed_class_weights(text1)
        check(len(got_weights) == len(want_weights), f"{len(got_weights)} class weights printed")
        diffs = [abs(a - b) for a, b in zip(got_weights, want_weights)]
        emit(dict(check="trainer class weights vs the JAX run's", printed=got_weights,
                  jax_run=want_weights, log=f"{JAX_RUN_LOG.relative_to(ROOT)}:{JAX_WEIGHTS_LINE}",
                  equal_to_3_decimals=sum(round(a, 3) == round(b, 3)
                                          for a, b in zip(got_weights, want_weights)),
                  max_abs_diff=max(diffs), tolerance=CLASS_WEIGHT_ATOL))  # fmt: skip
        check(max(diffs) <= CLASS_WEIGHT_ATOL,
              f"class weights {max(diffs)} from the JAX run's, over {CLASS_WEIGHT_ATOL}")  # fmt: skip
        ckpts = sorted(p.name for p in Path(tmp, "ckpt").glob("*.ckpt"))
        check("last.ckpt" in ckpts and any(n.startswith("model_e_") for n in ckpts),
              f"checkpoints after the first run: {ckpts}")  # fmt: skip
        loaded = load_checkpoint(Path(tmp, "ckpt", "last.ckpt"), state1)
        check(state1.step == TRAINER_EPOCHS * steps_per_epoch, f"first run ended at step {state1.step}")
        check(states_equal(torch, loaded, state1), "last.ckpt does not load bit-equal to the saved state")
        t0 = time.perf_counter()
        state2, text2 = trainer_run(torch, str(SYNTH_CONFIG), second, max_epochs=TRAINER_EPOCHS + 1,
                                    eval_every=1, overrides=overrides,
                                    resume=str(Path(tmp, "ckpt", "last.ckpt")))  # fmt: skip
        second_s = time.perf_counter() - t0
    resumed = f"at step {TRAINER_EPOCHS * steps_per_epoch} (epoch ~{TRAINER_EPOCHS})"
    check(resumed in text2, f"the second run did not resume {resumed}")
    check(state2.step == (TRAINER_EPOCHS + 1) * steps_per_epoch, f"resumed run ended at step {state2.step}")
    check(state2.opt_state["count"] == state2.step, f"AdamW count {state2.opt_state['count']}")
    # the saved plateau state carried through the resumed epoch's step losses
    plateau = dict(loaded.opt_state["plateau"])
    for rec in second["steps"]:
        if rec["phase"] == "train":
            loss = torch.tensor(rec["loss"], dtype=torch.float32, device=dev)
            plateau = plateau_tx.update(plateau, loss)
    carried = all(torch.equal(plateau[k], state2.opt_state["plateau"][k]) for k in plateau)
    emit(dict(check="plateau state across the resume",
              saved={k: v.item() for k, v in loaded.opt_state["plateau"].items()},
              final={k: v.item() for k, v in state2.opt_state["plateau"].items()},
              carried_from_saved=carried))  # fmt: skip
    check(carried, "the resumed run's plateau state does not follow from the saved one")
    for run_name, rec, seconds in (("first", first, first_s), ("resumed", second, second_s)):
        for e in rec["epochs"]:
            emit(dict(trainer_run=run_name, **e))
            where = f"{run_name} run, {e['phase']} epoch {e['epoch']}"
            check(math.isfinite(e["loss"]), f"{where}: loss {e['loss']}")
        for i, st in enumerate(rec["steps"]):
            check(math.isfinite(st["loss"]), f"{run_name} run, forward {i}: loss {st['loss']}")
            want = expected_step if st["phase"] == "train" else expected_test
            where = f"{run_name} run, {st['phase']} forward {i}"
            check(st["launches"] == want, f"{where}: launches {st['launches']}, expected {want}")
            for k in totals:
                totals[k] += st["launches"][k]
        emit(dict(trainer_run=run_name, seconds=seconds, forwards=len(rec["steps"])))
    emit(dict(trainer_launches=totals, per_train_step=expected_step, per_test_forward=expected_test))
    return totals


# ---------------------------------------------------------------------------
# SemanticKITTI evaluation and the sensor-rate stream
# ---------------------------------------------------------------------------


def captured(torch, fn, *args, **kw):
    """``fn(*args, **kw)`` with its printed output kept; returns the result
    and the text."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, tee.copy.getvalue()


def plain_labels(torch, predictor, positions, values):
    with norm_on_its_kernel():
        logp, _ = predictor.forward(positions, values, plain=True)
    return torch.argmax(logp, dim=-1)[: len(positions)].cpu().numpy()


def eval_run(torch, dev, kitti, ckpt, out, budget, k1_per_scan):
    """One ``ln_eval.run`` from ``ckpt`` writing into ``out``, with its
    checks; returns its row."""
    import numpy as np

    from lattice_net_tpu_torch.data.semantic_kitti import LEARNING_MAP_INV
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.misc.prepare_submission_semantickitti import prepare_submission
    from lattice_net_tpu_torch.train import ln_eval

    overrides = [f"loader_semantic_kitti.dataset_path={kitti}", f"eval.output_predictions_path={out}"]
    zero_counts()
    miou, text = captured(torch, ln_eval.run, str(CONFIG), str(ckpt), True, overrides, budget)
    counts = read_counts()
    line = [l for l in text.splitlines() if l.startswith("evaluated ")]
    check(len(line) == 1, f"ln_eval printed {len(line)} 'evaluated' lines")
    words = line[0].split()
    scans, chunks, points, seconds = int(words[1]), int(words[4]), int(words[7]), float(words[10])
    setup = ln_eval.setup_predictor(str(CONFIG), str(ckpt), overrides, budget, device=dev)
    bins = sorted(Path(kitti, "sequences", "11", "velodyne").glob("*.bin"))
    check(scans == len(bins) == KITTI_SCANS["test"], f"{scans} scans evaluated, {len(bins)} test scans")
    want_chunks = sum(-(-(b.stat().st_size // 16) // setup.n_points) for b in bins)
    check(chunks == want_chunks and points == setup.n_points, f"{chunks} chunks of {points} points")
    want = dict(k1=k1_per_scan * chunks, k1b=0, k2=chunks, k2b=0, k3=0, k4=0)
    check(counts == want, f"ln_eval at budget {points}: launches {counts}, expected {want}")
    lut = np.zeros(max(LEARNING_MAP_INV) + 1, np.uint32)
    for k, v in LEARNING_MAP_INV.items():
        lut[k] = v
    agree = total = 0
    for i, b in enumerate(bins):
        f = Path(out, "sequences", "11", "predictions", f"{b.stem}.label")
        check(f.exists(), f"no prediction file {f.relative_to(out)}")
        got, n_raw = np.fromfile(f, np.uint32), b.stat().st_size // 16  # xyzi float32 a point
        check(len(got) == n_raw, f"{f.name}: {len(got)} labels for {n_raw} points")
        off_map = set(np.unique(got).tolist()) - set(LEARNING_MAP_INV.values())
        check(not off_map, f"{f.name}: raw ids off the map {sorted(off_map)}")
        prepared = prepare_cloud(setup.loader.get_cloud(i), setup.predictor.params)
        plain = ln_eval.predict_cloud_chunked(
            lambda p, v: plain_labels(torch, setup.predictor, p, v), prepared, setup.n_points
        )
        agree += int((lut[plain] == got).sum())
        total += len(got)
    files = len(list(Path(out).rglob("*.label")))
    check(files == len(bins), f"{files} label files written for {len(bins)} scans")
    n_files, n_checked = prepare_submission(out, kitti, Path(out).with_suffix(".zip"))
    check(n_files == n_checked == len(bins), f"prepare_submission: {n_files} files, {n_checked} checked")
    row = dict(eval_budget=points, scans=scans, chunks=chunks, seconds=seconds,
               seconds_per_scan=seconds / scans, scans_per_s=scans / seconds, miou=miou, launches=counts,
               labels_vs_plain=agree / total, tolerance=SERVE_TOL["label_agreement"])  # fmt: skip
    emit(row)
    check(agree / total >= SERVE_TOL["label_agreement"], f"eval labels vs plain {agree / total}")
    return row


def stream_runs(torch, dev, k1_per_scan):
    """``ln_eval_stream`` for each wire, with its checks; returns the K1 and
    K2 launches."""
    import os

    import numpy as np

    from lattice_net_tpu_torch.train import ln_eval, ln_eval_stream

    overrides = [f"loader_synth_kitti.nr_samples={STREAM_SCENES}", "eval.checkpoint_path="]
    launches = dict(k1=0, k2=0)
    forwards = 1 + ln_eval_stream.COMPUTE_ITERS + STREAM_SCANS  # warm-up, timing, stream
    with environ(LNT_SCENE_CACHE=os.path.abspath("scenes")):
        setup = ln_eval.setup_predictor(str(STREAM_CONFIG), "", overrides, device=dev)
        want_labels = []
        for k in range(STREAM_SCANS):
            b = ln_eval_stream._prep_np(setup.loader.get_cloud(k % STREAM_SCENES), setup.predictor.params,
                                        setup.n_points)  # fmt: skip
            n = int(b["n_valid"])
            want_labels.append(setup.predictor.predict(b["positions"][:n], b["values"][:n]))
        del setup
        for wire in ("f32", "f16", "i16"):
            zero_counts()
            res, _ = captured(torch, ln_eval_stream.run, str(STREAM_CONFIG), "", STREAM_HZ, STREAM_SCANS,
                              overrides, wire=wire, device=dev)  # fmt: skip
            counts = read_counts()
            want = dict(k1=k1_per_scan * forwards, k1b=0, k2=forwards, k2b=0, k3=0, k4=0)
            check(counts == want, f"stream wire {wire}: launches {counts}, expected {want}")
            launches["k1"] += counts["k1"]
            launches["k2"] += counts["k2"]
            lat = res.latency_ms
            check(len(lat) == STREAM_SCANS and bool(np.isfinite(lat).all()),
                  f"stream wire {wire}: latencies {lat}")  # fmt: skip
            same = [float(np.mean(a == b)) for a, b in zip(res.labels, want_labels)]
            emit(dict(stream_wire=wire, scans=len(lat), rate_hz=STREAM_HZ, compute_only_ms=res.compute_ms,
                      h2d_ms=res.h2d_ms, mb_per_scan=res.bytes_per_scan / 1e6,
                      e2e_p50_ms=float(np.percentile(lat, 50)), e2e_p95_ms=float(np.percentile(lat, 95)),
                      e2e_max_ms=float(lat.max()), misses=res.misses,
                      sustained_scans_per_s=res.scans_per_s, labels_vs_predict_min=min(same),
                      labels_vs_predict_mean=float(np.mean(same)), launches=counts))  # fmt: skip
            if wire == "f32":
                check(min(same) == 1.0, f"f32 stream labels differ from Predictor.predict: {same}")
    return launches


def kitti_eval(torch, dev, k1_per_scan):
    """Phase 15: a KITTI-format directory, one epoch of the trainer on it,
    ``ln_eval`` from its checkpoint at two budgets, and the stream."""
    from lattice_net_tpu_torch.data.synth_kitti import write_kitti_dir
    from lattice_net_tpu_torch.train.setup import TrainSetup

    run = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_SCANS["train"], device=dev)
    expected_step = launches_per_step(run.model, segvjp=False)
    expected_test = dict(k1=k1_per_scan, k1b=0, k2=1, k2b=0, k3=0, k4=0)
    del run
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        kitti = write_kitti_dir(Path(tmp, "kitti"), KITTI_SCANS["train"], KITTI_SCANS["test"], KITTI_POINTS,
                                seed=0, classes=NR_CLASSES)  # fmt: skip
        emit(dict(kitti_dir=KITTI_SCANS, points=KITTI_POINTS, seconds=time.perf_counter() - t0))
        records = dict(steps=[], epochs=[])
        overrides = [f"loader_semantic_kitti.dataset_path={kitti}", f"train.checkpoint_path={tmp}/ckpt"]
        t0 = time.perf_counter()
        _, text = trainer_run(torch, str(TRAIN_CONFIG), records, max_epochs=1, overrides=overrides)
        readers = sorted({l for l in text.splitlines() if l.startswith("semantickitti reader:")})
        tb = [l for l in text.splitlines() if l.startswith("tensorboard:")]
        test = [e for e in records["epochs"] if e["phase"] == "test"]
        check(len(test) == 1, f"{len(test)} test epochs")
        for e in records["epochs"]:
            emit(dict(kitti_trainer=e["phase"], **e))
            check(math.isfinite(e["loss"]), f"KITTI trainer {e['phase']} loss {e['loss']}")
        for st in records["steps"]:
            want = expected_step if st["phase"] == "train" else expected_test
            check(st["launches"] == want,
                  f"KITTI trainer {st['phase']}: launches {st['launches']}, expected {want}")  # fmt: skip
        totals = {k: sum(st["launches"][k] for st in records["steps"]) for k in expected_step}
        emit(dict(kitti_trainer_seconds=time.perf_counter() - t0, readers=readers, tensorboard=tb,
                  forwards=len(records["steps"]), launches=totals))  # fmt: skip
        check(readers and all(r.startswith("semantickitti reader: native") for r in readers),
              f"the native reader did not run: {readers}")  # fmt: skip
        ckpt = Path(tmp, "ckpt", "last.ckpt")
        check(ckpt.exists(), "the trainer wrote no last.ckpt")
        whole = eval_run(torch, dev, kitti, ckpt, Path(tmp, "pred_whole"), 0, k1_per_scan)
        chunked = eval_run(torch, dev, kitti, ckpt, Path(tmp, "pred_chunked"), EVAL_CHUNK, k1_per_scan)
        check(whole["chunks"] == KITTI_SCANS["test"] and chunked["chunks"] == 2 * KITTI_SCANS["test"],
              f"chunks {whole['chunks']} and {chunked['chunks']}")  # fmt: skip
        gap = abs(whole["miou"] - test[0]["miou"])
        ablation = [l for l in CHUNK_ABLATION_LOG.read_text().splitlines() if l.startswith("RESULT")]
        emit(dict(check="eval mIoU vs the trainer's test phase", eval_miou=whole["miou"],
                  trainer_test_miou=test[0]["miou"], abs_diff=gap, tolerance=EVAL_MIOU_ATOL,
                  chunk_ablation_card=dict(whole=whole["miou"], two_chunks=chunked["miou"],
                                           gap=chunked["miou"] - whole["miou"]),
                  chunk_ablation_cpu_log=ablation))  # fmt: skip
        check(gap <= EVAL_MIOU_ATOL, f"eval mIoU {whole['miou']} vs the trainer's {test[0]['miou']}")
        eval_launches = {k: whole["launches"][k] + chunked["launches"][k] for k in ("k1", "k2")}
        stream = stream_runs(torch, dev, k1_per_scan)
    return dict(eval=eval_launches, stream=stream, trainer=totals)

# ---------------------------------------------------------------------------
# ScanNet: the 5M-row tables, auto capacities, the row-chunked conv
# ---------------------------------------------------------------------------


def log_line(path, prefix):
    """The first line of ``path`` starting with ``prefix`` (after indentation)."""
    lines = [l.strip() for l in path.read_text().splitlines() if l.strip().startswith(prefix)]
    check(lines, f"{path.name}: no line starting {prefix!r}")
    return lines[0]


def scannet_scale(torch, dev):
    """Phase 16a: the probe's 5M-table build and its full-width forward at 2^21."""
    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe

    rec, _ = captured(torch, probe.run, SCANNET_POINTS, probe.TABLE_CAP, iters=1, device=dev)
    t = rec["table"]
    jax_line = log_line(SCANNET_PROBE_LOG, "occupancy per level:")
    jax_occ = json.loads(jax_line.split(":", 1)[1].split("/")[0])
    emit(dict(check="5M-table build of make_indoor_scene(400000, seed=0)", capacities=t["capacities"],
              occupancy=t["occupancy"], overflow=t["overflow"], jax_probe_occupancy=jax_occ,
              jax_probe_overflow=[0, 0, 0, 0], jax_probe_log=SCANNET_PROBE_LOG.name,
              build_ms=t["build_ms"], peak_mem_gb=t["peak_mem_gb"]))  # fmt: skip
    check(t["capacities"] == [5242880, 2621440, 1310720, 655360], f"table capacities {t['capacities']}")
    check(sum(t["overflow"]) == 0, f"the 5M-table build overflowed: {t['overflow']}")
    emit(dict(check="full-width ScanNet forward at 2^21", capacities=rec["capacities"],
              occupancy=rec["occupancy"], overflow=rec["overflow"], model_params=rec["model_params"],
              first_ms=rec["first_ms"], ms=rec["value"], peak_mem_gb=rec["peak_mem_gb"],
              k1_per_forward=rec["k1_per_forward"], k2_per_forward=rec["k2_per_forward"]))  # fmt: skip
    check(rec["model_params"] == SCANNET_PARAMS, f"{rec['model_params']} parameters, expected {SCANNET_PARAMS}")
    check(sum(rec["overflow"]) == 0, f"the 2^21 build overflowed: {rec['overflow']}")
    # simplex reps at 2^21, a re-splat at 5M (31 signature bits): one vertex set
    check(rec["occupancy"] == t["occupancy"], f"occupancy {rec['occupancy']} at 2^21, {t['occupancy']} at 5M")
    return probe_head_gather(torch, dev, rec["capacities"])


def probe_head_gather(torch, dev, caps):
    """K1 on the head gather of the probe's 2^21 forward: the splat ids of
    ``make_indoor_scene(400000, seed=0)`` at the model capacities into a
    (2^21, 8 + 21) f32 table of seeded values, as in :func:`check_k1`."""
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy
    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe

    positions = torch.from_numpy(probe.make_indoor_scene(SCANNET_POINTS, seed=0)[0]).to(dev)
    with torch.inference_mode():
        h = build_hierarchy(positions, 0.08, len(caps) - 1, tuple(caps))
    ids = h.splat_idx.clone()
    gen = torch.Generator(device=dev).manual_seed(21)
    values = torch.randn(caps[0], 8 + 21, generator=gen, device=dev)
    del h
    return check_k1(torch, [(values, ids, False, "head", 0)], dev, "probe head gather at 2^21")


def scannet_train(torch, dev, root, tmp):
    """Phase 16b: one trainer epoch at auto capacities, then the kernels on a
    ScanNet step's inputs and ``SCANNET_STEPS`` timed steps."""
    from lattice_net_tpu_torch.config import apply_overrides, load_config
    from lattice_net_tpu_torch.data.scannet import ScanNet
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState, make_batch
    from lattice_net_tpu_torch.train.setup import TrainSetup

    overrides = [f"loader_scannet.dataset_path={root}", f"train.checkpoint_path={tmp}/ckpt",
                 "lattice_gpu.capacity_mode=auto", "lattice_gpu.capacity_headroom=1.5"]  # fmt: skip
    records = dict(steps=[], epochs=[])
    t0 = time.perf_counter()
    _, text = trainer_run(torch, str(SCANNET_TRAIN_CONFIG), records, max_epochs=1, n_points=SCANNET_POINTS,
                          overrides=overrides)  # fmt: skip
    seconds = time.perf_counter() - t0
    scout = [l for l in text.splitlines() if l.startswith("capacity_mode=auto:")]
    check(len(scout) == 1, f"the trainer printed {len(scout)} scout lines")
    caps = tuple(json.loads(scout[0].split("-> caps ")[1].split(" (")[0]))
    emit(dict(scannet_scout=scout[0], jax_run=log_line(SCANNET_TRAIN_LOG, "capacity_mode=auto:"),
              jax_log=SCANNET_TRAIN_LOG.name))  # fmt: skip
    check(f"model parameters: {SCANNET_PARAMS:,}" in text, "the trainer's parameter count")
    cfg = apply_overrides(load_config(SCANNET_TRAIN_CONFIG), overrides)
    run = TrainSetup.from_config(cfg, 21, SCANNET_SCENES["train"], device=dev, capacities=caps)
    expected_step = launches_per_step(run.model, segvjp=False)
    expected_test = dict(k1=patch_gathers_per_scan(run.model), k1b=0, k2=1, k2b=0, k3=0, k4=0)
    for e in records["epochs"]:
        emit(dict(scannet_trainer=e["phase"], **e))
        check(math.isfinite(e["loss"]), f"ScanNet trainer {e['phase']} loss {e['loss']}")
    for st in records["steps"]:
        want = expected_step if st["phase"] == "train" else expected_test
        check(st["launches"] == want, f"ScanNet trainer {st['phase']}: launches {st['launches']}, expected {want}")
    totals = {k: sum(st["launches"][k] for st in records["steps"]) for k in expected_step}
    # the held-out phase reads "val", which is the train split in ScanNet's reader (ROADMAP §3)
    test_n = [e["samples"] for e in records["epochs"] if e["phase"] == "test"]
    emit(dict(scannet_trainer_seconds=seconds, forwards=len(records["steps"]), launches=totals,
              per_train_step=expected_step, per_test_forward=expected_test, test_samples=test_n))  # fmt: skip
    check(test_n == [SCANNET_SCENES["train"]], f"test phase samples {test_n}: ScanNet's val is its train split")
    check(Path(tmp, "ckpt", "last.ckpt").exists(), "the ScanNet trainer wrote no last.ckpt")

    cloud = ScanNet(root, mode="train", max_nr_points_per_cloud=SCANNET_POINTS, shuffle=False).get_cloud(0)
    batch = make_batch([prepare_cloud(cloud, run.model.params)], SCANNET_STEP_BUDGET, device=dev)
    state = TrainState.create(run.model.state_dict(), run.tx)
    step_kernels = train_step_kernels_vs_plain(torch, run, state, batch, dev, where="ScanNet train step")
    steps, per_step = train(torch, run, state, batch, steps=SCANNET_STEPS,
                            what=f"ScanNet train config at caps {list(caps)}, one 400k-point scene in a 2^19 "
                            "budget")  # fmt: skip
    for k in totals:
        totals[k] += steps[k]
    return totals, per_step, step_kernels, caps


@contextlib.contextmanager
def conv_blocks_recorded(blocks):
    """Appends ``(cq, extent, c_in, itemsize, nb)`` for each conv (and each
    weight gradient) that asks the conv's row-block rule inside the block."""
    from lattice_net_tpu_torch.lattice import ops

    rule = ops._conv_row_blocks

    def recording(cq, extent, c_in, itemsize):
        nb = rule(cq, extent, c_in, itemsize)
        blocks.append((cq, extent, c_in, itemsize, nb))
        return nb

    ops._conv_row_blocks = recording
    try:
        yield blocks
    finally:
        ops._conv_row_blocks = rule


def k1_launches_of(blocks):
    """K1 launches of the recorded convs: one a row block."""
    from lattice_net_tpu_torch.lattice.ops import _row_blocks

    return sum(len(_row_blocks(cq, nb)) for cq, _, _, _, nb in blocks)


def chunked_vs_one_block(torch, pred, prepared, name, dtype_label):
    """One scene's forward with row-chunked convs against the same forward
    with every conv in one block: labels >= 99.9%, log-probabilities to 1e-3
    (a block's GEMM gives the whole GEMM's rows, so the two should agree
    bit for bit); prints the blocks of each chunked conv, the K1 launches
    (one a block, plus the head's) and the peak memory both ways."""
    n = len(prepared[0])
    row = dict(scene=name, convs=dtype_label, points=n)
    logps = {}
    for key, budget in (("chunked", None), ("one_block", SCANNET_UNCHUNKED)):
        conv_blocks = []
        env = {} if budget is None else dict(LNT_CONV_CHUNK_BYTES=str(budget))
        torch.cuda.empty_cache()
        with environ(**env), conv_blocks_recorded(conv_blocks):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            logp, _ = pred.forward(prepared[0], prepared[1])
            logps[key] = logp[:n].float()
            torch.cuda.synchronize()
        row[f"{key}_k1"] = read_counts()["k1"]
        row[f"{key}_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row[f"{key}_nb"] = sorted({(cq, e, c, nb) for cq, e, c, _, nb in conv_blocks if nb > 1})
        check(row[f"{key}_k1"] == k1_launches_of(conv_blocks) + 1, f"{key} forward: K1 {row[f'{key}_k1']}")
    same = (logps["chunked"].argmax(-1) == logps["one_block"].argmax(-1)).float().mean().item()
    gap = (logps["chunked"] - logps["one_block"]).abs().amax(-1)
    row.update(label_agreement=same, logp_max_abs=gap.max().item(), logp_mean_abs=gap.mean().item(),
               points_over_1e3=int((gap > SERVE_TOL["logp_max_abs"]).sum()), tolerance=SERVE_TOL,
               bit_equal=bool(torch.equal(logps["chunked"], logps["one_block"])))  # fmt: skip
    emit(dict(check="ScanNet eval forward, row-chunked convs vs one block a conv", **row))
    check(same >= SERVE_TOL["label_agreement"], f"{dtype_label} chunked vs one block labels {same}")
    check(row["logp_max_abs"] <= SERVE_TOL["logp_max_abs"],
          f"{dtype_label} chunked vs one block logp {row['logp_max_abs']}")  # fmt: skip
    check(not row["one_block_nb"] and row["chunked_nb"], "the chunked forward ran no conv in blocks")


def scannet_eval(torch, dev, root, ckpt, tmp):
    """Phase 16c: ``ln_eval`` at the config's 5M-row tables, its files, its
    labels against the plain path, and the row-chunked conv against the same
    forward in one block a conv."""
    import numpy as np

    from lattice_net_tpu_torch.config import apply_overrides, load_config
    from lattice_net_tpu_torch.data.scannet import VALID_CLASS_IDS, read_ply_xyz_rgb_label
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.serve import Predictor
    from lattice_net_tpu_torch.train import ln_eval

    out = Path(tmp, "pred")
    overrides = [f"loader_scannet.dataset_path={root}", f"eval.output_predictions_path={out}"]
    blocks = []
    torch.cuda.reset_peak_memory_stats()
    with conv_blocks_recorded(blocks):
        zero_counts()
        miou, text = captured(torch, ln_eval.run, str(SCANNET_EVAL_CONFIG), str(ckpt), True, overrides, 0)
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    words = [l for l in text.splitlines() if l.startswith("evaluated ")][0].split()
    scans, chunks, points, seconds = int(words[1]), int(words[4]), int(words[7]), float(words[10])
    setup = ln_eval.setup_predictor(str(SCANNET_EVAL_CONFIG), str(ckpt), overrides, 0, device=dev)
    pred = setup.predictor
    check(pred.capacities == SCANNET_EVAL_CAPS, f"eval capacities {pred.capacities}")
    check(scans == SCANNET_SCENES["test"] == len(setup.loader), f"{scans} scans evaluated")
    heads = chunks  # one head gather a chunk
    want = dict(k1=k1_launches_of(blocks) + heads, k1b=0, k2=chunks, k2b=0, k3=0, k4=0)
    check(counts == want, f"ScanNet ln_eval: launches {counts}, expected {want} (one K1 a row block)")
    inv = np.zeros(21, np.int64)
    inv[1:] = VALID_CLASS_IDS
    agree = total = 0
    for i, scene in enumerate(setup.loader.scenes):
        cloud = setup.loader.get_cloud(i)
        f = out / f"{cloud.name}.txt"
        check(f.exists(), f"no prediction file {f.name}")
        got = np.loadtxt(f, dtype=np.int64).reshape(-1)
        n_raw = len(read_ply_xyz_rgb_label(scene)[0])
        check(len(got) == n_raw, f"{f.name}: {len(got)} lines for {n_raw} raw points")
        off = set(np.unique(got).tolist()) - {0, *VALID_CLASS_IDS}
        check(not off, f"{f.name}: ids off the NYU40 benchmark set {sorted(off)}")
        prepared = prepare_cloud(cloud, pred.params)
        plain = ln_eval.predict_cloud_chunked(lambda p, v: plain_labels(torch, pred, p, v), prepared,
                                              setup.n_points)  # fmt: skip
        agree += int((inv[plain] == got).sum())
        total += len(got)
        chunked_vs_one_block(torch, pred, prepared, cloud.name, "bf16")
    # the same with f32 convs: other block counts (4-byte rows)
    cfg = apply_overrides(load_config(SCANNET_EVAL_CONFIG), overrides)
    pred32 = Predictor.from_config(cfg, 21, dev, torch.float32, n_points=setup.n_points, checkpoint=ckpt)
    prepared = prepare_cloud(setup.loader.get_cloud(0), pred32.params)
    chunked_vs_one_block(torch, pred32, prepared, setup.loader.get_cloud(0).name, "f32")
    del pred32
    files = len(list(out.glob("*.txt")))
    check(files == scans, f"{files} prediction files for {scans} scans")
    emit(dict(scannet_eval_capacities=list(pred.capacities), scans=scans, chunks=chunks, points=points,
              seconds=seconds, seconds_per_scan=seconds / scans, scans_per_s=scans / seconds, miou=miou,
              launches=counts, peak_mem_gb=peak, labels_vs_plain=agree / total,
              tolerance=SERVE_TOL["label_agreement"],
              row_blocks=sorted({(cq, e, c, nb) for cq, e, c, _, nb in blocks})))  # fmt: skip
    check(agree / total >= SERVE_TOL["label_agreement"], f"ScanNet eval labels vs plain {agree / total}")

    # K1 on the 5M tables, one recorded call per (table, width, dtype, centre)
    # and, for a same-level conv, one more from a block past the first (its
    # centre column at an offset): the other blocks have the same shapes
    seen = set()

    def first_of_shape(values, neighbors, include_center, row0):
        key = (tuple(values.shape), neighbors.shape[1], include_center, values.dtype, include_center and row0 > 0)
        if key in seen:
            return False
        seen.add(key)
        return True

    prepared = prepare_cloud(setup.loader.get_cloud(0), pred.params)
    with recording_kernel_inputs(torch, keep_k1=first_of_shape) as (calls, _):
        pred.forward(prepared[0], prepared[1])
    del setup, pred
    check(any(c[4] > 0 for c in calls["k1"]), "no K1 call of a row block past the first was recorded")
    k1 = check_k1(torch, calls["k1"], dev, "ScanNet eval at 5M rows")
    return counts, k1


def scannet(torch, dev):
    """Phase 16: ScanNet at full width on the card."""
    from lattice_net_tpu_torch.data.synth_scannet import write_scannet_dir

    probe_head = scannet_scale(torch, dev)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        root = write_scannet_dir(Path(tmp, "scannet"), SCANNET_SCENES["train"], SCANNET_SCENES["test"],
                                 SCANNET_POINTS, seed=0)  # fmt: skip
        emit(dict(scannet_dir=SCANNET_SCENES, points=SCANNET_POINTS, seconds=time.perf_counter() - t0))
        train_launches, per_step, step_kernels, caps = scannet_train(torch, dev, root, tmp)
        eval_launches, eval_k1 = scannet_eval(torch, dev, root, Path(tmp, "ckpt", "last.ckpt"), tmp)
    return dict(train=train_launches, eval=eval_launches, per_step=per_step, step=step_kernels,
                eval_k1=eval_k1, probe_head=probe_head, caps=caps)  # fmt: skip


# ---------------------------------------------------------------------------
# ShapeNet part segmentation: batch 4, the ablation modes
# ---------------------------------------------------------------------------


def shapenet_setup(torch, dev, overrides=()):
    """The ShapeNet train config's model and optimizer on the card, with a
    plateau period of one step."""
    from lattice_net_tpu_torch.config import apply_overrides, load_config
    from lattice_net_tpu_torch.train.setup import TrainSetup

    cfg = apply_overrides(load_config(SHAPENET_TRAIN_CONFIG), list(overrides))
    return TrainSetup.from_config(cfg, SHAPENET_CLASSES, 1, device=dev)


def shapenet_eval(torch, dev, root, ckpt, out, overrides, k1_per_scan):
    """``ln_eval`` on the ShapeNet eval config from ``ckpt`` over the test
    split, writing into ``out``, with its checks; returns its row."""
    import numpy as np

    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.train import ln_eval

    overrides = [f"loader_shapenet_partseg.dataset_path={root}", f"eval.output_predictions_path={out}",
                 *overrides]  # fmt: skip
    zero_counts()
    miou, text = captured(torch, ln_eval.run, str(SHAPENET_EVAL_CONFIG), str(ckpt), True, overrides, 0)
    counts = read_counts()
    words = [l for l in text.splitlines() if l.startswith("evaluated ")][0].split()
    scans, chunks, points, seconds = int(words[1]), int(words[4]), int(words[7]), float(words[10])
    setup = ln_eval.setup_predictor(str(SHAPENET_EVAL_CONFIG), str(ckpt), overrides, 0, device=dev)
    check(scans == chunks == len(setup.loader),
          f"{scans} clouds in {chunks} chunks, {len(setup.loader)} test clouds")  # fmt: skip
    want = dict(k1=k1_per_scan * chunks, k1b=0, k2=chunks, k2b=0, k3=0, k4=0)
    check(counts == want, f"ShapeNet ln_eval: launches {counts}, expected {want}")
    agree = total = 0
    for i in range(len(setup.loader)):
        cloud = setup.loader.get_cloud(i)
        f = Path(out, f"pred_{cloud.name}.txt")
        check(f.exists(), f"no prediction file {f.name}")
        got = np.loadtxt(f, dtype=np.int64).reshape(-1)
        check(len(got) == len(cloud.V), f"{f.name}: {len(got)} lines for {len(cloud.V)} points")
        check(got.min() >= 0 and got.max() < SHAPENET_CLASSES, f"{f.name}: labels off [0, 7)")
        prepared = prepare_cloud(cloud, setup.predictor.params)
        plain = ln_eval.predict_cloud_chunked(lambda p, v: plain_labels(torch, setup.predictor, p, v), prepared,
                                              setup.n_points)  # fmt: skip
        agree += int((plain == got).sum())
        total += len(got)
    files = len(list(Path(out).glob("pred_*.txt")))
    check(files == scans, f"{files} prediction files for {scans} clouds")
    row = dict(shapenet_eval_budget=points, clouds=scans, seconds=seconds, seconds_per_cloud=seconds / scans,
               clouds_per_s=scans / seconds, miou=miou, launches=counts, labels_vs_plain=agree / total,
               tolerance=SERVE_TOL["label_agreement"])  # fmt: skip
    emit(row)
    check(agree / total >= SERVE_TOL["label_agreement"], f"ShapeNet eval labels vs plain {agree / total}")
    return row


def printed_occupancy(text):
    """(level-0 occupancy, overflow) of each ``[train] lattice occupancy`` line."""
    out = []
    for l in text.splitlines():
        if l.startswith("[train] lattice occupancy "):
            words = l.split()
            out.append((int(words[3].split("/")[0]), float(words[5])))
    return out


def shapenet_full_width(torch, dev, root, tmp):
    """Phase 17a: one trainer epoch of the ShapeNet config as written, then
    ``ln_eval`` from its ``last.ckpt``."""
    run = shapenet_setup(torch, dev)
    clouds = 4  # the config's batch size: every step runs each kernel once a slot
    expected_step = {k: n * clouds for k, n in launches_per_step(run.model, segvjp=False).items()}
    per_scan = patch_gathers_per_scan(run.model)
    expected_test = dict(k1=per_scan * clouds, k1b=0, k2=clouds, k2b=0, k3=0, k4=0)
    check(run.capacities == (60000, 30000, 15000, 7500), f"ShapeNet capacities {run.capacities}")
    del run
    records = dict(steps=[], epochs=[])
    overrides = [f"loader_shapenet_partseg.dataset_path={root}", f"train.checkpoint_path={tmp}/ckpt"]
    t0 = time.perf_counter()
    _, text = trainer_run(torch, str(SHAPENET_TRAIN_CONFIG), records, max_epochs=1, overrides=overrides)
    seconds = time.perf_counter() - t0
    check(f"model parameters: {SHAPENET_PARAMS:,}" in text, "the ShapeNet trainer's parameter count")
    check("batch=4 caps=(60000, 30000, 15000, 7500) sigma=0.05 classes=7" in text, "the ShapeNet run's setup line")
    readers = sorted({l for l in text.splitlines() if l.startswith("shapenet reader:")})
    check(readers and all(r.startswith("shapenet reader: native") for r in readers),
          f"the native reader did not run: {readers}")  # fmt: skip
    occupancy = printed_occupancy(text)
    check(occupancy and all(ov == 0.0 for _, ov in occupancy), f"ShapeNet overflow: {occupancy}")
    for e in records["epochs"]:
        emit(dict(shapenet_trainer=e["phase"], **e))
        check(math.isfinite(e["loss"]), f"ShapeNet trainer {e['phase']} loss {e['loss']}")
    for st in records["steps"]:
        want = expected_step if st["phase"] == "train" else expected_test
        where = f"ShapeNet trainer {st['phase']}"
        check(st["launches"] == want, f"{where}: launches {st['launches']}, expected {want}")
        check(math.isfinite(st["loss"]), f"{where}: loss {st['loss']}")
    totals = {k: sum(st["launches"][k] for st in records["steps"]) for k in expected_step}
    phases = [st["phase"] for st in records["steps"]]
    check(phases == ["train"] * (SHAPENET_SCENES["train"] // clouds) + ["test"],
          f"ShapeNet trainer forwards {phases}")  # fmt: skip
    emit(dict(shapenet_trainer_seconds=seconds, readers=readers, occupancy_overflow=occupancy,
              forwards=len(records["steps"]), launches=totals, per_train_step=expected_step,
              per_test_forward=expected_test))  # fmt: skip
    ckpt = Path(tmp, "ckpt", "last.ckpt")
    check(ckpt.exists(), "the ShapeNet trainer wrote no last.ckpt")
    ev = shapenet_eval(torch, dev, root, ckpt, Path(tmp, "pred"), (), per_scan)
    return totals, ev["launches"], per_scan


def shapenet_step(torch, dev, root):
    """Phase 17b and d: the kernels on one ShapeNet step's inputs (four
    train clouds, the config's batch), ``SHAPENET_STEPS`` timed steps, and
    one step in each ablation mode."""
    from lattice_net_tpu_torch.data.shapenet import ShapeNetPartSeg
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState, make_batch

    run = shapenet_setup(torch, dev)
    loader = ShapeNetPartSeg(root, mode="train", shuffle=False)
    budget = 1 << int(math.ceil(math.log2(SHAPENET_POINTS)))  # the trainer's budget
    batch = make_batch([prepare_cloud(loader.get_cloud(i), run.model.params) for i in range(4)], budget,
                       device=dev)  # fmt: skip
    state = TrainState.create(run.model.state_dict(), run.tx)
    kernels = train_step_kernels_vs_plain(torch, run, state, batch, dev, where="ShapeNet train step")
    steps, per_step = train(torch, run, state, batch, steps=SHAPENET_STEPS,
                            what="ShapeNet train config at caps [60000, 30000, 15000, 7500], 4 motorbikes "
                            f"of {SHAPENET_POINTS} points in a {budget}-point budget")  # fmt: skip
    del run
    for mode in ABLATIONS:
        ab = shapenet_setup(torch, dev, [f"model.experiment={mode}"])
        check(ab.model.params.experiment == mode, f"the model's experiment {ab.model.params.experiment}")
        check(set(ab.model.state_dict()) == set(state.params), f"{mode}: the parameters differ from none's")
        zero_counts()
        new, metrics = ab.train_step()(state, batch)
        torch.cuda.synchronize()
        counts, loss = read_counts(), float(metrics["loss"])
        emit(dict(shapenet_ablation=mode, loss=loss, launches=counts, expected=per_step))
        check(math.isfinite(loss) and all_finite(torch, new.params.values()), f"{mode}: loss {loss}")
        check(counts == per_step, f"{mode}: launches {counts}, expected {per_step} (the 'none' model's)")
        for k in steps:
            steps[k] += counts[k]
        del ab, new
    return kernels, steps, per_step


def jax_log_numbers():
    """The JAX run's per-epoch occupancy, held-out and eval mIoU."""
    text = SHAPENET_TRAIN_LOG.read_text()
    occ = [o for o, _ in printed_occupancy(text)]
    test = [float(l.split("mIoU")[1]) for l in text.splitlines() if l.startswith("[test] epoch")]
    ev = float(log_line(SHAPENET_EVAL_LOG, "mIoU:").split()[1])
    return occ, test, ev


def shapenet_log_run(torch, dev, tmp, per_scan):
    """Phase 17c: the JAX log's own command, printed beside the log."""
    from lattice_net_tpu_torch.data.synth_shapenet import write_benchmark_dir

    root = write_benchmark_dir(Path(tmp, "log"), SHAPENET_LOG_SCENES["train"], SHAPENET_LOG_SCENES["test"])
    overrides = [f"loader_shapenet_partseg.dataset_path={root}", f"train.checkpoint_path={tmp}/log_ckpt",
                 f"lattice_gpu.hash_table_capacity={SHAPENET_LOG_CAPACITY}"]  # fmt: skip
    records = dict(steps=[], epochs=[])
    t0 = time.perf_counter()
    _, text = trainer_run(torch, str(SHAPENET_TRAIN_CONFIG), records, max_epochs=SHAPENET_LOG_EPOCHS,
                          eval_every=SHAPENET_LOG_EVAL_EVERY, overrides=overrides)  # fmt: skip
    seconds = time.perf_counter() - t0
    occupancy = printed_occupancy(text)
    test = [e["miou"] for e in records["epochs"] if e["phase"] == "test"]
    train = [e for e in records["epochs"] if e["phase"] == "train"]
    jax_occ, jax_test, jax_eval = jax_log_numbers()
    setup = [l for l in text.splitlines() if l.startswith("n_points=")]
    emit(dict(check="the JAX log's ShapeNet run, beside the log", setup=setup,
              jax_setup=log_line(SHAPENET_TRAIN_LOG, "n_points="), occupancy=[o for o, _ in occupancy],
              jax_occupancy=jax_occ, overflow=[ov for _, ov in occupancy], heldout_miou=test,
              jax_heldout_miou=jax_test, train_miou=[e["miou"] for e in train],
              train_samples=[e["samples"] for e in train],
              test_samples=[e["samples"] for e in records["epochs"] if e["phase"] == "test"],
              train_samples_per_s=[e["samples_per_s"] for e in train],
              step_ms_median=[e["step_ms_median"] for e in train], seconds=seconds,
              jax_log=SHAPENET_TRAIN_LOG.name))  # fmt: skip
    check(len(occupancy) == SHAPENET_LOG_EPOCHS and all(ov == 0.0 for _, ov in occupancy),
          f"the log run's occupancy and overflow {occupancy}")  # fmt: skip
    check(len(test) == len(jax_test), f"{len(test)} held-out epochs, the log has {len(jax_test)}")
    check(all(math.isfinite(e["loss"]) for e in records["epochs"]), "a non-finite epoch loss")
    check(test[-1] > SHAPENET_LEARNED_MIOU,
          f"last held-out mIoU {test[-1]}: no learning past {SHAPENET_LEARNED_MIOU}")  # fmt: skip
    ev = shapenet_eval(torch, dev, root, Path(tmp, "log_ckpt", "last.ckpt"), Path(tmp, "log_pred"),
                       [f"lattice_gpu.hash_table_capacity={SHAPENET_LOG_CAPACITY}"], per_scan)  # fmt: skip
    emit(dict(check="the log run's eval mIoU beside the JAX eval log's", miou=ev["miou"], jax_eval_miou=jax_eval,
              jax_log=SHAPENET_EVAL_LOG.name))  # fmt: skip
    return {k: sum(st["launches"][k] for st in records["steps"]) for k in counters()}, ev["launches"]


def shapenet(torch, dev):
    """Phase 17: ShapeNet part segmentation at full width on the card."""
    from lattice_net_tpu_torch.data.synth_shapenet import write_benchmark_dir

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        root = write_benchmark_dir(Path(tmp, "shapenet"), SHAPENET_SCENES["train"], SHAPENET_SCENES["test"],
                                   SHAPENET_POINTS)  # fmt: skip
        emit(dict(shapenet_dir=SHAPENET_SCENES, points=SHAPENET_POINTS, seconds=time.perf_counter() - t0))
        train_launches, eval_launches, per_scan = shapenet_full_width(torch, dev, root, tmp)
        step_kernels, steps, per_step = shapenet_step(torch, dev, root)
        log_train, log_eval = shapenet_log_run(torch, dev, tmp, per_scan)
    train = {k: train_launches[k] + steps[k] + log_train[k] for k in train_launches}
    return dict(train=train, eval={k: eval_launches[k] + log_eval[k] for k in train}, per_step=per_step,
                step=step_kernels)  # fmt: skip


# ---------------------------------------------------------------------------
# phase 18: the rest of the single-card surface
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def main_path(totals, where, key="phase18_path"):
    """Counts the kernel launches of one drive of a phase-18 (20, 21) path:
    every count set to 0 just before, read just after, added to ``totals``;
    the block gets the dict of this drive's counts, filled on exit."""
    import torch

    got = {}
    zero_counts()
    yield got
    torch.cuda.synchronize()
    got.update(read_counts())
    for k in totals:
        totals[k] += got[k]
    emit({key: where, "launches": got})


def remat_recomputed_k1(model):
    """K1 launches the backward of a ``remat_blocks`` step adds: the
    recomputed forward of each conv inside a Resnet or Bottleneck block."""
    from lattice_net_tpu_torch.nn.modules import BottleneckBlock, ConvIm2Row, ResnetBlock

    blocks = [b for b in model.modules() if isinstance(b, (ResnetBlock, BottleneckBlock))]
    return sum(isinstance(m, ConvIm2Row) for b in blocks for m in b.modules())


def canonical_serving(torch, dev, totals):
    """Phase 18a: bench.py's ``LNT_CANONICAL=1`` program at full width."""
    import numpy as np

    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.lattice.host_order import canonical_point_order_np
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy, canonical_point_order
    from lattice_net_tpu_torch.models.lnn import LNN, ModelParams

    model = LNN(ModelParams(**BENCH_MODEL), torch.Generator().manual_seed(0), device=dev).eval()
    nl = model.params.nr_downsamples
    pos_np = np.asarray(make_scene(BENCH_POINTS, seed=0).V, np.float32)
    pos = torch.from_numpy(pos_np).to(dev)
    vals = torch.zeros((BENCH_POINTS, 1), device=dev)

    def build_default():
        return build_hierarchy(pos, BENCH_SIGMA, nl, BENCH_CAPS, point_feats=vals)

    def build_canonical():
        perm = canonical_point_order(pos, BENCH_SIGMA)
        return perm, build_hierarchy(pos[perm], BENCH_SIGMA, nl, BENCH_CAPS, canonical_points=True)

    def serve_canonical():
        perm, h = build_canonical()
        logp, _ = model(h, pos[perm], vals[perm])
        return torch.empty_like(perm).scatter_(0, perm, logp.argmax(-1)), perm, h

    with torch.inference_mode():
        with main_path(totals, "18a canonical serving") as got:
            pred_c, perm, h_c = serve_canonical()
        want = dict(k1=patch_gathers_per_scan(model), k1b=0, k2=1, k2b=0, k3=0, k4=1)
        check(got == want, f"canonical serving: launches {got}, expected {want}")
        # the default path on the points as the canonical program sees them
        # (equal by design: the same edge sort), and on the input order, where
        # the local mean's f32 prefix sum over the edge stream rounds by the
        # edge order (JAX's own two programs disagree too: the CPU tests pin
        # that), so it is held to a floor
        pos_c, vals_c = pos[perm], vals[perm]
        h_d = build_hierarchy(pos_c, BENCH_SIGMA, nl, BENCH_CAPS, point_feats=vals_c)
        pred_d = torch.empty_like(perm).scatter_(0, perm, model(h_d, pos_c, vals_c)[0].argmax(-1))
        agree = (pred_c == pred_d).float().mean().item()
        pred_in = model(build_default(), pos, vals)[0].argmax(-1)
        agree_input_order = (pred_c == pred_in).float().mean().item()
        for a, b in zip(h_c.structures, h_d.structures):
            check(torch.equal(a.keys, b.keys), f"canonical build: level {a.lvl} keys differ")
        edges_equal = all(torch.equal(getattr(h_c.edges, f), getattr(h_d.edges, f)) for f in ("perm", "vertex", "ends"))
        host = torch.from_numpy(canonical_point_order_np(pos_np, BENCH_SIGMA).astype(np.int64))
        host_share = (host == perm.cpu()).float().mean().item()
        ms_default = time_ms(torch, build_default, iters=5, warmup=1)
        ms_canonical = time_ms(torch, build_canonical, iters=5, warmup=1)
    row = dict(check="canonical serving (bench.py LNT_CANONICAL=1) vs the default path", points=BENCH_POINTS,
               capacities=list(BENCH_CAPS), occupancy=[int(s.nr_verts) for s in h_c.structures],
               label_agreement=agree, tolerance=SERVE_TOL["label_agreement"], edge_sort_equal=edges_equal,
               label_agreement_input_order=agree_input_order, input_order_floor=CANONICAL_INPUT_ORDER_FLOOR,
               build_ms_default=ms_default,
               build_ms_canonical=ms_canonical, host_order_equal_share=host_share, launches=got)  # fmt: skip
    emit(row)
    check(agree >= SERVE_TOL["label_agreement"], f"canonical labels vs default {agree}")
    check(agree_input_order >= CANONICAL_INPUT_ORDER_FLOOR,
          f"canonical labels vs default on the input order {agree_input_order}")  # fmt: skip
    check(edges_equal, "the fast build's edge sort differs from the default build's")
    with recording_kernel_inputs(torch) as (calls, _), torch.inference_mode():
        serve_canonical()
    k1 = check_k1(torch, calls["k1"], dev, "canonical serving")
    check_k2(torch, calls["k2"][0], "canonical serving", dev)
    k4 = check_k4(torch, calls["k4"][0], "canonical serving: the distribute's row gather")
    return k1, k4


def scannet_remat(torch, dev, totals, caps_auto):
    """Phase 18b: the probe's ScanNet-scale train step with and without
    ``remat_blocks``, and one step at phase 16's auto capacities both ways."""
    import dataclasses
    import types

    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe
    from lattice_net_tpu_torch.models.lnn import LNN, prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import make_batch, make_loss_fn
    from lattice_net_tpu_torch.train.setup import TrainSetup

    torch.cuda.empty_cache()
    with main_path(totals, "18b probe --train-step at 2^21"):
        rec, _ = captured(torch, probe.run, SCANNET_POINTS, probe.TABLE_CAP, iters=4, device=dev, train_step=True)
    for r in rec["train_step"]:
        emit(dict(check="ScanNet-scale train step (probe --train-step)", capacities=rec["capacities"],
                  model_params=rec["model_params"], **r))  # fmt: skip
    remat = rec["train_step"][0]
    check(remat["remat"] and remat["fits"], f"the remat step at 2^21 does not fit: {remat}")
    check(all(math.isfinite(x) for x in remat["losses"]), f"remat step losses {remat['losses']}")
    torch.cuda.empty_cache()

    run = TrainSetup.from_config(SCANNET_TRAIN_CONFIG, 21, 1, device=dev, capacities=caps_auto)
    V, C, L = probe.make_indoor_scene(SCANNET_POINTS, seed=1)
    cloud = prepare_cloud(types.SimpleNamespace(V=V, C=C, L_gt=L), run.model.params)
    batch = make_batch([cloud], SCANNET_STEP_BUDGET, device=dev)
    params = {k: v.detach() for k, v in run.model.state_dict().items()}
    # in f32 convs remat is the only difference; in bf16 two steps with the
    # kernels also differ by K1-bwd's atomics rounded into bf16 cotangents, so
    # the bf16 step without remat runs twice and that reading is the control
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        runs = (False, True, "control") if dtype == torch.bfloat16 else (False, True)
        for run_name in runs:
            flag = run_name is True
            mp = dataclasses.replace(run.model.params, remat_blocks=flag)
            model = LNN(mp, torch.Generator(), device=dev, conv_dtype=dtype)
            model.load_state_dict(params)
            check(list(model.state_dict()) == list(params), "remat changes the state_dict keys")
            loss_fn = make_loss_fn(model, run.sigma, mp.nr_downsamples, run.capacities)
            torch.cuda.reset_peak_memory_stats()
            where = f"18b ScanNet step at auto caps, remat_blocks={flag}, {dtype}"
            if run_name == "control":
                where += ", again"
            with main_path(totals, where) as got:
                out[run_name] = loss_and_grads(torch, loss_fn, params, batch)
            want = launches_per_step(model, segvjp=False)
            want["k1"] += remat_recomputed_k1(model) if flag else 0
            check(got == want, f"{where}: launches {got}, expected {want}")
            emit(dict(scannet_step_at_auto_caps=list(run.capacities), remat_blocks=flag, convs=str(dtype),
                      run=str(run_name), loss=out[run_name][0], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                      launches=got))  # fmt: skip
            del model
        gap = abs(out[True][0] - out[False][0])
        worst, name = worst_rel_l2(torch, out[True][1], out[False][1])
        tol = TRAIN_PLAIN_GRAD_REL
        row = dict(check=f"ScanNet step with vs without remat_blocks, {dtype} convs", loss_gap=gap,
                   loss_tol=LOSS_ATOL, worst_grad_rel_l2=worst, worst_param=name)  # fmt: skip
        if "control" in out:
            control, control_name = worst_rel_l2(torch, out["control"][1], out[False][1])
            tol = max(TRAIN_PLAIN_GRAD_REL, REMAT_CONTROL_MARGIN * control)
            row.update(control_worst_grad_rel_l2=control, control_worst_param=control_name,
                       control_loss_gap=abs(out["control"][0] - out[False][0]))  # fmt: skip
        emit(dict(row, grad_tol=tol))
        compare_grads(torch, out[True][1], out[False][1], tol, f"remat vs no remat, {dtype} convs")
        check(gap <= LOSS_ATOL, f"remat vs no remat, {dtype} convs: loss gap {gap}")
    return rec


def trainer_opt_ins(torch, dev, totals):
    """Phase 18c: the training CLI with ``LNT_CANONICAL_TRAIN=1`` and
    ``model.remat_blocks=true``."""
    import os

    from lattice_net_tpu_torch.config import apply_overrides, load_config
    from lattice_net_tpu_torch.train.setup import TrainSetup

    overrides = [f"loader_synth_kitti.nr_samples={TRAINER_SCENES['train']}",
                 f"loader_synth_kitti.nr_samples_test={TRAINER_SCENES['test']}", "model.remat_blocks=true"]  # fmt: skip
    run = TrainSetup.from_config(apply_overrides(load_config(SYNTH_CONFIG), overrides), NR_CLASSES, 1, device=dev)
    check(run.model.params.remat_blocks, "model.remat_blocks=true did not reach the model")
    # the canonical build carries no rows: the distribute gathers them (K4)
    per_step = launches_per_step(run.model, segvjp=False)
    per_step.update(k1=per_step["k1"] + remat_recomputed_k1(run.model), k4=1)
    per_test = dict(k1=patch_gathers_per_scan(run.model), k1b=0, k2=1, k2b=0, k3=0, k4=1)
    del run
    records = dict(steps=[], epochs=[])
    with tempfile.TemporaryDirectory() as tmp, environ(LNT_SCENE_CACHE=os.path.join(tmp, "scenes"),
                                                       LNT_CANONICAL_TRAIN="1"):  # fmt: skip
        t0 = time.perf_counter()
        _, text = trainer_run(torch, str(SYNTH_CONFIG), records, max_epochs=1,
                              overrides=overrides + [f"train.checkpoint_path={tmp}/ckpt"])  # fmt: skip
        seconds = time.perf_counter() - t0
    check("LNT_CANONICAL_TRAIN=1" in text, "the trainer did not take the canonical order")
    for st in records["steps"]:
        want = per_step if st["phase"] == "train" else per_test
        check(st["launches"] == want, f"opt-in trainer {st['phase']}: launches {st['launches']}, expected {want}")
        check(math.isfinite(st["loss"]), f"opt-in trainer {st['phase']}: loss {st['loss']}")
        for k in totals:
            totals[k] += st["launches"][k]
    for e in records["epochs"]:
        emit(dict(opt_in_trainer=e["phase"], **e))
    emit(dict(check="trainer with LNT_CANONICAL_TRAIN=1, model.remat_blocks=true", seconds=seconds,
              forwards=len(records["steps"]), per_train_step=per_step, per_test_forward=per_test))  # fmt: skip


def lattice_library(torch, dev, totals):
    """Phase 18d: the lattice library and the module zoo at KITTI scale,
    each against its plain path on the card."""
    import numpy as np

    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.lattice import ops
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy
    from lattice_net_tpu_torch.nn import modules as lnm

    pos = torch.from_numpy(np.asarray(make_scene(BENCH_POINTS, seed=2).V, np.float32)).to(dev)
    h = build_hierarchy(pos, BENCH_SIGMA, 1, LIB_CAPS)
    cap = LIB_CAPS[0]
    nbr, mask = h.neighbors_same[0], h.structures[0].occupancy_mask()
    gen = torch.Generator(device=dev).manual_seed(3)
    vals = torch.randn((BENCH_POINTS, LIB_C), generator=gen, device=dev)
    lv = torch.randn((cap, LIB_C), generator=gen, device=dev)
    depth_w = torch.randn((9, LIB_C), generator=gen, device=dev)
    g = torch.Generator().manual_seed(4)
    blocks = dict(
        GnReluCoarsen=(lnm.GnReluCoarsen(LIB_C, LIB_C, g), (h.neighbors_coarsen[0], mask, h.neighbors_finefy[0])),
        ConvAct=(lnm.ConvAct(LIB_C, LIB_C, g, use_bias=True), (nbr,)),
        TwoConv=(lnm.TwoConv(LIB_C, g), (nbr, mask)),
        ResnetBlock2=(lnm.ResnetBlock2(LIB_C, g), (nbr, mask)),
        DensenetBlock=(lnm.DensenetBlock(LIB_C, g), (nbr, mask)),
        GnReluDepthwiseConv=(lnm.GnReluDepthwiseConv(LIB_C, g), (nbr, mask)),
    )  # fmt: skip
    for mod, _ in blocks.values():
        mod.to(dev)

    def library(plain):
        """Every op and block once: the forward outputs of the ops with a
        kernel and of the blocks, the gradients of a fixed probe's dot with
        each block's output, and the outputs of the two ops without a kernel
        (splat, segment_max_with_src: no plain switch, held against the CPU)."""
        splatted = ops.splat(vals, h.splat_idx, h.splat_weights, cap)
        blurred = ops.bilateral_blur(splatted, nbr, plain=plain)
        no_kernel = dict(
            splat=splatted,
            segment_max=ops.segment_max_with_src(vals.repeat_interleave(4, 0), h.splat_idx.reshape(-1), cap)[0],
        )
        outs = dict(
            bilateral_blur=blurred,
            slice_lattice=ops.slice_lattice(blurred, h.splat_idx, h.splat_weights, plain=plain),
            gather_lattice=ops.gather_lattice(lv, h.splat_idx, h.splat_weights, plain=plain),
            depthwise_conv=ops.depthwise_conv(lv, nbr, depth_w, plain=plain),
        )  # fmt: skip
        grads = {}
        for name, (mod, args) in blocks.items():
            x = lv.clone().requires_grad_()
            y = mod(x, *args, plain=plain)
            probe = torch.randn(y.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
            outs[name] = y.detach()
            gs = torch.autograd.grad((y * probe).sum(), [x, *mod.parameters()])
            grads[name] = dict(zip(["input", *[k for k, _ in mod.named_parameters()]], gs))
        return outs, grads, no_kernel

    with main_path(totals, "18d lattice library and blocks"):
        outs, grads, no_kernel = library(plain=False)
    outs_p, grads_p, _ = library(plain=True)
    for name, y in outs.items():
        err = (y.float() - outs_p[name].float()).abs().max().item()
        emit(dict(check=f"18d {name} vs plain", shape=list(y.shape), max_abs_err=err, tol=SERVE_TOL["logp_max_abs"]))
        check(math.isfinite(err) and err <= SERVE_TOL["logp_max_abs"], f"18d {name}: forward off by {err}")
    for name in blocks:
        compare_grads(torch, grads[name], grads_p[name], TRAIN_PLAIN_GRAD_REL, f"18d {name} gradients")
    # BatchNormLattice in training and in evaluation
    bn = lnm.BatchNormLattice(LIB_C).to(dev)
    y_train = bn(lv, mask)
    occ = lv[: int(h.structures[0].nr_verts)]
    check(torch.allclose(bn.mean, 0.1 * occ.mean(0), atol=1e-5), "BatchNormLattice running mean")
    y_eval = bn(lv, mask, use_running_average=True)
    check(all_finite(torch, [y_train, y_eval]), "BatchNormLattice outputs")
    # the ops without a kernel against the CPU; expand without noise (the
    # CPU's structure) and the splatting mask
    rows_cpu = vals.cpu().repeat_interleave(4, 0)
    for name, got, want in (
        ("splat", no_kernel["splat"], ops.splat(vals.cpu(), h.splat_idx.cpu(), h.splat_weights.cpu(), cap)),
        ("segment_max", no_kernel["segment_max"],
         ops.segment_max_with_src(rows_cpu, h.splat_idx.cpu().reshape(-1), cap)[0]),
    ):  # fmt: skip
        err = (got.cpu() - want).abs().max().item()
        emit(dict(check=f"18d {name} on the card vs the CPU", max_abs_err=err, tol=SERVE_TOL["logp_max_abs"]))
        check(err <= SERVE_TOL["logp_max_abs"], f"18d {name} vs the CPU: {err}")
    with main_path(totals, "18d expand and create_splatting_mask"):
        s_e, vid_e, _ = ops.expand(pos, BENCH_SIGMA, 2 * cap, 1, 0.0, gen)
        keep = ops.create_splatting_mask(gen, h.splat_idx, 4, cap)
    s_cpu, vid_cpu, _ = ops.expand(pos.cpu(), BENCH_SIGMA, 2 * cap, 1, 0.0, torch.Generator())
    check(torch.equal(s_e.keys.cpu(), s_cpu.keys) and torch.equal(vid_e.cpu(), vid_cpu), "expand vs the CPU")
    counts = ops.segment_sum(torch.ones((h.splat_idx.numel(), 1), device=dev), h.splat_idx.reshape(-1), cap)[:, 0]
    sure = (h.splat_idx < cap) & (counts[h.splat_idx.clamp(max=cap - 1).long()] <= 4)
    check(bool(((h.splat_idx < cap) | ~keep).all() & (keep | ~sure).all()),
          "create_splatting_mask: an invalid edge kept or a sure edge dropped")  # fmt: skip
    emit(dict(check="18d create_splatting_mask", kept=int(keep.sum()), valid=int((h.splat_idx < cap).sum()),
              sure=int(sure.sum())))  # fmt: skip
    # the same tables by the re-splat coarse level
    other = build_hierarchy(pos, BENCH_SIGMA, 1, LIB_CAPS, coarse_mode="resplat")
    same = all(torch.equal(a, b) for name in ("neighbors_same", "neighbors_coarsen", "neighbors_finefy")
               for a, b in zip(getattr(h, name), getattr(other, name)))  # fmt: skip
    occ_same = [int(s.nr_verts) for s in other.structures] == [int(s.nr_verts) for s in h.structures]
    emit(dict(check="18d build with coarse_mode=resplat vs the default", tables_bit_equal=same,
              occupancy_equal=occ_same, occupancy=[int(s.nr_verts) for s in other.structures]))  # fmt: skip
    check(same and occ_same, "18d coarse_mode=resplat: tables or occupancy differ from the default build")
    with recording_kernel_inputs(torch) as (calls, _):
        library(plain=False)
    return check_k1(torch, calls["k1"], dev, "lattice library"), calls


def phase18(torch, dev, caps_auto):
    """Phase 18: runs 18a-d; returns the launches of their main paths and
    the rows of their kernel checks."""
    totals = dict.fromkeys(counters(), 0)
    t0 = time.perf_counter()
    k1_canonical, k4_canonical = canonical_serving(torch, dev, totals)
    probe = scannet_remat(torch, dev, totals, caps_auto)
    trainer_opt_ins(torch, dev, totals)
    k1_library, _ = lattice_library(torch, dev, totals)
    emit(dict(phase=18, seconds=time.perf_counter() - t0, launches=totals))
    return dict(launches=totals, k1_canonical=k1_canonical, k4_canonical=k4_canonical, k1_library=k1_library,
                probe=probe)  # fmt: skip


# ---------------------------------------------------------------------------
# phase 19: data and lattice parallelism over torch.distributed
# ---------------------------------------------------------------------------

P19_POINTS = 1 << 17
P19_SEEDS = (0, 1)  # the KITTI scans of phase 19 (make_scene seeds): the DP and hybrid batches
P19_DP_STEPS = 2
# DP vs the single-card steps on the same 2-scan batch, f32 convs: the JAX
# package's dry run claims its parameters to 1e-5 (MULTICHIP_r05.json, on the
# CPU).  On the card the DP step's pmean adds the two scans' gradients in
# another order than the single card's backward, and K1-bwd's atomics add in
# another order each run; AdamW divides each gradient entry by its own
# magnitude, so an entry near the optimizer's eps moves by a sizeable share of
# lr on that rounding alone.  So the DP step's gradients are held against the
# single card's (P19_GRAD_REL, as the CPU tests hold the port against JAX),
# the parameters after two steps of plain SGD (P19_SGD_LR: linear in the
# gradients) to P19_PARAM_ATOL, and AdamW replayed on the card over the DP
# step's own gradients must give the DP parameters bit for bit; the AdamW gap
# to the single card is printed beside the single card's own gap between two
# runs, with the gradients of its worst entry.  The kernels' sharded, hybrid
# and ScanNet steps are held against their plain versions on the same
# stripes at P19_GRAD_REL too: in f32 convs only the atomics' order differs
P19_PARAM_ATOL = 1e-5
P19_GRAD_REL = 1e-4
P19_SGD_LR = 0.01
# the hybrid step's loss vs the count-weighted mean of the per-cloud sharded
# losses (the JAX package's test_hybrid_dp_sp_matches_per_cloud_sharded)
P19_LOSS_RTOL = 1e-5
# sharded / single-card gradient norm, the CPU test's bounds: the per-stripe
# Lovász half and the stripes' edge order move it a little (0.9993 on the
# card); a psum counted twice would make it n-fold, 2 at sp = 2
P19_GRAD_RATIO = (0.8, 1.25)
# The sharded forward against the single-card forward of the same scan:
# each stripe's local-mean prefix sum runs over another edge stream, so
# PointNet's near-tied max-pool winners flip.  On a KITTI scan the JAX
# package's own sharded forward misses its gates (median error 1e-3, 5% of
# points beyond 2e-3, labels 0.995) against its single-device forward
# (tests/test_torch_lattice_sharded.py pins it; ROADMAP §3), so the labels
# (and ln_eval --sp 2's against the unsharded eval) are held at the floor of
# the same order effect, CANONICAL_INPUT_ORDER_FLOOR, the JAX gates'
# numbers printed beside; the sharded kernels are held against their plain
# version on the same stripes (SERVE_TOL).  The witness that tells that order
# effect from a fault of the halo exchange or of the owner masks: each
# stripe's forward again, in threads of this process, on its own and its
# neighbours' band points gathered on the host in the exchange's layout, with
# the owner masks made here and the GroupNorm moments summed across the
# threads in stripe order; the ranks' log-probabilities must equal it on the
# owned points to P19_WITNESS_ATOL (the same build and kernels on the same
# points in the same order, the same order of addition: bit-equal expected)
P19_SINGLE_CARD_FLOOR = CANONICAL_INPUT_ORDER_FLOOR
P19_WITNESS_ATOL = 1e-5
SYNTH_EVAL_CONFIG = ROOT / "config" / "lnn_eval_synthkitti.cfg"
P19_TIMEOUT_S = 600  # a collective that waits longer fails its rank, and the launch


def p19_cloud(seed):
    """(positions, values, target) numpy of one 2^17-point KITTI scan."""
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import ModelParams, prepare_cloud

    return prepare_cloud(make_scene(P19_POINTS, seed=seed), ModelParams(values_mode="none"))


def p19_setup(device, dtype_name="float32"):
    """The KITTI train config's model (seeded weights, ``dtype_name`` convs)."""
    import torch

    from lattice_net_tpu_torch.train.setup import TrainSetup

    dtype = getattr(torch, dtype_name)
    return TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=device, conv_dtype=dtype,
                                  seed=0)  # fmt: skip


def p19_row(ids, world, axes, shape):
    """The ranks of this rank's row along ``axes`` of a mesh of ``shape``,
    in their order (the plain counterpart of ``Mesh``'s groups)."""
    import numpy as np

    grid = np.arange(world).reshape(shape)
    at = list(np.unravel_index(ids, shape))
    for a in axes:
        at[a] = slice(None)
    return grid[tuple(at)].reshape(-1).tolist()


def p19_collectives(device, meshes):
    """19a in one rank: every collective of each mesh and its gradient,
    against plain sums (in rank order) and shifts of the same blocks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lattice_net_tpu_torch.parallel.mesh import Mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(world)
    xs = torch.tensor(rng.normal(size=(world, 4096, 8)), dtype=torch.float32, device=device)
    cts = torch.tensor(rng.normal(size=(world, 4096, 8)), dtype=torch.float32, device=device)
    out = []
    for names, shape in meshes:
        mesh = Mesh(names, shape)
        combos = [(a,) for a in range(len(names))] + ([tuple(range(len(names)))] if len(names) > 1 else [])
        for axes in combos:
            row = p19_row(rank, world, axes, shape)
            i = row.index(rank)
            cases = [("psum", 0), ("pmean", 0)] + ([("shift", 1), ("shift", -1)] if len(axes) == 1 else [])
            for op, off in cases:
                x = xs[rank].clone().requires_grad_()
                axis_names = tuple(names[a] for a in axes)
                if op == "shift":
                    y = mesh.shift(x, axis_names[0], off)
                    src, dst = i - off, i + off
                    want = xs[row[src]] if 0 <= src < len(row) else torch.zeros_like(x)
                    want_g = cts[row[dst]] if 0 <= dst < len(row) else torch.zeros_like(x)
                else:
                    y = getattr(mesh, op)(x, axis_names)
                    want, want_g = xs[row[0]], cts[row[0]]
                    for r in row[1:]:
                        want, want_g = want + xs[r], want_g + cts[r]
                    if op == "pmean":
                        want, want_g = want / len(row), want_g / len(row)
                (g,) = torch.autograd.grad(y, x, cts[rank])
                out.append(dict(mesh="x".join(map(str, shape)), axes="+".join(axis_names), op=f"{op}{off or ''}",
                                value_equal=bool(torch.equal(y, want)), grad_equal=bool(torch.equal(g, want_g))))
    return out


def p19_timed(torch, fn):
    """(result, ms, launches) of one drive of ``fn``, its counts set to 0
    just before and read just after."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, read_counts()


def p19_sharded(device, sp):
    """19b in one rank: the KITTI model's sharded forward at ``sp`` stripes
    (the band check first; approximate where it raises), its plain version,
    and at sp = 2 one sharded step on each scan of ``P19_SEEDS``."""
    import numpy as np
    import torch

    from lattice_net_tpu_torch.parallel import lattice_sharded as ls
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.parallel.mesh import Mesh
    from lattice_net_tpu_torch.train.optim import CapturingOptimizer

    run = p19_setup(device)
    model, sigma, caps = run.model, run.sigma, run.capacities
    nr = model.params.nr_downsamples
    mesh = Mesh(("sp",), (sp,))
    params = dict(model.state_dict())
    p, v, t = p19_cloud(P19_SEEDS[0])
    pos_s, val_s, mask_s, ids_s, bounds = ls.shard_points_host(p, v, sigma, sp)
    per = pos_s.shape[1]
    try:
        ls.make_sharded_lnn_forward(mesh, model, sigma, nr, caps, per)(params, pos_s, val_s, mask_s, bounds)
        band_error = ""
    except ValueError as exc:
        band_error = str(exc)
    fwd = ls.make_sharded_lnn_forward(mesh, model, sigma, nr, caps, per, check_band=not band_error)
    fwd(params, pos_s, val_s, mask_s, bounds)  # first call: the libraries load
    (logp, nv, ov), ms, launches = p19_timed(torch, lambda: fwd(params, pos_s, val_s, mask_s, bounds))
    plain, _, _ = fwd(params, pos_s, val_s, mask_s, bounds, plain=True)
    i = mesh.rank
    valid = torch.from_numpy(ids_s[i] >= 0).to(device)
    out = dict(
        sp=sp, band_error=band_error, ids=ids_s[i], logp=logp, nr_verts=nv, overflow=ov, ms=ms, launches=launches,
        plain_max_abs=(logp - plain)[valid].abs().max(),
        plain_agreement=(logp.argmax(1) == plain.argmax(1))[valid].float().mean(),
        halo_points_a_direction=per, halo_shift_bytes=2 * sp * per * (3 + v.shape[1] + 1) * 4,
    )  # fmt: skip
    if sp != 2:
        return out
    steps = []
    for seed in P19_SEEDS:
        p, v, t = p19_cloud(seed)
        pos_s, val_s, mask_s, ids_s, bounds = ls.shard_points_host(p, v, sigma, sp)
        tgt_s = np.where(ids_s >= 0, t[np.clip(ids_s, 0, None)], -1).astype(np.int32)
        tx = CapturingOptimizer(run.tx)
        step = ls.make_sharded_lnn_train_step(mesh, model, tx, sigma, nr, caps, per)
        state = TrainState.create(params, tx)
        drive = lambda: step(state, pos_s, val_s, tgt_s, mask_s, bounds)  # noqa: E731
        (_, metrics), step_ms, step_launches = p19_timed(torch, drive)
        row = dict(seed=seed, loss=metrics["loss"], valid=int((t != -1).sum()), overflow=metrics["overflow"],
                   ms=step_ms, launches=step_launches, grads=tx.grads[-1])  # fmt: skip
        if seed == P19_SEEDS[0]:  # K1-bwd and K2-bwd against plain at the stripe shapes
            step(state, pos_s, val_s, tgt_s, mask_s, bounds, plain=True)
            row["plain_grads"] = tx.grads[-1]
        steps.append(row)
    out["steps"] = steps
    return out


class P19Sgd:
    """Plain SGD in the optimizer interface the steps call (``init``,
    ``update``, ``wants_value``): its update is linear in the gradients."""

    wants_value = False

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params, value=None):
        return {k: -self.lr * grads[k] for k in params}, {"count": state["count"] + 1}


def p19_dp_steps(device, tx, steps):
    """``steps`` data-parallel steps with ``tx`` over the scans of
    ``P19_SEEDS``, one a rank: each step's loss, ms and launches, and the
    final parameters, checked bit-equal across the ranks."""
    import numpy as np
    import torch

    from lattice_net_tpu_torch.parallel import data_parallel as dp
    from lattice_net_tpu_torch.parallel.mesh import Mesh, check_replicated

    run = p19_setup(device)
    mesh = Mesh(("dp",), (len(P19_SEEDS),))
    host = dp.make_host_batch([p19_cloud(s) for s in P19_SEEDS], P19_POINTS, rng=np.random.default_rng(0))
    state = dp.replicate_state(dp.TrainState.create(dict(run.model.state_dict()), tx))
    step = dp.make_dp_train_step(run.model, tx, mesh, run.sigma, run.model.params.nr_downsamples, run.capacities)
    batch = dp.shard_batch(host, mesh, "dp", device)
    gen = dp.rank_generator(0, mesh.rank, device)
    rows = []
    for _ in range(steps):
        (state, metrics), ms, launches = p19_timed(torch, lambda: step(state, batch, gen))
        rows.append(dict(loss=metrics["loss"], ms=ms, launches=launches))
    check_replicated(state.params)
    return rows, state.params


def p19_dp(device):
    """19c in one rank: ``P19_DP_STEPS`` DP steps with the train config's
    AdamW (each step's averaged gradients kept), then as many with plain
    SGD."""
    from lattice_net_tpu_torch.train.optim import CapturingOptimizer

    tx = CapturingOptimizer(p19_setup(device).tx)
    rows, params = p19_dp_steps(device, tx, P19_DP_STEPS)
    sgd_rows, sgd_params = p19_dp_steps(device, P19Sgd(P19_SGD_LR), P19_DP_STEPS)
    return dict(steps=rows + sgd_rows, params=params, grads=tx.grads, sgd_params=sgd_params)


def p19_scannet(device, caps):
    """19d in one rank: the ScanNet model at full width in f32 convs on one
    400k-point room striped over 2 ranks at the auto capacities: forward and
    one train step, with their launches, ms and this rank's peak memory, and
    each against its plain version on the same stripe."""
    import types

    import numpy as np
    import torch

    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.parallel import lattice_sharded as ls
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.parallel.mesh import Mesh
    from lattice_net_tpu_torch.train.optim import CapturingOptimizer
    from lattice_net_tpu_torch.train.setup import TrainSetup

    torch.cuda.empty_cache()
    run = TrainSetup.from_config(SCANNET_TRAIN_CONFIG, 21, 1, device=device, capacities=caps,
                                 conv_dtype=torch.float32)  # fmt: skip
    model, sigma = run.model, run.sigma
    nr = model.params.nr_downsamples
    V, C, L = probe.make_indoor_scene(SCANNET_POINTS, seed=1)
    p, v, t = prepare_cloud(types.SimpleNamespace(V=V, C=C, L_gt=L), model.params)
    mesh = Mesh(("sp",), (2,))
    pos_s, val_s, mask_s, ids_s, bounds = ls.shard_points_host(p, v, sigma, 2)
    tgt_s = np.where(ids_s >= 0, t[np.clip(ids_s, 0, None)], -1).astype(np.int32)
    per = pos_s.shape[1]
    params = dict(model.state_dict())
    fwd = ls.make_sharded_lnn_forward(mesh, model, sigma, nr, run.capacities, per)
    torch.cuda.reset_peak_memory_stats()
    fwd(params, pos_s, val_s, mask_s, bounds)  # first call
    (logp, nv, ov), fwd_ms, fwd_launches = p19_timed(torch, lambda: fwd(params, pos_s, val_s, mask_s, bounds))
    plain, _, _ = fwd(params, pos_s, val_s, mask_s, bounds, plain=True)
    valid = torch.from_numpy(ids_s[mesh.rank] >= 0).to(device)
    tx = CapturingOptimizer(run.tx)
    step = ls.make_sharded_lnn_train_step(mesh, model, tx, sigma, nr, run.capacities, per)
    state = TrainState.create(params, tx)
    (_, metrics), step_ms, step_launches = p19_timed(torch, lambda: step(state, pos_s, val_s, tgt_s, mask_s, bounds))
    grads = tx.grads[-1]
    step(state, pos_s, val_s, tgt_s, mask_s, bounds, plain=True)
    grad_worst, grad_name = worst_rel_l2(torch, grads, tx.grads[-1])
    return dict(
        capacities=list(run.capacities), per=per, nr_verts=int(nv), overflow=int(ov), fwd_ms=fwd_ms,
        fwd_launches=fwd_launches, step_ms=step_ms, step_launches=step_launches, loss=float(metrics["loss"]),
        step_overflow=int(metrics["overflow"]), owned_level0=float(metrics["nr_verts_mean"]),
        finite=bool(torch.isfinite(logp).all()), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        plain_max_abs=float((logp - plain)[valid].abs().max()),
        plain_agreement=float((logp.argmax(1) == plain.argmax(1))[valid].float().mean()),
        plain_grad_worst_rel_l2=grad_worst, plain_grad_worst_param=grad_name,
        expected_fwd=dict(k1=patch_gathers_per_scan(model), k1b=0, k2=1, k2b=0, k3=0, k4=0),
        expected_step=launches_per_step(model, segvjp=False),
    )  # fmt: skip


def p19_hybrid(device):
    """19c in one rank: one hybrid dp2 x sp2 step over the scans of
    ``P19_SEEDS``, and its plain version from the same state."""
    import torch

    from lattice_net_tpu_torch.parallel import lattice_sharded as ls
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.parallel.mesh import Mesh
    from lattice_net_tpu_torch.train.optim import CapturingOptimizer

    run = p19_setup(device)
    mesh = Mesh(("dp", "sp"), (2, 2))
    pos_b, val_b, tgt_b, mask_b, _, bounds_b = ls.shard_clouds_host([p19_cloud(s) for s in P19_SEEDS], run.sigma, 2)
    tx = CapturingOptimizer(run.tx)
    step = ls.make_hybrid_lnn_train_step(mesh, run.model, tx, run.sigma, run.model.params.nr_downsamples,
                                         run.capacities, pos_b.shape[2])  # fmt: skip
    state = TrainState.create(dict(run.model.state_dict()), tx)
    (new, metrics), ms, launches = p19_timed(torch, lambda: step(state, pos_b, val_b, tgt_b, mask_b, bounds_b))
    grads = tx.grads[-1]
    step(state, pos_b, val_b, tgt_b, mask_b, bounds_b, plain=True)
    return dict(loss=metrics["loss"], overflow=metrics["overflow"], ms=ms, launches=launches, grads=grads,
                plain_grads=tx.grads[-1], finite=all(bool(torch.isfinite(x).all()) for x in new.params.values()))


def p19_two_ranks(device, scannet_caps):
    """The 2-rank launch: 19a, 19b at sp = 2, 19c's DP steps, 19d."""
    import torch

    out = dict(collectives=p19_collectives(device, [(("sp",), (2,))]))
    out["sharded"] = p19_sharded(device, 2)
    out["dp"] = p19_dp(device)
    out["scannet"] = p19_scannet(device, scannet_caps)
    out["card"] = torch.cuda.get_device_name(device)
    return out


def p19_four_ranks(device):
    """The 4-rank launch: 19a at 4 and 2x2, 19b at sp = 4, 19c's hybrid step."""
    out = dict(collectives=p19_collectives(device, [(("sp",), (4,)), (("dp", "sp"), (2, 2))]))
    out["sharded"] = p19_sharded(device, 4)
    out["hybrid"] = p19_hybrid(device)
    return out


def p19_nccl(device):
    """19f in one rank: the DP step at the world's size against the
    single-card step from the same state on the same scan, and the
    single-card step again as the control.  The caller sets
    ``LNT_HEAD_SEGVJP=1``: its head adjoint (K3) adds in a fixed order,
    where K1-bwd's atomics add in another order each run."""
    import torch
    import torch.distributed as dist

    from lattice_net_tpu_torch.parallel import data_parallel as dp
    from lattice_net_tpu_torch.parallel.mesh import Mesh

    run = p19_setup(device)
    mesh = Mesh(("dp",), (dist.get_world_size(),))
    clouds = [p19_cloud(P19_SEEDS[0])] * mesh.world
    host = dp.make_host_batch(clouds, P19_POINTS)
    state = dp.replicate_state(dp.TrainState.create(dict(run.model.state_dict()), run.tx))
    nr = run.model.params.nr_downsamples
    single = dp.make_train_step(run.model, run.tx, run.sigma, nr, run.capacities)
    one = dp.to_device({k: v[:1] for k, v in host.items()}, device)
    a, ma = single(state, one)
    b, mb = single(state, one)
    step = dp.make_dp_train_step(run.model, run.tx, mesh, run.sigma, nr, run.capacities)
    (c, mc), ms, launches = p19_timed(torch, lambda: step(state, dp.shard_batch(host, mesh, "dp", device)))
    same = lambda x, y: all(torch.equal(x.params[k], y.params[k]) for k in x.params)  # noqa: E731
    return dict(world=mesh.world, control_bit_equal=same(a, b), dp_bit_equal=same(a, c),
                loss_equal=bool(torch.equal(ma["loss"], mc["loss"])), ms=ms, launches=launches)


class P19ThreadMesh:
    """The plain counterpart of a one-axis ``Mesh`` over threads of this
    process, one a stripe: ``psum`` adds every thread's tensor in thread
    order, as ``Mesh.psum`` adds the ranks' in rank order, behind a barrier.
    All threads launch on the card's default stream, so a sum reads the
    others' tensors after they are written."""

    def __init__(self, n):
        import threading

        self.n, self.slots, self.local = n, [None] * n, threading.local()
        self.barrier = threading.Barrier(n, timeout=P19_TIMEOUT_S)

    def size(self, axes):
        return self.n

    def psum(self, x, axes):
        self.slots[self.local.index] = x
        self.barrier.wait()
        y = self.slots[0]
        for j in range(1, self.n):
            y = y + self.slots[j]
        self.barrier.wait()  # every thread has read the slots before the next psum writes them
        return y


def p19_stripe_rows(pos_s, val_s, mask_s, s, bounds, band, i):
    """Stripe ``i``'s own rows, then the left neighbour's right band and the
    right neighbour's left band, each padded with zero rows to the stripe's
    length (the halo budget): the sharded forward's point layout, from the
    host's stripes (``s``: each slot's first elevated coordinate)."""
    import numpy as np

    n = len(mask_s)
    feat = np.concatenate([pos_s, val_s, mask_s[..., None].astype(np.float32)], -1)
    parts = [feat[i]]
    for j, bound, right_band in ((i - 1, bounds[i], True), (i + 1, bounds[i + 1], False)):
        rows = np.zeros_like(feat[i])
        if 0 <= j < n:
            edge = np.float32(bound) - np.float32(band) if right_band else np.float32(bound) + np.float32(band)
            sel = mask_s[j] & ((s[j] >= edge) if right_band else (s[j] < edge))
            picked = feat[j][sel]
            rows[: len(picked)] = picked
        parts.append(rows)
    return np.concatenate(parts)


def p19_witness(torch, model, sigma, nr, caps, p, v, sp):
    """The stripes' forwards at ``sp`` stripes, one thread each (see
    ``P19_WITNESS_ATOL``): each stripe's log-probabilities on its own slots."""
    import concurrent.futures

    import numpy as np

    from lattice_net_tpu_torch.lattice.structure import build_hierarchy
    from lattice_net_tpu_torch.nn.modules import norm_stats_distributed
    from lattice_net_tpu_torch.parallel import lattice_sharded as ls

    pos_s, val_s, mask_s, _, bounds = ls.shard_points_host(p, v, sigma, sp)
    s = ls.elev0_np(pos_s.reshape(-1, pos_s.shape[-1]), sigma).reshape(mask_s.shape)
    band = ls.receptive_band_units(model.params, pos_s.shape[-1])
    dev = next(model.parameters()).device
    mesh = P19ThreadMesh(sp)

    def stripe(i):
        mesh.local.index = i
        try:
            feat = torch.from_numpy(p19_stripe_rows(pos_s, val_s, mask_s, s, bounds, band, i)).to(dev)
            pos, val, mask = feat[:, :3], feat[:, 3:-1], feat[:, -1] > 0.5
            with torch.no_grad():
                h = build_hierarchy(pos, sigma, nr, caps, point_mask=mask, point_feats=val)
                own = {}
                lo, hi = float(bounds[i]), float(bounds[i + 1])
                for lvl, st in enumerate(h.structures):  # a vertex is its stripe's by key[0] * 2^l
                    key0 = st.keys[:, 0].to(torch.float32) * float(1 << lvl)
                    own[st.capacity] = (key0 >= lo) & (key0 < hi) & st.occupancy_mask()
                with norm_stats_distributed(mesh, "sp", own):
                    logp = model(h, pos, val, train=False)[0]
            return logp[: pos_s.shape[1]].cpu().numpy()
        except BaseException:
            mesh.barrier.abort()  # the other threads stop waiting for this one
            raise

    with concurrent.futures.ThreadPoolExecutor(sp) as pool:
        return [f.result() for f in [pool.submit(stripe, i) for i in range(sp)]]


def p19_tensors(torch, tree):
    return {k: torch.as_tensor(g) for k, g in tree.items()}


def p19_collectives_check(rows, what):
    bad = [r for r in rows if not (r["value_equal"] and r["grad_equal"])]
    emit(dict(phase19a=what, cases=len(rows), all_equal=not bad))
    check(rows and not bad, f"19a {what}: collectives differ from plain sums/shifts: {bad[:3]}")


def p19_add(totals, launches):
    for k in totals:
        totals[k] += launches[k]


def phase19(torch, dev, scannet_caps):
    """Phase 19: data and lattice parallelism on the card; returns the
    launches of the main paths (19b-d, 19f), summed over the ranks."""
    import numpy as np

    from lattice_net_tpu_torch.lattice.structure import build_hierarchy
    from lattice_net_tpu_torch.parallel import data_parallel as dp
    from lattice_net_tpu_torch.parallel.mesh import launch, plan_ranks
    from lattice_net_tpu_torch.train.optim import EPS, CapturingOptimizer

    t_phase = time.perf_counter()
    totals = dict.fromkeys(counters(), 0)
    torch.cuda.empty_cache()
    # the single-card references, f32 convs
    run = p19_setup(dev)
    model, sigma, caps = run.model, run.sigma, run.capacities
    nr = model.params.nr_downsamples
    params = dict(model.state_dict())
    expected_fwd = dict(k1=patch_gathers_per_scan(model), k1b=0, k2=1, k2b=0, k3=0, k4=0)
    expected_step = launches_per_step(model, segvjp=False)
    p, v, t = p19_cloud(P19_SEEDS[0])
    pt, vt = torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)

    def single_forward():
        with torch.no_grad():
            h = build_hierarchy(pt, sigma, nr, caps, point_feats=vt)
            return model(h, pt, vt, train=False)[0]

    single_forward()
    ref, single_fwd_ms, _ = p19_timed(torch, single_forward)
    ref = ref.cpu().numpy()
    batch1 = dp.make_batch([(p, v, t)], P19_POINTS, device=dev)
    loss_fn = dp.make_loss_fn(model, sigma, nr, caps)
    (ref_loss, ref_grads), single_step_ms, _ = p19_timed(torch, lambda: loss_and_grads(torch, loss_fn, params, batch1))
    host2 = dp.make_host_batch([p19_cloud(s) for s in P19_SEEDS], P19_POINTS, rng=np.random.default_rng(0))
    batch2 = dp.to_device(host2, dev)
    _, grads2 = loss_and_grads(torch, loss_fn, params, batch2)  # the first step's gradients
    single_states, single_losses = [], []
    single_tx = CapturingOptimizer(run.tx)
    for tx in (single_tx, run.tx, P19Sgd(P19_SGD_LR)):  # AdamW twice: the control of the run-to-run gap
        single = dp.make_train_step(model, tx, sigma, nr, caps)
        state = dp.TrainState.create(params, tx)
        for _ in range(P19_DP_STEPS):
            (state, m), single2_ms, _ = p19_timed(torch, lambda: single(state, batch2))
            single_losses.append(float(m["loss"]))
        single_states.append(state)
    state = single_states[0]
    occupancy = int(build_hierarchy(pt, sigma, nr, caps).structures[0].nr_verts)
    emit(dict(phase19_single_card=dict(forward_ms=single_fwd_ms, step_ms=single_step_ms, batch2_step_ms=single2_ms,
                                       loss=ref_loss, batch2_losses=single_losses, occupancy_level0=occupancy)))

    # 19a-d on the card: 2 and 4 ranks sharing it over gloo
    t0 = time.perf_counter()
    two = launch(p19_two_ranks, scannet_caps, ranks=plan_ranks(2, dev, "gloo"), timeout_s=P19_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = launch(p19_four_ranks, ranks=plan_ranks(4, dev, "gloo"), timeout_s=P19_TIMEOUT_S)
    four_s = time.perf_counter() - t0
    emit(dict(phase19_launch_seconds=dict(two_ranks=two_s, four_ranks=four_s), card=two[0]["card"]))
    for r, out in enumerate(two):
        p19_collectives_check(out["collectives"], f"2 ranks, rank {r}")
    for r, out in enumerate(four):
        p19_collectives_check(out["collectives"], f"4 ranks, rank {r}")

    # 19b: the sharded forward against its plain version and the single card
    for sp, ranks in ((2, two), (4, four)):
        got = np.zeros_like(ref)
        for r, out in enumerate(ranks):
            s = out["sharded"]
            valid = s["ids"] >= 0
            got[s["ids"][valid]] = s["logp"][valid]
            emit(dict(phase19b=f"sharded forward sp={sp}, rank {r}", nr_verts=int(s["nr_verts"]),
                      overflow=int(s["overflow"]), ms=s["ms"], launches=s["launches"],
                      plain_max_abs=float(s["plain_max_abs"]), plain_agreement=float(s["plain_agreement"]),
                      halo_points_a_direction=s["halo_points_a_direction"],
                      halo_shift_bytes=s["halo_shift_bytes"], band_check=s["band_error"] or "passed"))  # fmt: skip
            check(int(s["overflow"]) == 0, f"sp={sp} rank {r}: overflow {int(s['overflow'])}")
            check(s["launches"] == expected_fwd, f"sp={sp} rank {r}: launches {s['launches']}, expected {expected_fwd}")
            check(float(s["plain_max_abs"]) <= SERVE_TOL["logp_max_abs"]
                  and float(s["plain_agreement"]) >= SERVE_TOL["label_agreement"],
                  f"sp={sp} rank {r}: kernels vs plain {float(s['plain_max_abs'])}, {float(s['plain_agreement'])}")
            p19_add(totals, s["launches"])
        check(bool(ranks[0]["sharded"]["band_error"]) == (sp == 4),
              f"sp={sp}: band check {ranks[0]['sharded']['band_error'] or 'passed'}")
        t0 = time.perf_counter()
        witness = p19_witness(torch, model, sigma, nr, caps, p, v, sp)
        for r, out in enumerate(ranks):
            s, w = out["sharded"], witness[r]
            valid = s["ids"] >= 0
            w_abs = float(np.abs(np.asarray(s["logp"]) - w)[valid].max())
            w_agree = float((np.asarray(s["logp"]).argmax(1) == w.argmax(1))[valid].mean())
            emit(dict(phase19b=f"sharded forward sp={sp}, rank {r}, vs its stripe's forward in a thread",
                      max_abs=w_abs, label_agreement=w_agree, tol=P19_WITNESS_ATOL,
                      seconds=time.perf_counter() - t0))  # fmt: skip
            check(w_abs <= P19_WITNESS_ATOL and w_agree >= SERVE_TOL["label_agreement"],
                  f"sp={sp} rank {r}: the sharded forward is {w_abs} from its stripe's witness ({w_agree})")
        err = np.abs(got - ref).max(axis=1)
        agree = float((got.argmax(1) == ref.argmax(1)).mean())
        emit(dict(phase19b=f"sharded vs single-card forward, sp={sp}", median_abs=float(np.median(err)),
                  share_over_2e3=float((err > 2e-3).mean()), label_agreement=agree,
                  jax_gates=dict(median_abs=1e-3, share_over_2e3=0.05, label_agreement=0.995),
                  floor=P19_SINGLE_CARD_FLOOR))  # fmt: skip
        check(agree >= P19_SINGLE_CARD_FLOOR, f"sp={sp}: labels vs the single card {agree}")
    steps = [out["sharded"]["steps"] for out in two]
    for r, rank_steps in enumerate(steps):
        for st in rank_steps:
            check(st["launches"] == expected_step, f"sharded step rank {r}: launches {st['launches']}")
            check(int(st["overflow"]) == 0, f"sharded step rank {r}: overflow {int(st['overflow'])}")
            p19_add(totals, st["launches"])
    grads = steps[0][0]["grads"]
    check(all(np.array_equal(grads[k], steps[1][0]["grads"][k]) for k in grads), "the ranks' sharded gradients differ")
    for r, rank_steps in enumerate(steps):
        plain_worst, plain_name = worst_rel_l2(torch, p19_tensors(torch, rank_steps[0]["grads"]),
                                               p19_tensors(torch, rank_steps[0]["plain_grads"]))  # fmt: skip
        emit(dict(phase19b=f"sharded train step sp=2, rank {r}, kernels vs plain on the same stripes",
                  grad_worst_rel_l2=plain_worst, grad_worst_param=plain_name, tol=P19_GRAD_REL))  # fmt: skip
        check(plain_worst <= P19_GRAD_REL, f"sharded step rank {r}: kernels' gradient of {plain_name} {plain_worst}"
                                           " from the plain step's")  # fmt: skip
    worst, name = worst_rel_l2(torch, p19_tensors(torch, grads), ref_grads)
    norm = lambda gs: math.sqrt(sum(float((torch.as_tensor(g).double() ** 2).sum()) for g in gs))  # noqa: E731
    ratio = norm(grads.values()) / norm(ref_grads.values())
    loss_sp = float(steps[0][0]["loss"])
    emit(dict(phase19b="sharded train step sp=2 vs the single card", loss=loss_sp, single_card_loss=ref_loss,
              grad_norm_ratio=ratio, worst_grad_rel_l2=worst, worst_param=name, ms=[s["ms"] for s in steps[0]],
              single_card_step_ms=single_step_ms, ratio_bounds=P19_GRAD_RATIO))  # fmt: skip
    check(P19_GRAD_RATIO[0] < ratio < P19_GRAD_RATIO[1] and math.isfinite(loss_sp), f"sharded gradient ratio {ratio}")

    # 19c: DP against the single card, then the hybrid step
    def param_gap(got, want):
        return max(float(np.abs(np.asarray(got[k]) - want[k].cpu().numpy()).max()) for k in want)

    def replay(grads_by_step):  # the train config's AdamW over given gradients, from the initial state
        state = dp.TrainState.create(params, run.tx)
        for g in grads_by_step:
            state = dp.apply_update(run.tx, state, {k: torch.as_tensor(x).to(dev) for k, x in g.items()})
        return state.params

    def worst_entry(got, want):  # (parameter, flat index) of the largest |got - want|
        k = max(want, key=lambda k: float(np.abs(np.asarray(got[k]) - want[k].cpu().numpy()).max()))
        return k, int(np.abs(np.asarray(got[k]) - want[k].cpu().numpy()).argmax())

    control = param_gap({k: v.cpu().numpy() for k, v in single_states[1].params.items()}, single_states[0].params)
    for r, out in enumerate(two):
        d = out["dp"]
        for st in d["steps"]:
            check(st["launches"] == expected_step, f"DP rank {r}: launches {st['launches']}")
            p19_add(totals, st["launches"])
        grad_worst, grad_name = worst_rel_l2(torch, p19_tensors(torch, d["grads"][0]), grads2)
        replayed = replay(d["grads"])
        replay_equal = all(np.array_equal(np.asarray(d["params"][k]), replayed[k].cpu().numpy()) for k in replayed)
        adamw_gap = param_gap(d["params"], single_states[0].params)
        dp1 = {k: x.cpu().numpy() for k, x in replay(d["grads"][:1]).items()}  # after the first step
        single1 = replay(single_tx.grads[:1])
        at1, flat1 = worst_entry(dp1, single1)
        adamw_step1 = dict(param_max_abs=param_gap(dp1, single1), param=at1, index=flat1,
                           dp_grad=float(np.asarray(d["grads"][0][at1]).reshape(-1)[flat1]),
                           single_card_grad=float(single_tx.grads[0][at1].reshape(-1)[flat1]))  # fmt: skip
        at, flat = worst_entry(d["params"], single_states[0].params)
        adamw_worst = dict(param=at, index=flat, adamw_eps=EPS,
                           dp_grads=[float(np.asarray(g[at]).reshape(-1)[flat]) for g in d["grads"]],
                           single_card_grads=[float(g[at].reshape(-1)[flat]) for g in single_tx.grads])  # fmt: skip
        sgd_gap = param_gap(d["sgd_params"], single_states[2].params)
        emit(dict(phase19c=f"DP rank {r} vs the single card on the same 2-scan batch", grad_worst_rel_l2=grad_worst,
                  grad_worst_param=grad_name, grad_tol=P19_GRAD_REL, sgd_param_max_abs=sgd_gap,
                  sgd_tol=P19_PARAM_ATOL, adamw_param_max_abs=adamw_gap,
                  adamw_single_card_run_to_run_max_abs=control, adamw_worst_entry=adamw_worst,
                  adamw_first_step=adamw_step1, adamw_replay_bit_equal=replay_equal,
                  losses=[float(s["loss"]) for s in d["steps"]], single_card_losses=single_losses,
                  ms=[s["ms"] for s in d["steps"]], single_card_ms=single2_ms))  # fmt: skip
        check(grad_worst <= P19_GRAD_REL, f"DP rank {r}: gradient of {grad_name} {grad_worst} from the single card's")
        check(sgd_gap <= P19_PARAM_ATOL, f"DP rank {r}: SGD parameters {sgd_gap} from the single card's")
        check(replay_equal, f"DP rank {r}: AdamW over the DP step's own gradients differs from its parameters")
    # the hybrid loss is the count-weighted mean of the per-scan sharded losses, its gradients the
    # count-weighted mean of theirs
    per_cloud = [(float(st["loss"]), st["valid"]) for st in steps[0]]
    total = sum(c for _, c in per_cloud)
    want = sum(l * c for l, c in per_cloud) / total
    want_grads = {k: sum(torch.as_tensor(st["grads"][k]).double() * st["valid"] for st in steps[0]) / total
                  for k in grads}  # fmt: skip
    for r, out in enumerate(four):
        h = out["hybrid"]
        check(h["launches"] == expected_step, f"hybrid rank {r}: launches {h['launches']}")
        p19_add(totals, h["launches"])
        got = p19_tensors(torch, h["grads"])
        plain_worst, plain_name = worst_rel_l2(torch, got, p19_tensors(torch, h["plain_grads"]))
        cloud_worst, cloud_name = worst_rel_l2(torch, got, want_grads)
        emit(dict(phase19c=f"hybrid dp2 x sp2 step, rank {r}", loss=float(h["loss"]), per_cloud_sharded=want,
                  overflow=int(h["overflow"]), ms=h["ms"], plain_grad_worst_rel_l2=plain_worst,
                  plain_grad_worst_param=plain_name, per_cloud_grad_worst_rel_l2=cloud_worst,
                  per_cloud_grad_worst_param=cloud_name, grad_tol=P19_GRAD_REL))  # fmt: skip
        check(h["finite"] and int(h["overflow"]) == 0, f"hybrid rank {r}: finite {h['finite']}, overflow")
        check(abs(float(h["loss"]) - want) <= P19_LOSS_RTOL * abs(want), f"hybrid loss {float(h['loss'])} vs {want}")
        check(plain_worst <= P19_GRAD_REL, f"hybrid rank {r}: kernels' gradient of {plain_name} {plain_worst} off")
        check(cloud_worst <= P19_GRAD_REL, f"hybrid rank {r}: gradient of {cloud_name} {cloud_worst} from the "
                                           "per-scan sharded steps'")  # fmt: skip

    # 19d: ScanNet at full width, sp = 2
    for r, out in enumerate(two):
        s = out["scannet"]
        emit(dict(phase19d=f"ScanNet room striped over 2 ranks, rank {r}", **{k: v for k, v in s.items()
                                                                              if not k.startswith("expected")}))
        check(s["overflow"] == 0 and s["step_overflow"] == 0 and s["finite"], f"19d rank {r}: overflow or non-finite")
        check(s["plain_max_abs"] <= SERVE_TOL["logp_max_abs"]
              and s["plain_agreement"] >= SERVE_TOL["label_agreement"],
              f"19d rank {r}: forward vs plain {s['plain_max_abs']}, {s['plain_agreement']}")  # fmt: skip
        check(s["plain_grad_worst_rel_l2"] <= P19_GRAD_REL,
              f"19d rank {r}: kernels' gradient of {s['plain_grad_worst_param']} {s['plain_grad_worst_rel_l2']} off")
        check(s["fwd_launches"] == s["expected_fwd"] and s["step_launches"] == s["expected_step"],
              f"19d rank {r}: launches {s['fwd_launches']} / {s['step_launches']}")
        p19_add(totals, s["fwd_launches"])
        p19_add(totals, s["step_launches"])

    # 19f: NCCL at the card count; with two cards or more, 19c's DP steps too
    with environ(LNT_HEAD_SEGVJP="1"):
        nccl = launch(p19_nccl, ranks=plan_ranks(None, dev, "nccl"), timeout_s=P19_TIMEOUT_S)
    for r, out in enumerate(nccl):
        emit(dict(phase19f=f"NCCL, {out['world']} ranks, rank {r}", **out))
        check(out["dp_bit_equal"] and out["loss_equal"], f"19f rank {r}: the DP step differs from the single card")
        p19_add(totals, out["launches"])
    if torch.cuda.device_count() >= 2:
        for r, out in enumerate(launch(p19_dp, ranks=plan_ranks(2, dev, "nccl"))):
            gap = param_gap(out["sgd_params"], single_states[2].params)
            emit(dict(phase19f=f"DP over NCCL, rank {r}, vs the single card", sgd_param_max_abs=gap))
            check(gap <= P19_PARAM_ATOL, f"DP over NCCL rank {r}: SGD parameters {gap} from the single card's")
            for st in out["steps"]:
                p19_add(totals, st["launches"])
    else:
        emit(dict(phase19f="19c's DP steps over NCCL need two cards: not run, this host has one"))
    del run, model, state, single_states, batch1, batch2
    torch.cuda.empty_cache()

    # 19e: the CLIs
    cli = p19_clis(torch, dev)
    emit(dict(phase=19, seconds=time.perf_counter() - t_phase, launches=totals, clis=cli))
    return dict(launches=totals)


def p19_clis(torch, dev):
    """19e: ``ln_train --dp`` and ``--sp 2`` for one epoch of phase 14's cut
    of ``SYNTH_CONFIG``, then ``ln_eval --sp 2`` on 3 scans from the DP
    run's checkpoint against the unsharded eval."""
    import os

    import numpy as np

    from lattice_net_tpu_torch.train import ln_eval, ln_train

    out = {}
    with tempfile.TemporaryDirectory() as tmp, environ(LNT_SCENE_CACHE=os.path.join(tmp, "scenes")):
        scenes = [f"loader_synth_kitti.nr_samples={TRAINER_SCENES['train']}",
                  f"loader_synth_kitti.nr_samples_test={TRAINER_SCENES['test']}"]  # fmt: skip
        for name, kw, steps in (("dp", dict(dp=True, ranks=2), TRAINER_SCENES["train"] // 2),
                                ("sp", dict(sp=2), TRAINER_SCENES["train"])):  # fmt: skip
            t0 = time.perf_counter()
            overrides = scenes + [f"train.checkpoint_path={tmp}/{name}"]
            state = ln_train.run(str(SYNTH_CONFIG), max_epochs=1, overrides=overrides, backend="gloo", **kw)
            out[name] = dict(seconds=time.perf_counter() - t0, steps=state.step)
            check(state.step == steps, f"ln_train --{name}: {state.step} steps, expected {steps}")
            check(all(bool(torch.isfinite(x).all()) for x in state.params.values()), f"ln_train --{name}: non-finite")
            check(Path(tmp, name, "last.ckpt").exists(), f"ln_train --{name}: no last.ckpt")
        ev = ["loader_synth_kitti.classes=20", "loader_synth_kitti.nr_samples_test=3"]
        labels = {}
        for sp in (0, 2):
            t0 = time.perf_counter()
            miou = ln_eval.run(str(SYNTH_EVAL_CONFIG), f"{tmp}/dp/last.ckpt", True,
                               ev + [f"eval.output_predictions_path={tmp}/pred{sp}"], sp=sp, device=dev,
                               backend="gloo" if sp else None)  # fmt: skip
            files = sorted(Path(tmp, f"pred{sp}").glob("pred_*.txt"))
            labels[sp] = np.concatenate([np.loadtxt(f, dtype=np.int64) for f in files])
            out[f"eval_sp{sp}"] = dict(seconds=time.perf_counter() - t0, miou=miou, files=len(files))
        agree = float((labels[2] == labels[0]).mean())
        out["eval_label_agreement"] = agree
        check(out["eval_sp2"]["files"] == 3 and agree >= P19_SINGLE_CARD_FLOOR, f"ln_eval --sp 2 vs unsharded: {agree}")
    return out


# ---------------------------------------------------------------------------
# phase 20: lattices of d > 3, the plain-gather switch, the batched build, the tools
# ---------------------------------------------------------------------------

P20_POINTS = 1 << 17
P20_SCANS = 3  # the d = 4 scans served (make_scene seeds 0-2)
P20_D4 = ["model.positions_mode=xyz+intensity"]  # SemanticKITTI's velodyne records
P20_D6 = ["model.positions_mode=xyz+rgb"]  # ScanNet's coloured points
P20_AUTO = ["lattice_gpu.capacity_mode=auto", "lattice_gpu.capacity_headroom=1.5"]
# kernels vs plain gradients of one step in f32 convs (only K1-bwd's and
# K2-bwd's order of addition differs)
P20_GRAD_REL = 1e-4
P20_TIMED_STEPS = 3  # steps a side of the LNT_FAST_OPS A/B
P20_BATCHES = (1, 8, 16)
P20_PROFILE_POINTS = 1 << 17  # the KITTI profilers' scan


def p20_cfg(path, overrides):
    from lattice_net_tpu_torch.config import apply_overrides, load_config

    return apply_overrides(load_config(path), overrides)


def p20_scout(torch, dev, cfg, mp, clouds):
    """The config's schedule scouted on ``clouds`` (capacity_mode auto,
    headroom 1.5), as the trainer scouts it."""
    from lattice_net_tpu_torch.config import LatticeParams
    from lattice_net_tpu_torch.train.setup import capacities_from_config

    return capacities_from_config(LatticeParams.from_config(cfg), mp, clouds=[c[0] for c in clouds], device=dev)


def p20_one_call_a_shape():
    """A ``keep_k1`` filter that records the first K1 call of each distinct
    (table rows, K, C, dtype, centre, role) only."""
    seen = set()

    def keep(values, neighbors, include_center, row0):
        key = (tuple(values.shape), tuple(neighbors.shape), values.dtype, include_center, row0)
        if key in seen:
            return False
        seen.add(key)
        return True

    return keep


def p20_kernels_on_a_step(torch, run, batch, dev, where, all_k1=True):
    """K1, K2, K1-bwd and K2-bwd against their plain versions on the inputs
    of one train step (all K1 calls, or one a shape), timed with their byte
    bounds; returns the four sums."""
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState, forward_loss, gradients

    state = TrainState.create(run.model.state_dict(), run.tx)
    with recording_kernel_inputs(torch, None if all_k1 else p20_one_call_a_shape()) as (calls, phase):
        leaves, loss, _ = forward_loss(run.loss_fn(), state.params, batch)
        phase[0] = "backward"
        gradients(loss, leaves)
    k1 = check_k1(torch, calls["k1"], dev, where + ("" if all_k1 else ", one call a shape"))
    for key in ("k2", "k1b", "k2b"):
        check(len(calls[key]) == 1, f"{where}: {len(calls[key])} {key} calls, expected 1")
    k2 = check_k2(torch, calls["k2"][0], where, dev)
    k1b = check_k1b(torch, calls["k1b"][0], calls["k1"], dev, where)
    k2b = check_k2b(torch, calls["k2b"][0], dev, where)
    return k1, k2, k1b, k2b


def p20_grads_vs_plain(torch, cfg, nr_classes, caps, batch, dev, where):
    """One step's loss and gradients with the kernels against the plain
    versions, f32 convs; returns the kernels' (loss, grads)."""
    from lattice_net_tpu_torch.train.setup import TrainSetup

    run = TrainSetup.from_config(cfg, nr_classes, 1, device=dev, conv_dtype=torch.float32, seed=0, capacities=caps)
    params = {k: v.detach() for k, v in run.model.state_dict().items()}
    loss_k, grads_k = loss_and_grads(torch, run.loss_fn(), params, batch)
    loss_p, grads_p = loss_and_grads(torch, run.loss_fn(), params, batch, plain=True)
    worst, name = compare_grads(torch, grads_k, grads_p, P20_GRAD_REL, f"{where}: kernels vs plain")
    emit(dict(check=f"{where}: one step, kernels vs plain, f32 convs", loss=loss_k, loss_abs_diff=abs(loss_k - loss_p),
              worst_grad_rel_l2=worst, worst_param=name, tolerance=P20_GRAD_REL))  # fmt: skip
    check(abs(loss_k - loss_p) <= LOSS_ATOL, f"{where}: loss {loss_k} vs plain {loss_p}")
    return loss_k, grads_k


def p20_want(model, blocks, step):
    """A forward's or a step's launches, K1 one a row block of each conv
    (``conv_blocks_recorded``) and one for the head."""
    if step:
        want = launches_per_step(model, segvjp=False)
    else:
        want = dict(k1=0, k1b=0, k2=1, k2b=0, k3=0, k4=0)
    return dict(want, k1=k1_launches_of(blocks) + 1)


def p20_train_steps(torch, run, batch, totals, where, steps=2):
    """``steps`` steps of ``make_train_step`` as a main path: launches per
    step, finite losses and parameters, no overflow."""
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState

    state = TrainState.create(run.model.state_dict(), run.tx)
    step = run.train_step()
    out = []
    for i in range(steps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        blocks = []
        with main_path(totals, f"{where}, step {i}", key="phase20_path") as got, conv_blocks_recorded(blocks):
            start.record()
            state, metrics = step(state, batch)
            stop.record()
        want = p20_want(run.model, blocks, step=True)
        out.append(dict(step_ms=start.elapsed_time(stop), loss=float(metrics["loss"]),
                        overflow=float(metrics["nr_overflow_mean"]), launches=got))  # fmt: skip
        emit(dict(phase20_step=where, step=i, **out[-1]))
        check(got == want, f"{where} step {i}: launches {got}, expected {want}")
        check(math.isfinite(out[-1]["loss"]) and out[-1]["overflow"] == 0, f"{where} step {i}: {out[-1]}")
        check(all_finite(torch, state.params.values()), f"{where} step {i}: non-finite parameters")
    return out


def p20_serve(torch, pred, clouds, totals, where):
    """Serves ``clouds`` through ``pred`` as a main path (15/1-style
    launches a scan, no overflow); then the first cloud with the kernels and
    with their plain versions.  Returns the kernels' labels of the first."""
    rows = []
    for i, (pos, vals, _) in enumerate(clouds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        blocks = []
        with main_path(totals, f"{where}, request {i}", key="phase20_path") as got, conv_blocks_recorded(blocks):
            start.record()
            logp, h = pred.forward(pos, vals)
            labels = logp.argmax(-1)[: len(pos)]
            stop.record()
        per_scan = p20_want(pred.model, blocks, step=False)
        rows.append(dict(request=i, latency_ms=start.elapsed_time(stop), occupancy=[int(s.nr_verts) for s in h.structures],
                         overflow=[int(s.nr_overflow) for s in h.structures], launches=got))  # fmt: skip
        emit(dict(phase20_serve=where, capacities=list(pred.capacities), **rows[-1]))
        check(got == per_scan, f"{where} request {i}: launches {got}, expected {per_scan}")
        check(sum(rows[-1]["overflow"]) == 0 and bool(torch.isfinite(logp).all()), f"{where} request {i}: {rows[-1]}")
        if i == 0:
            first = labels
    pos, vals, _ = clouds[0]
    logp_k, _ = pred.forward(pos, vals)
    with norm_on_its_kernel():
        logp_p, _ = pred.forward(pos, vals, plain=True)
    n = len(pos)
    agree = (logp_k[:n].argmax(-1) == logp_p[:n].argmax(-1)).float().mean().item()
    diff = (logp_k[:n] - logp_p[:n]).abs().max().item()
    emit(dict(check=f"{where}: served scan, kernels vs plain, bf16 convs", label_agreement=agree, logp_max_abs=diff,
              tolerance=SERVE_TOL, order_floor=CANONICAL_INPUT_ORDER_FLOOR))  # fmt: skip
    check(agree >= SERVE_TOL["label_agreement"] and diff <= SERVE_TOL["logp_max_abs"],
          f"{where}: kernels vs plain labels {agree}, log-probabilities {diff}")  # fmt: skip
    return first


def p20_d4(torch, dev, totals):
    """20a: the SemanticKITTI configs at d = 4 (xyz+intensity)."""
    from lattice_net_tpu_torch.config import model_params_from_config
    from lattice_net_tpu_torch.data.synth_kitti import make_scene
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import make_batch
    from lattice_net_tpu_torch.serve import Predictor
    from lattice_net_tpu_torch.train.setup import TrainSetup

    cfg_train = p20_cfg(TRAIN_CONFIG, P20_D4 + P20_AUTO)
    cfg_eval = p20_cfg(CONFIG, P20_D4)
    mp = model_params_from_config(cfg_train, NR_CLASSES)
    clouds = [prepare_cloud(make_scene(P20_POINTS, seed=s), mp) for s in range(P20_SCANS)]
    check(clouds[0][0].shape[1] == 4, f"d = 4 positions: {clouds[0][0].shape}")
    caps = p20_scout(torch, dev, p20_cfg(CONFIG, P20_D4 + P20_AUTO), mp, clouds)
    pred = Predictor.from_config(cfg_eval, NR_CLASSES, device=dev, seed=0, n_points=P20_POINTS)
    pred.capacities = caps
    p20_serve(torch, pred, clouds, totals, "20a d=4 serving")
    with recording_kernel_inputs(torch) as (calls, _), torch.inference_mode():
        pred.forward(*clouds[0][:2])
    serve_k1 = check_k1(torch, calls["k1"], dev, "20a d=4 served scan")
    serve_k2 = check_k2(torch, calls["k2"][0], "20a d=4 served scan", dev)
    del pred
    train_caps = p20_scout(torch, dev, cfg_train, mp, clouds[:1])
    run = TrainSetup.from_config(cfg_train, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, seed=0, capacities=train_caps)
    batch = make_batch([clouds[0]], P20_POINTS, device=dev)
    steps = p20_train_steps(torch, run, batch, totals, "20a d=4 train config")
    step_kernels = p20_kernels_on_a_step(torch, run, batch, dev, "20a d=4 train step")
    p20_grads_vs_plain(torch, cfg_train, NR_CLASSES, train_caps, batch, dev, "20a d=4")
    return dict(caps_serve=caps, caps_train=train_caps, serve_k1=serve_k1, serve_k2=serve_k2, step=step_kernels,
                steps=steps, run=run, batch=batch, cfg=cfg_train, clouds=clouds)  # fmt: skip


def p20_d6(torch, dev, totals):
    """20b: the ScanNet configs at d = 6 (xyz+rgb) on one synthetic room of
    ``P20_POINTS`` points (the config's 400000 cut in points)."""
    from lattice_net_tpu_torch.config import model_params_from_config
    from lattice_net_tpu_torch.data.scannet import ScanNet
    from lattice_net_tpu_torch.data.synth_scannet import write_scannet_dir
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.parallel.data_parallel import make_batch
    from lattice_net_tpu_torch.serve import Predictor
    from lattice_net_tpu_torch.train.setup import TrainSetup

    with tempfile.TemporaryDirectory() as tmp:
        write_scannet_dir(tmp, nr_train=1, nr_test=0, n_points=P20_POINTS)
        cloud = ScanNet(tmp, mode="train", max_nr_points_per_cloud=P20_POINTS, shuffle=False).get_cloud(0)
    cfg_train = p20_cfg(SCANNET_TRAIN_CONFIG, P20_D6 + P20_AUTO)
    mp = model_params_from_config(cfg_train, 21)
    prepared = prepare_cloud(cloud, mp)
    check(prepared[0].shape[1] == 6 and prepared[1].shape[1] == 4, f"d = 6 room: {prepared[0].shape}")
    caps = p20_scout(torch, dev, cfg_train, mp, [prepared])
    run = TrainSetup.from_config(cfg_train, 21, 1, device=dev, seed=0, capacities=caps)
    blocks = []
    with conv_blocks_recorded(blocks):
        pred = Predictor(run.model.eval(), run.sigma, caps, P20_POINTS, dev)
        p20_serve(torch, pred, [prepared], totals, "20b d=6 forward")
    chunked = sorted({(cq, e, c, nb) for cq, e, c, _, nb in blocks if nb > 1})
    run.model.train()
    batch = make_batch([prepared], P20_POINTS, device=dev)
    steps = p20_train_steps(torch, run, batch, totals, "20b d=6 ScanNet train config", steps=1)
    emit(dict(phase20_room="synth_scannet room, xyz+rgb", points=P20_POINTS, capacities=list(caps),
              params=sum(p.numel() for p in run.model.parameters()), row_chunked_convs=chunked,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))  # fmt: skip
    step_kernels = p20_kernels_on_a_step(torch, run, batch, dev, "20b d=6 ScanNet step", all_k1=False)
    p20_grads_vs_plain(torch, cfg_train, 21, caps, batch, dev, "20b d=6")
    return dict(caps=caps, step=step_kernels, steps=steps)


def p20_fast_ops(torch, dev, totals, d4):
    """20c: d = 4 steps with ``LNT_FAST_OPS=0`` against the usual."""
    from lattice_net_tpu_torch.lattice.ops import default_conv_dtype
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.train.setup import TrainSetup

    batch, caps = d4["batch"], d4["caps_train"]

    # the gathers take their plain route; the segment kernels stay
    def timed_steps(env, where):
        with environ(**env):
            r = TrainSetup.from_config(d4["cfg"], NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, seed=0, capacities=caps,
                                       conv_dtype=default_conv_dtype(dev))  # fmt: skip
            state = TrainState.create(r.model.state_dict(), r.tx)
            step = r.train_step()
            state, _ = step(state, batch)  # warm-up
            ms = []
            for i in range(P20_TIMED_STEPS):
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                with main_path(totals, f"{where}, step {i}", key="phase20_path") as got:
                    start.record()
                    state, metrics = step(state, batch)
                    stop.record()
                ms.append(start.elapsed_time(stop))
                check(math.isfinite(float(metrics["loss"])), f"{where}: loss")
        return got, ms, r

    got0, ms0, r0 = timed_steps(dict(LNT_FAST_OPS="0"), "20c LNT_FAST_OPS=0")
    got1, ms1, r1 = timed_steps({}, "20c default ops")
    emit(dict(check="20c LNT_FAST_OPS=0 vs the default, d=4 step", launches_fast_ops_0=got0, launches_default=got1,
              step_ms_fast_ops_0=ms0, step_ms_default=ms1, conv_dtype_fast_ops_0=str(r0.model.PointNetModule_0.ConvIm2Row_0.conv_dtype),
              conv_dtype_default=str(r1.model.PointNetModule_0.ConvIm2Row_0.conv_dtype)))  # fmt: skip
    check(got0 == dict(k1=0, k1b=0, k2=1, k2b=1, k3=0, k4=0), f"LNT_FAST_OPS=0 step launches {got0}")
    check(got1 == launches_per_step(r1.model, segvjp=False), f"default step launches {got1}")
    return dict(fast_ops_ms=(ms0, ms1))


def p20_batched(torch, dev, totals, d4):
    """20d: ``static_general_branches()`` builds bit-equal to the default
    ones (d = 4, and d = 3 where the simplex coarse levels are the fast
    path); ``batch_scaling_probe`` at ``P20_BATCHES``."""
    from lattice_net_tpu_torch.lattice.structure import build_hierarchy, static_general_branches
    from lattice_net_tpu_torch.misc import batch_scaling_probe
    from lattice_net_tpu_torch.misc.profile_build import hierarchy_tables

    run, batch, caps = d4["run"], d4["batch"], d4["caps_train"]
    nl = run.model.params.nr_downsamples
    pos4, mask = batch["positions"][0], batch["point_mask"][0]
    cases = [("d=4", pos4, run.sigma, caps), ("d=3", pos4[:, :3].contiguous(), run.sigma, (100000, 50000, 25000))]
    for label, pos, sigma, cps in cases:
        with torch.inference_mode():
            fast = build_hierarchy(pos, sigma, nl, cps, point_mask=mask)
            with static_general_branches():
                general = build_hierarchy(pos, sigma, nl, cps, point_mask=mask)
        equal = all(torch.equal(a, b) for a, b in zip(hierarchy_tables(fast), hierarchy_tables(general)))
        emit(dict(phase20_general=f"static_general_branches() vs the default build, {label}, 2^17 points",
                  bit_equal=equal, occupancy=[int(s.nr_verts) for s in general.structures]))  # fmt: skip
        check(equal, f"static_general_branches() {label}: the tables differ from the default build")
    with main_path(totals, "20d batch_scaling_probe", key="phase20_path"):
        probe, _ = captured(torch, batch_scaling_probe.run, P20_BATCHES, iters=5, device=dev)
    emit(dict(phase20_probe={b: r["clouds_per_s"] for b, r in probe["results"].items()}, **{
        k: v for k, v in probe.items() if k != "results"}))  # fmt: skip
    return probe


def p20_tools(torch, dev):
    """20e: each new tool once on the card at small settings (the profilers
    on their main configurations, ScanNet's step at auto capacities)."""
    from lattice_net_tpu_torch.misc import (
        compute_class_frequency,
        lnn_check_lattice_size,
        lnn_grad_check,
        lnn_make_teaser,
        profile_build,
        profile_forward,
        profile_train,
    )

    toy = str(ROOT / "config" / "ln_train_toy.cfg")
    out = {}
    grads, _ = captured(torch, lnn_grad_check.run_all, dev)
    out["lnn_grad_check"] = grads
    freq, _ = captured(torch, compute_class_frequency.run, toy, 3)
    check(abs(float(freq.sum()) - 1.0) < 1e-9, f"class frequencies sum to {freq.sum()}")
    sizes, _ = captured(torch, lnn_check_lattice_size.run, toy, device=dev)
    verts = [nv for _, nv, _ in sizes]
    check(len(sizes) == 5 and verts == sorted(verts, reverse=True) and verts[-1] > 0, f"lnn_check_lattice_size: {sizes}")
    with tempfile.TemporaryDirectory() as tmp:
        done, _ = captured(torch, lnn_make_teaser.run, toy, clouds=(0,), out=tmp, device=dev)
        check(len(list(Path(done[0][1]).iterdir())) == 5, "lnn_make_teaser: files")
    t0 = time.perf_counter()
    out["profile_train_kitti"] = captured(torch, profile_train.run, n_points=P20_PROFILE_POINTS, iters=5, device=dev)[0]
    out["profile_train_scannet"] = captured(torch, profile_train.run, SCANNET_TRAIN_CONFIG, SCANNET_POINTS,
                                            SCANNET_STEP_BUDGET, iters=5, overrides=P20_AUTO, device=dev)[0]  # fmt: skip
    out["profile_forward"] = captured(torch, profile_forward.run, n_points=P20_PROFILE_POINTS, iters=5, device=dev)[0]
    out["profile_build"] = captured(torch, profile_build.run, n_points=P20_PROFILE_POINTS, iters=5, device=dev)[0]
    emit(dict(phase20_tools="each tool once on the card", profilers_seconds=time.perf_counter() - t0,
              lnn_grad_check_max_abs=max(grads.values()), class_frequencies=[float(f) for f in freq],
              lattice_sizes=sizes))  # fmt: skip
    return out


def phase20(torch, dev):
    """Phase 20: runs 20a-e; returns the launches of their main paths and
    the rows of their kernel checks."""
    totals = dict.fromkeys(counters(), 0)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    d4 = p20_d4(torch, dev, totals)
    d6 = p20_d6(torch, dev, totals)
    fast_ops = p20_fast_ops(torch, dev, totals, d4)
    probe = p20_batched(torch, dev, totals, d4)
    tools = p20_tools(torch, dev)
    emit(dict(phase=20, seconds=time.perf_counter() - t0, launches=totals, caps_d4_serve=list(d4["caps_serve"]),
              caps_d4_train=list(d4["caps_train"]), caps_d6=list(d6["caps"])))  # fmt: skip
    return dict(launches=totals, d4=d4, d6=d6, fast_ops=fast_ops, probe=probe, tools=tools)


P21_POINTS = 1 << 14  # the census held against the CPU
P21_FULL_POINTS = 1 << 17  # hlo_census's default: the full-width census
P21_TRACE_RTOL = 0.02  # the trace's device total against the same capture's device_ms
P21_FLOAT_RTOL = 1e-5  # a cost-model row's float sums, card against CPU
P21_CPU_THREADS = "3"  # each background CPU census (two of them beside the card's work)


def p21_cpu_census(train):
    """Starts ``op_census --device cpu`` at ``P21_POINTS`` in a background
    process (the census patches module attributes, so it cannot share this
    process with the card's)."""
    import os

    cmd = [sys.executable, "-m", "lattice_net_tpu_torch.misc.op_census", "--device", "cpu",
           "--n-points", str(P21_POINTS)] + (["--train"] if train else [])  # fmt: skip
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=P21_CPU_THREADS)
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def p21_counts(census):
    """``{class: count}`` of a census (:func:`op_census.run`'s result)."""
    return {cls: row["count"] for cls, row in census["classes"].items()}


def p21_printed_counts(text):
    """``{class: count}`` from ``op_census``'s printed lines."""
    rows = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    return {r["class"]: r["count"] for r in rows if "class" in r}


def p21_census(torch, dev, totals):
    """21a-b: the census of the served scan and of a train step on the card
    at ``P21_POINTS`` and at ``P21_FULL_POINTS``, each run's kernel counts
    equal to the wrappers' launches."""
    from lattice_net_tpu_torch.misc import op_census

    out = {}
    for label in ("serve", "train"):
        for n in (P21_POINTS, P21_FULL_POINTS):
            with main_path(totals, f"21a census {label} {n} points", key="phase21_path"):
                census, _ = captured(torch, op_census.run, train=label == "train", n_points=n, device=dev)
            kernels = {c.split(":", 1)[1]: v for c, v in p21_counts(census).items() if c.startswith("kernel:")}
            check(kernels == {k: v for k, v in census["launches"].items() if v},
                  f"census {label} {n}: kernel counts {kernels} against launches {census['launches']}")  # fmt: skip
            out[(label, n)] = census
    for label in ("serve", "train"):
        census = out[(label, P21_FULL_POINTS)]
        emit(dict(phase21_census_full=f"{label}, {P21_FULL_POINTS} points, card: count, result MB",
                  total=census["total"], result_mb=census["result_bytes"] / 1e6,
                  param_tensors=census["setup"]["param_tensors"],
                  classes={c: [r["count"], r["result_bytes"] / 1e6] for c, r in census["classes"].items()},
                  top_functions=dict(list(census["functions"].items())[:20])))  # fmt: skip
    return out


def p21_against_cpu(census, procs):
    """21a: the CPU censuses (background processes) beside the card's at
    ``P21_POINTS``: every class side by side, the kernel and host-sync
    counts equal."""
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"the CPU census ({label}) failed:\n{stderr[-4000:]}")
        cpu, card = p21_printed_counts(stdout), p21_counts(census[(label, P21_POINTS)])
        classes = sorted(set(cpu) | set(card))
        emit(dict(phase21_census=f"{label}, {P21_POINTS} points: card / CPU counts",
                  classes={c: [card.get(c, 0), cpu.get(c, 0)] for c in classes}))  # fmt: skip
        for c in classes:
            if c.startswith("kernel:") or c == "host_sync":
                check(card.get(c, 0) == cpu.get(c, 0), f"census {label}: {c} {card.get(c, 0)} on the card, "
                      f"{cpu.get(c, 0)} on the CPU")  # fmt: skip
        census[(label, "cpu")] = cpu


def p21_trace(torch, dev, totals):
    """21c: ``profile_forward --trace DIR --trace-only`` on the KITTI eval
    config; ``parse_trace``'s device total of that file within
    ``P21_TRACE_RTOL`` of the same capture's ``device_ms``."""
    from lattice_net_tpu_torch.misc import parse_trace, profile_forward

    with tempfile.TemporaryDirectory() as tmp:
        with main_path(totals, "21c profile_forward --trace-only", key="phase21_path"):
            rows, _ = captured(torch, profile_forward.run, CONFIG, device=dev, trace=tmp, trace_only=True)
        summary = parse_trace.summarize(tmp, top=10)
    traced = rows[-1]
    gap = abs(summary["device_total_ms"] - traced["device_ms"]) / traced["device_ms"]
    emit(dict(phase21_trace="profile_forward --trace-only, KITTI eval config", calls=traced["calls"],
              wall_ms=traced["wall_ms"], device_ms=traced["device_ms"], idle_share=traced["idle_share"],
              trace_device_ms=summary["device_total_ms"], rel_gap=gap, lines=[ln["line"] for ln in summary["lines"]],
              top=[(t["name"][:60], t["calls"], t["ms"]) for ln in summary["lines"] for t in ln["top"][:5]]))  # fmt: skip
    check(gap <= P21_TRACE_RTOL, f"the trace's device total {summary['device_total_ms']} ms is {gap:.4f} "
          f"from the capture's {traced['device_ms']} ms")  # fmt: skip
    return dict(device_ms=traced["device_ms"], trace_device_ms=summary["device_total_ms"], rel_gap=gap)


def p21_prim_cost(torch, dev):
    """21d: ``prim_cost_chip`` at its defaults (M = 2^19); each row's output
    on the card against the CPU's on the same input."""
    from lattice_net_tpu_torch.misc import prim_cost_chip

    rows, _ = captured(torch, prim_cost_chip.run, device=dev)
    card, cpu = prim_cost_chip.outputs(dev), prim_cost_chip.outputs("cpu")
    for row in prim_cost_chip.ROWS:
        for g, w in zip(card[row.name], cpu[row.name]):
            if row.exact:
                check(torch.equal(g, w), f"cost-model row {row.name!r}: card and CPU differ")
            else:
                rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                check(rel <= P21_FLOAT_RTOL, f"cost-model row {row.name!r}: card and CPU {rel:.3g} apart")
    emit(dict(phase21_prim_cost="every row's output equal on card and CPU",
              marginal_ms={r["name"]: r["marginal_ms"] for r in rows[1:]}))  # fmt: skip
    return rows


def p21_cache(torch, dev):
    """21e: ``cache_key_probe --children 2``: equal keys, the second child
    builds nothing."""
    from lattice_net_tpu_torch.misc import cache_key_probe

    probe, _ = captured(torch, cache_key_probe.run, children=2, device=dev)
    check(probe["keys_agree"], "cache_key_probe: the two processes' keys differ")
    check(probe["later_children_built"] == [[]], f"cache_key_probe: the second process built {probe['later_children_built']}")
    check(len(probe["children"][0]["built"]) == len(probe["keys"]), "cache_key_probe: the first process built "
          f"{probe['children'][0]['built']}, not every kernel")  # fmt: skip
    return probe


def phase21(torch, dev):
    """Phase 21: runs 21a-e; returns the launches of their main paths and
    what they measured."""
    totals = dict.fromkeys(counters(), 0)
    t0 = time.perf_counter()
    procs = {label: p21_cpu_census(label == "train") for label in ("serve", "train")}
    try:
        census = p21_census(torch, dev, totals)
        trace = p21_trace(torch, dev, totals)
        prim = p21_prim_cost(torch, dev)
        cache = p21_cache(torch, dev)
        p21_against_cpu(census, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit(dict(phase=21, seconds=time.perf_counter() - t0, launches=totals,
              seconds_to_first_kernel=[c["seconds_to_first_kernel"] for c in cache["children"]]))  # fmt: skip
    return dict(launches=totals, census=census, trace=trace, prim=prim, cache=cache)


# ---------------------------------------------------------------------------
# phase 22: the fused masked GroupNorm + activation (csrc/group_norm_act.cu)
# ---------------------------------------------------------------------------

# f32 outputs against the plain version: each within this share of the
# call's largest |output| (the statistics sum in another order: the shifted
# moments' f32 rounding, amplified by rsqrt(var + eps))
P22_F32_TOL = 1e-4
P22_SWEEP_NORMS, P22_ROOM_NORMS = 16, 82
P22_ROOM_POINTS = 400000
P22_ROOM_BUDGET = 1 << 19
# the norm end to end in bf16 convs: the kernels' gap to the plain path at
# most this many times the control's (the plain path with the norm's
# statistics in float64: another rounding of the same function), and never
# held tighter than SERVE_TOL
P22_CONTROL_MARGIN = 2.0


def bf16_ulps(torch, a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (their sign-magnitude bits mapped to ordered integers; +0 and -0 equal)."""
    def ordered(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def p22_bound_ms(cap, c, marked, out_bytes):
    """The least time of one call: the marked rows read once, every row read
    and written once (in the output's dtype), one mask byte a row."""
    return (marked * c * 4 + cap * c * (4 + out_bytes) + cap) / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def p22_checked(torch, rows):
    """Inside the block every call of the kernel's dispatch point is held
    against the plain version on its own inputs: f32 outputs within
    ``P22_F32_TOL``, bf16 outputs the kernel's f32 output rounded once and
    equal to the plain version or 1 ulp from it (beyond 1 ulp only where the
    f32 outputs lie within ``P22_F32_TOL``), two launches bit-equal; the
    first call of each (cap, C, groups, act, dtype) is timed.  ``rows`` gets
    one dict a call."""
    from lattice_net_tpu_torch.ops_cuda import norm

    kernel, timed = norm._group_norm_act, {}

    def checked(lv, mask, g, scale, bias, relu, dtype, eps):
        args = (lv, mask, g, scale, bias, relu)
        out = kernel(*args, dtype, eps)
        again = kernel(*args, dtype, eps)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        check(torch.equal(out.view(bits), again.view(bits)), "group_norm_act: two launches differ")
        f32 = kernel(*args, torch.float32, eps)
        plain = norm.group_norm_act_plain(*args, torch.float32, eps)
        scale_out = max(float(plain.abs().max()), 1e-30)
        f32_err = float((f32 - plain).abs().max()) / scale_out
        cap, c = lv.shape
        marked = int(mask.sum())
        row = dict(cap=cap, c=c, groups=g, relu=bool(relu), dtype=str(dtype).split(".")[-1], marked=marked,
                   f32_rel_err=f32_err)  # fmt: skip
        check(f32_err <= P22_F32_TOL, f"group_norm_act {row}: f32 outputs {f32_err} from the plain version's")
        if dtype == torch.bfloat16:
            check(torch.equal(out.view(bits), f32.to(torch.bfloat16).view(bits)),
                  f"group_norm_act {row}: bf16 output is not the f32 output rounded once")  # fmt: skip
            ulps = bf16_ulps(torch, out, plain.to(torch.bfloat16))
            far = ulps > 1
            row.update(bf16_equal_share=float((ulps == 0).float().mean()), bf16_1ulp=int((ulps == 1).sum()),
                       bf16_over_1ulp=int(far.sum()), bf16_max_ulps=int(ulps.max()))  # fmt: skip
            near = (f32 - plain).abs() <= P22_F32_TOL * scale_out
            check(bool((near | ~far).all()), f"group_norm_act {row}: bf16 outputs over 1 ulp apart unexplained")
        key = (cap, c, g, bool(relu), dtype)
        if key not in timed:
            timed[key] = dict(
                device_ms=device_ms(torch, lambda: kernel(*args, dtype, eps)),
                plain_device_ms=device_ms(torch, lambda: norm.group_norm_act_plain(*args, dtype, eps)),
                bound_ms=p22_bound_ms(cap, c, marked, out.element_size()),
            )  # fmt: skip
        row.update(timed[key])
        rows.append(row)
        return out

    norm._group_norm_act = checked
    try:
        yield
    finally:
        norm._group_norm_act = kernel


def p22_counted(torch, fn):
    """``fn()`` once under a CPU profiler: (the kernel's launches, the
    ``lnt.norm``, ``lnt.norm.fused`` and ``lnt.host_read`` span counts)."""
    from lattice_net_tpu_torch import tracing
    from lattice_net_tpu_torch.ops_cuda.norm import group_norm_act

    before = group_norm_act.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    spans = [counts.get(n, 0) for n in (tracing.NORM, tracing.NORM_FUSED, tracing.HOST_READ)]
    return group_norm_act.launches - before, *spans


def p22_plain_f64(lv, mask, g, scale, bias, relu, dtype, eps=1e-5):
    """The control: the norm's composition in float64, rounded to f32, then
    the activation and the cast, as the plain version makes them."""
    import torch.nn.functional as F

    from lattice_net_tpu_torch.nn.modules import masked_group_norm

    out = masked_group_norm(lv.double(), mask, g, scale.double(), bias.double(), eps).float()
    return (F.relu(out) if relu else out).to(dtype)


def p22_end_to_end(torch, dev):
    """A served sweep through the kernels and through the plain path: in f32
    convs within ``SERVE_TOL``; in bf16 convs, label disagreement and the
    largest log-probability gap each within ``P22_CONTROL_MARGIN`` times the
    control's (or within ``SERVE_TOL``)."""
    from lattice_net_tpu_torch.ops_cuda import norm
    from lattice_net_tpu_torch.serve import Predictor

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        pred = Predictor.from_config(CONFIG, nr_classes=NR_CLASSES, device=dev, conv_dtype=dtype, seed=0)
        pos, vals = scan(pred, 1 << 17, seed=0)
        n = len(pos)
        logp_k, _ = pred.forward(pos, vals)
        logp_p, _ = pred.forward(pos, vals, plain=True)
        plain = norm.group_norm_act_plain
        norm.group_norm_act_plain = p22_plain_f64
        try:
            logp_c, _ = pred.forward(pos, vals, plain=True)
        finally:
            norm.group_norm_act_plain = plain

        def gap(a, b):
            return dict(disagree=1.0 - (a[:n].argmax(-1) == b[:n].argmax(-1)).float().mean().item(),
                        logp_max_abs=(a[:n] - b[:n]).abs().max().item())  # fmt: skip

        kernel, control = gap(logp_k, logp_p), gap(logp_c, logp_p)
        label = str(dtype).split(".")[-1]
        emit(dict(phase22=f"served sweep end to end, {label} convs: kernels vs plain, and the control vs plain",
                  kernel=kernel, control=control, margin=P22_CONTROL_MARGIN, tolerance=SERVE_TOL))  # fmt: skip
        floor = dict(disagree=1.0 - SERVE_TOL["label_agreement"], logp_max_abs=SERVE_TOL["logp_max_abs"])
        for k in kernel:
            limit = floor[k] if dtype == torch.float32 else max(floor[k], P22_CONTROL_MARGIN * control[k])
            check(kernel[k] <= limit, f"{label} sweep end to end: kernels vs plain {k} {kernel[k]} over {limit}")
        out[label] = dict(kernel=kernel, control=control)
        del pred
    return out


def p22_sum(rows):
    return {k: sum(r[k] for r in rows) for k in ("device_ms", "plain_device_ms", "bound_ms")}


def phase22(torch, dev):
    """Phase 22: the kernel against its plain version on every call of a
    served KITTI sweep and of a labelled ScanNet room at the 5M tables (each
    level, width and output dtype), its launches and spans (16 a sweep with
    one host read, 82 a room with none, 0 in a train step), and its device
    time beside its byte bound and the composition's, summed over each."""
    import types

    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.ops_cuda import norm
    from lattice_net_tpu_torch.parallel.data_parallel import TrainState
    from lattice_net_tpu_torch.serve import Predictor
    from lattice_net_tpu_torch.train.setup import TrainSetup

    t0 = time.perf_counter()
    out = dict(end_to_end=p22_end_to_end(torch, dev))
    pred = Predictor.from_config(CONFIG, nr_classes=NR_CLASSES, device=dev, seed=0)
    sweep = scan(pred, 1 << 17, seed=22)
    V, C, L = probe.make_indoor_scene(P22_ROOM_POINTS, seed=22)
    room_pred = Predictor.from_config(SCANNET_EVAL_CONFIG, 21, dev, seed=0, n_points=P22_ROOM_BUDGET)
    check(room_pred.capacities == SCANNET_EVAL_CAPS, f"room capacities {room_pred.capacities}")
    room = prepare_cloud(types.SimpleNamespace(V=V, C=C, L_gt=L), room_pred.params)[:2]
    for label, p, cloud, norms, reads in (("sweep", pred, sweep, P22_SWEEP_NORMS, 1),
                                          ("room", room_pred, room, P22_ROOM_NORMS, 0)):  # fmt: skip
        p.forward(*cloud)  # warm
        counted = p22_counted(torch, lambda: p.forward(*cloud))
        check(counted == (norms, norms, norms, reads),
              f"{label}: launches, lnt.norm, lnt.norm.fused, lnt.host_read {counted}, expected "
              f"{(norms, norms, norms, reads)}")  # fmt: skip
        rows = []
        with p22_checked(torch, rows):
            p.forward(*cloud)
        check(len(rows) == norms, f"{label}: {len(rows)} checked calls")
        shapes = sorted({(r["cap"], r["c"], r["groups"], r["relu"], r["dtype"], r["marked"]) for r in rows})
        sums = p22_sum(rows)
        bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
        emit(dict(phase22=f"group_norm_act, every call of a {label}", calls=len(rows), shapes=shapes,
                  launches_spans_reads=counted, **sums, bound_share_device=sums["bound_ms"] / sums["device_ms"],
                  f32_rel_err_max=max(r["f32_rel_err"] for r in rows),
                  bf16_equal_share_min=min((r["bf16_equal_share"] for r in bf16), default=None),
                  bf16_over_1ulp=sum(r["bf16_over_1ulp"] for r in bf16),
                  bf16_max_ulps=max((r["bf16_max_ulps"] for r in bf16), default=None),
                  per_shape=list({(r["cap"], r["c"], r["groups"], r["dtype"]): r for r in rows}.values())))  # fmt: skip
        out[label] = dict(rows=rows, sums=sums, calls=len(rows))
    del room_pred, room
    torch.cuda.empty_cache()

    run = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, seed=0)
    batch = train_batch(torch, dev, 1 << 17, 1 << 17, seed=22)
    state = TrainState.create(run.model.state_dict(), run.tx)
    step = run.train_step()
    state, _ = step(state, batch)  # warm
    counted = p22_counted(torch, lambda: step(state, batch))
    check(counted[0] == 0 and counted[2] == 0 and counted[1] > 0,
          f"train step: launches, lnt.norm, lnt.norm.fused, lnt.host_read {counted}")  # fmt: skip
    emit(dict(phase22="group_norm_act in a KITTI train step", launches_spans_reads=counted))

    # edge cases: C = 7 in one group (the scalar path), a misaligned table,
    # masks of no row, every row and a scattered set, at a width of the room
    rng = torch.Generator(device=dev).manual_seed(22)
    cases = []
    for cap, c, g, mask_kind, offset in ((4099, 7, 1, "scattered", 0), (4099, 64, 32, "none", 0),
                                         (70000, 64, 32, "all", 0), (70000, 128, 32, "scattered", 1),
                                         (5000, 12, 6, "prefix", 3)):  # fmt: skip
        buf = torch.randn(cap * c + offset, generator=rng, device=dev) * 3 + 40
        lv = buf[offset:].view(cap, c)
        mask = {"none": torch.zeros(cap, dtype=torch.bool, device=dev),
                "all": torch.ones(cap, dtype=torch.bool, device=dev),
                "prefix": torch.arange(cap, device=dev) < cap // 3,
                "scattered": torch.rand(cap, generator=rng, device=dev) < 0.3}[mask_kind]  # fmt: skip
        scale = torch.randn(c, generator=rng, device=dev) * 0.3 + 1
        bias = torch.randn(c, generator=rng, device=dev) * 0.3
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (True, False):
                rows = []
                with p22_checked(torch, rows):
                    norm.group_norm_act(lv, mask, g, scale, bias, relu, dtype)
                cases.append(dict(mask=mask_kind, offset=offset, **rows[0]))
    emit(dict(phase22="group_norm_act edge cases", cases=[{k: r[k] for k in ("cap", "c", "groups", "mask", "offset",
              "relu", "dtype", "f32_rel_err", "device_ms", "bound_ms")} for r in cases]))  # fmt: skip
    emit(dict(phase=22, seconds=time.perf_counter() - t0))
    return out


P23_ROOM_POINTS, P23_ROOM_BUDGET = 400000, 1 << 19
# a 6-D room of 3 coarse levels: a lookup a same-level table (4) and a
# coarsen table (3), a key sort a level (4), no host read
P23_ROOM_COUNTS = dict(launches=7, lookup2_spans=7, sort2_spans=4, host_reads=0)
P23_QUERY_BYTES = 16 + 4  # a query read once, its id written once
# calls a timing of the plain version and of the merged composition: more
# than two of the plain version's ~350 launches each outgrow the launch queue
# while the card sleeps, and device_ms then reads nothing
P23_TIMED_ITERS = 2
# (capacity, occupied rows): the kernel stages the rows the top 11 levels of
# the search probe in shared memory, so 2047-2049 and 4096-4097 rows straddle it
P23_EDGE_TABLES = ((1, 0), (1, 1), (2, 2), (5, 3), (4099, 0), (4099, 1), (4099, 2047), (4099, 2048), (4099, 2049),
                   (4099, 4099), (70000, 4096), (70000, 4097), (70000, 65536), (70000, 70000))  # fmt: skip


def p23_room(torch, dev):
    """One labelled 6-D room at the 5M tables: (its hierarchy, the
    launches, ``lnt.build.lookup2`` / ``lnt.build.sort2`` spans and host
    reads of one forward)."""
    import types

    from lattice_net_tpu_torch import tracing
    from lattice_net_tpu_torch.misc import scannet_scale_probe as probe
    from lattice_net_tpu_torch.models.lnn import prepare_cloud
    from lattice_net_tpu_torch.ops_cuda.lookup import lookup2
    from lattice_net_tpu_torch.serve import Predictor

    pred = Predictor.from_config(p20_cfg(SCANNET_EVAL_CONFIG, P20_D6), 21, dev, seed=0, n_points=P23_ROOM_BUDGET)
    check(pred.capacities == SCANNET_EVAL_CAPS, f"room capacities {pred.capacities}")
    V, C, L = probe.make_indoor_scene(P23_ROOM_POINTS, seed=23)
    pos, vals = prepare_cloud(types.SimpleNamespace(V=V, C=C, L_gt=L), pred.params)[:2]
    check(pos.shape[1] == 6, f"xyz+rgb positions of {pos.shape[1]} columns")
    pred.forward(pos, vals)  # warm
    before = lookup2.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, h = pred.forward(pos, vals)
        torch.cuda.synchronize()
    spans = {e.key: e.count for e in prof.key_averages()}
    counts = dict(launches=lookup2.launches - before, lookup2_spans=spans.get(tracing.BUILD_LOOKUP2, 0),
                  sort2_spans=spans.get(tracing.BUILD_SORT2, 0), host_reads=spans.get(tracing.HOST_READ, 0))  # fmt: skip
    emit(dict(phase23="a 6-D room's forward at the 5M tables", occupancy=[int(s.nr_verts) for s in h.structures],
              overflow=[int(s.nr_overflow) for s in h.structures], **counts))  # fmt: skip
    check(counts == P23_ROOM_COUNTS, f"6-D room: {counts}, expected {P23_ROOM_COUNTS}")
    del pred
    return h


def p23_calls(torch, h):
    """The room build's level-0 same-level and level-1 coarsen lookups, as
    ``build_neighbors_same_level`` and ``build_neighbors_coarse_from_fine``
    make them: ``(name, table, packed queries)``."""
    from lattice_net_tpu_torch.lattice import structure as st

    s0, s1 = h.structures[0], h.structures[1]
    moves = st._axis_moves(s0.pos_dim, s0.keys.device)[None]
    base0 = torch.where(s0.occupancy_mask()[:, None], s0.keys, 0)[:, None, :]
    base1 = (torch.where(s1.occupancy_mask()[:, None], s1.keys, 0) * 2)[:, None, :]
    same = st.pack_keys(base0 + moves).reshape(-1, 2)
    coarsen = st.pack_keys(torch.cat([base1 + moves, base1 - moves, base1], dim=1)).reshape(-1, 2)
    return (("level-0 same-level", s0, same), ("level-1 coarsen into level 0", s0, coarsen))


def p23_timed(torch, name, s, q):
    """The kernel (twice), its plain version and the merged composition it
    replaced on one call's inputs, bit-equal, each timed on the card."""
    from lattice_net_tpu_torch.ops_cuda.lookup import lookup2, lookup2_plain
    from port_bench.reference import structure as ref

    merged = ref.LatticeStructure(s.keys, s.packed, s.nr_verts, s.nr_overflow, s.sigma, s.capacity, s.pos_dim, s.lvl)
    kernel = lambda: lookup2(s.packed, s.nr_verts, q)  # noqa: E731
    plain = lambda: lookup2_plain(s.packed, s.nr_verts, q)  # noqa: E731
    got = kernel()
    for label, other in (("a second launch", kernel()), ("the plain version", plain()),
                         ("the merged composition", merged._merged(q))):  # fmt: skip
        check(torch.equal(got, other), f"lookup2 {name}: the kernel's ids differ from {label}'s")
    nq = q.shape[0]
    row = dict(phase23=f"lookup2, {name}", queries=nq, capacity=s.capacity, occupied=int(s.nr_verts),
               hits=int((got < s.capacity).sum()), device_ms=device_ms(torch, kernel),
               plain_device_ms=device_ms(torch, plain, iters=P23_TIMED_ITERS),
               merged_device_ms=device_ms(torch, lambda: merged._merged(q), iters=P23_TIMED_ITERS),
               bound_ms=nq * P23_QUERY_BYTES / HBM_BYTES_PER_S * 1e3)  # fmt: skip
    row["bound_share_device"] = row["bound_ms"] / row["device_ms"]
    emit(row)
    return row


def p23_edge_cases(torch, dev):
    """The kernel against the plain version on small 6-D tables
    (``P23_EDGE_TABLES``): every occupied row as a query, each moved along
    every axis both ways, random keys, the corners +-(``PACK_BOUND`` - 1)
    (rows of every other table), keys before the first row and past the last
    occupied one; no query; a misaligned table refused."""
    import numpy as np

    from lattice_net_tpu_torch.lattice import structure as st
    from lattice_net_tpu_torch.ops_cuda.lookup import lookup2, lookup2_plain

    rng = np.random.default_rng(23)
    b = st.PACK_BOUND - 1
    corners = np.array([[b] * 6, [-b] * 6, [b, -b] * 3, [-b] + [b] * 5])
    moves = st._axis_moves(6, "cpu").numpy()
    cases = []
    for i, (cap, n) in enumerate(P23_EDGE_TABLES):
        r = 3
        while (2 * r + 1) ** 6 < 4 * n:
            r += 1
        box = np.unique(rng.integers(-r, r + 1, (4 * n + 8, 6)), axis=0)
        rows = np.concatenate([corners[: n if i % 2 else 0], rng.permutation(box)])[:n]
        keys = np.full((cap, 6), st.SENTINEL, np.int32)
        keys[:n] = np.unique(rows, axis=0)
        occ = keys[:n]
        queries = [occ, (occ[:, None] + moves[None]).reshape(-1, 6), (occ[:, None] - moves[None]).reshape(-1, 6),
                   rng.integers(-r - 1, r + 2, (4096, 6)), corners, moves, -moves]  # fmt: skip
        if n:
            first, last = occ[0].copy(), occ[-1].copy()
            first[-1] -= 1
            last[-1] += 1
            queries += [first[None], last[None]]
        kt = torch.from_numpy(keys).to(dev)
        table, nv = st.pack_key_table(kt), torch.tensor(n, dtype=torch.int32, device=dev)
        q = st.pack_keys(torch.from_numpy(np.concatenate(queries).astype(np.int32)).to(dev))
        got = lookup2(table, nv, q)
        check(torch.equal(got, lookup2_plain(table, nv, q)), f"lookup2 cap={cap} n={n}: kernel vs plain")
        cases.append(dict(cap=cap, occupied=n, queries=q.shape[0], hits=int((got < cap).sum())))
    none = lookup2(table, nv, q[:0])
    check(none.shape == (0,) and none.dtype == torch.int32, f"lookup2 of no query: {none.shape}, {none.dtype}")
    shifted = torch.empty(table.numel() + 1, dtype=torch.int64, device=dev)[1:].view(-1, 2)
    shifted.copy_(table)
    try:
        lookup2(shifted, nv, q)
        refused = False
    except ValueError:
        refused = True
    check(refused, "lookup2 took a table that is not 16-byte aligned")
    emit(dict(phase23="lookup2 edge cases, kernel vs plain bit-equal", cases=cases))
    return cases


def phase23(torch, dev):
    """Phase 23: the two-column lookup kernel on a 6-D room's build (its
    launches and spans; its two largest calls against the plain version and
    the merged composition, timed) and on small edge-case tables."""
    t0 = time.perf_counter()
    h = p23_room(torch, dev)
    rows = [p23_timed(torch, name, s, q) for name, s, q in p23_calls(torch, h)]
    del h
    torch.cuda.empty_cache()
    edge = p23_edge_cases(torch, dev)
    emit(dict(phase=23, seconds=time.perf_counter() - t0))
    return dict(rows=rows, edge=edge)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from lattice_net_tpu_torch.serve import Predictor
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = environment(torch)

    with default_head():  # phases 2-9: the default head, whatever the caller's environment
        pred = Predictor.from_config(CONFIG, nr_classes=NR_CLASSES, device=dev, seed=0)
        k1, k2 = kernels_vs_plain(torch, pred, dev)
        k1_per_scan = k1["calls"]
        check(
            k1_per_scan == patch_gathers_per_scan(pred.model),
            f"one forward made {k1_per_scan} patch gathers, the model has "
            f"{patch_gathers_per_scan(pred.model)} convs and a head",
        )
        launches = serve(torch, pred, k1_per_scan)
        kernels_vs_plain_end_to_end(torch, pred)
        card_vs_cpu(torch, dev)
        del pred

        from lattice_net_tpu_torch.parallel.data_parallel import TrainState
        from lattice_net_tpu_torch.train.setup import TrainSetup

        run = TrainSetup.from_config(TRAIN_CONFIG, NR_CLASSES, KITTI_TRAIN_SCANS, device=dev, seed=0)
        batch = train_batch(torch, dev, 1 << 17, 1 << 17, seed=0)
        state = TrainState.create(run.model.state_dict(), run.tx)
        k1_step, k2_step, k1b, k2b = train_step_kernels_vs_plain(torch, run, state, batch, dev)
        trained, per_step = train(torch, run, state, batch)
        train_kernels_vs_plain(torch, run, state, batch)
        train_card_vs_cpu(torch, dev)
    k34 = segvjp_kernels_vs_plain(torch, run, state, batch)  # phase 10
    seg_trained = train_segvjp(torch, run, state, batch)  # phase 11
    seg_per_step = launches_per_step(run.model, segvjp=True)
    segvjp_gradients(torch, run, state, batch, dev)  # phase 12
    dropout_step(torch, run, state, batch, dev)  # phase 13
    del run, state, batch
    with default_head():
        trainer = trainer_cli(torch, dev)  # phase 14
        kitti = kitti_eval(torch, dev, k1_per_scan)  # phase 15
        sn = scannet(torch, dev)  # phase 16
        shn = shapenet(torch, dev)  # phase 17
        p18 = phase18(torch, dev, sn["caps"])  # phase 18
        p19 = phase19(torch, dev, sn["caps"])  # phase 19
        p20 = phase20(torch, dev)  # phase 20
        p21 = phase21(torch, dev)  # phase 21
        p22 = phase22(torch, dev)  # phase 22
        p23 = phase23(torch, dev)  # phase 23

    def scannet_launches(key):
        return dict(launches_scannet_train=sn["train"][key], launches_scannet_eval=sn["eval"][key],
                    launches_shapenet_train=shn["train"][key], launches_shapenet_eval=shn["eval"][key])

    def both(key):
        ev, st, kt = kitti["eval"].get(key, 0), kitti["stream"].get(key, 0), kitti["trainer"][key]
        snt, sne = sn["train"][key] + shn["train"][key], sn["eval"][key] + shn["eval"][key]
        p, p19k, p20k, p21k = p18["launches"][key], p19["launches"][key], p20["launches"][key], p21["launches"][key]
        return dict(launches=launches.get(key, 0) + trained[key] + trainer[key] + kt + ev + st + snt + sne + p + p19k
                    + p20k + p21k, launches_phase18=p, launches_phase19=p19k, launches_phase20=p20k,
                    launches_phase21=p21k,
                    launches_serving=launches.get(key, 0), launches_training=trained[key],
                    launches_trainer_cli=trainer[key] + kt, launches_eval=ev, launches_stream=st,
                    **scannet_launches(key), launches_per_step_scannet=sn["per_step"][key],
                    launches_per_step_shapenet=shn["per_step"][key])  # fmt: skip

    def scannet_step(t, i):
        return {**{f"{k}_scannet_step": t[k] for k in TIMES},
                **{f"{k}_shapenet_step": shn["step"][i][k] for k in TIMES}}  # fmt: skip

    def per_train_step(t):
        return {f"{k}_per_step": t[k] for k in TIMES}

    def own(t):
        return {k: t[k] for k in TIMES}

    def p20_rows(i):
        """Kernel ``i``'s (0 K1, 1 K2, 2 K1-bwd, 3 K2-bwd) sums at phase
        20's shapes: the d = 4 step, the d = 6 step (K1: one call a shape)
        and for K1 and K2 the d = 4 served scan."""
        out = {**{f"{k}_d4_step": p20["d4"]["step"][i][k] for k in TIMES},
               **{f"{k}_d6_step": p20["d6"]["step"][i][k] for k in TIMES}}  # fmt: skip
        if i < 2:
            out.update({f"{k}_d4_serve": p20["d4"]["serve_k1" if i == 0 else "serve_k2"][k] for k in TIMES})
        return out

    def p20_err(i):
        errs = [p20["d4"]["step"][i]["max_abs_err"], p20["d6"]["step"][i]["max_abs_err"]]
        if i < 2:
            errs.append(p20["d4"]["serve_k1" if i == 0 else "serve_k2"]["max_abs_err"])
        return max(errs)

    rows = [
        dict(
            name="patch_gather", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_gather.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:133", **both("k1"),
            launches_per_scan=k1_per_scan, launches_per_step=per_step["k1"],
            max_abs_err=max(k1["max_abs_err"], k1_step["max_abs_err"], shn["step"][0]["max_abs_err"], p20_err(0)),
            **own(k1), **p20_rows(0),
            bound_by="bytes", **per_train_step(k1_step), **scannet_step(sn["step"][0], 0),
            **{f"{k}_scannet_eval_5m": sn["eval_k1"][k] for k in TIMES},
            **{f"{k}_probe_head_2e21": sn["probe_head"][k] for k in TIMES},
            **{f"{k}_canonical_serving": p18["k1_canonical"][k] for k in TIMES},
            **{f"{k}_lattice_library": p18["k1_library"][k] for k in TIMES},
            edge_cases_bit_equal=k1["edge_cases"],
            timed_as=f"ms: sum over the {k1_per_scan} gathers of one served scan; ms_per_step: "
            f"sum over the {k1_step['calls']} gathers of one train step; *_scannet_step: over the "
            f"{sn['step'][0]['calls']} of one ScanNet step; *_scannet_eval_5m: over one call per "
            f"shape ({sn['eval_k1']['calls']}) of a 5M-row ScanNet forward, one row block each; "
            "*_probe_head_2e21: the head gather of the scale probe's 2^21 forward; *_shapenet_step: "
            f"over the {shn['step'][0]['calls']} of one ShapeNet step of 4 clouds; *_canonical_serving: over the "
            f"{p18['k1_canonical']['calls']} of phase 18a's canonical scan; *_lattice_library: over the "
            f"{p18['k1_library']['calls']} of phase 18d's ops and blocks; *_d4_serve, *_d4_step: over the "
            f"{p20['d4']['serve_k1']['calls']} and {p20['d4']['step'][0]['calls']} of phase 20a's d=4 served scan and "
            f"train step; *_d6_step: over one call of each of the {p20['d6']['step'][0]['calls']} shapes of phase "
            "20b's d=6 ScanNet step; each on its own inputs",
        ),
        dict(
            name="seg_max_carry", route="cuda", source="lattice_net_tpu_torch/csrc/seg_max.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:413", **both("k2"),
            launches_per_scan=1, launches_per_step=per_step["k2"],
            max_abs_err=max(k2["max_abs_err"], k2_step["max_abs_err"], shn["step"][1]["max_abs_err"], p20_err(1)),
            **own(k2), **p20_rows(1),
            bound_by="bytes", **per_train_step(k2_step), **scannet_step(sn["step"][1], 1),
            max_only_segment_reduce_ms=k2["max_only_segment_reduce_ms"],
            max_only_segment_reduce_ms_per_step=k2_step["max_only_segment_reduce_ms"],
            timed_as="ms: the max-pool of one served scan; ms_per_step: that of one train step; "
            "*_shapenet_step: the 4 of one ShapeNet step; *_d4_serve, *_d4_step, *_d6_step: phase 20's d=4 "
            "served scan and step, d=6 step; max_only_segment_reduce: a reference without the carry, not the "
            "library call",
        ),
        dict(
            name="patch_scatter", route="cuda",
            source="lattice_net_tpu_torch/csrc/patch_scatter.cu",
            replaces="lattice_net_tpu/ops_tpu/patch.py:252", **both("k1b"),
            launches_per_step=per_step["k1b"],
            max_abs_err=max(k1b["max_abs_err"], shn["step"][2]["max_abs_err"], p20_err(2)),
            **own(k1b), **p20_rows(2),
            bound_by="bytes", dest_repeat_share_32=k1b["dest_repeat_share_32"],
            device_ms_uniform_ids=k1b["device_ms_uniform_ids"],
            two_runs_max_abs_gap=k1b["two_runs_max_abs_gap"], **scannet_step(sn["step"][2], 2),
            timed_as="the head gather's adjoint in one train step (*_scannet_step: one ScanNet step; "
            "*_shapenet_step: the 4 of one ShapeNet step; *_d4_step, *_d6_step: phase 20's d=4 and d=6 steps)",
        ),
        dict(
            name="seg_max_carry_bwd", route="cuda",
            source="lattice_net_tpu_torch/csrc/seg_max_bwd.cu",
            replaces="lattice_net_tpu/ops_tpu/segment.py:488", **both("k2b"),
            launches_per_step=per_step["k2b"], max_abs_err=max(k2b["max_abs_err"], shn["step"][3]["max_abs_err"],
                                                               p20_err(3)),
            **own(k2b), **p20_rows(3),
            bound_by="bytes", **scannet_step(sn["step"][3], 3),
            timed_as="the max-pool's adjoint in one train step (*_scannet_step: one ScanNet step; "
            "*_shapenet_step: the 4 of one ShapeNet step; *_d4_step, *_d6_step: phase 20's d=4 and d=6 steps)",
        ),
    ]  # fmt: skip
    for key, name, src, site, pick in (
        ("k3", "seg_sum", "seg_sum.cu", "segment.py:142", 1),
        ("k4", "take_rows", "take_rows.cu", "gather.py:52", 0),
    ):
        main_row = k34[pick]
        rows.append(dict(
            name=name, route="cuda", source=f"lattice_net_tpu_torch/csrc/{src}",
            replaces=f"lattice_net_tpu/ops_tpu/{site}",
            launches=seg_trained[key] + trainer[key] + kitti["trainer"][key] + sn["train"][key]
            + sn["eval"][key] + shn["train"][key] + shn["eval"][key] + p18["launches"][key] + p19["launches"][key]
            + p20["launches"][key] + p21["launches"][key], launches_phase18=p18["launches"][key],
            launches_phase19=p19["launches"][key], launches_phase20=p20["launches"][key],
            launches_phase21=p21["launches"][key], **scannet_launches(key),
            launches_training_segvjp=seg_trained[key],
            launches_trainer_cli=trainer[key] + kitti["trainer"][key],
            launches_per_step=seg_per_step[key],
            max_abs_err=main_row["max_abs_err"],
            **own(main_row), bound_by="bytes", library=main_row["library"],
            **({f"{k}_canonical_distribute": p18["k4_canonical"][k] for k in TIMES} if key == "k4" else {}),
            timed_as=f"ms: the call of one LNT_HEAD_SEGVJP=1 train step ({main_row['shape']})"
            + ("; *_canonical_distribute: the non-carried distribute's row gather of phase 18a"
               if key == "k4" else ""),
        ))  # fmt: skip
    rows.append(dict(
        name="group_norm_act", route="cuda", source="lattice_net_tpu_torch/csrc/group_norm_act.cu",
        replaces=None, bound_by="bytes", launches_per_scan=p22["sweep"]["calls"],
        launches_per_room=p22["room"]["calls"], launches_per_step=0,
        **{f"{k}_scan": v for k, v in p22["sweep"]["sums"].items()},
        **{f"{k}_room_5m": v for k, v in p22["room"]["sums"].items()},
        timed_as="*_scan: summed over the 16 calls of one served KITTI sweep; *_room_5m: over the 82 of one "
        "ScanNet room at the 5M tables; each call's shape timed once on its own inputs",
    ))  # fmt: skip
    same, coarsen = p23["rows"]
    rows.append(dict(
        name="lookup2", route="cuda", source="lattice_net_tpu_torch/csrc/lookup2.cu", replaces=None,
        bound_by="bytes", launches_per_room_6d=P23_ROOM_COUNTS["launches"], launches_per_scan=0,
        **{f"{k}_same_level_l0": same[k] for k in ("device_ms", "plain_device_ms", "merged_device_ms", "bound_ms")},
        **{f"{k}_coarsen_l1": coarsen[k] for k in ("device_ms", "plain_device_ms", "merged_device_ms", "bound_ms")},
        edge_cases_bit_equal=len(p23["edge"]),
        timed_as=f"*_same_level_l0: the 6-D room build's level-0 same-level call ({same['queries']} queries into "
        f"{same['occupied']} of {same['capacity']} rows); *_coarsen_l1: its level-1 coarsen call ({coarsen['queries']} "
        "queries); merged: the merged sort-and-cummax composition the kernel replaced",
    ))  # fmt: skip
    print(card)
    emit({"kernels": rows})
    name = torch.cuda.get_device_name(0)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
