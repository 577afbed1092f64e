"""The port's labelling path on the 6-D position + colour lattice
(``positions_mode="xyz+rgb"``) against the benchmark's plain reference
(``port_bench/reference``), on the CPU.

``Predictor.forward`` with f32 convs and the reference's ``forward`` build
the same two-column keys, run the same merged lookups and the same model on
seeded random weights: their log-probabilities are equal bit for bit, with
one sigma on all six axes and with a sigma a axis.
"""

import types

import numpy as np
import pytest
import torch

from lattice_net_tpu_torch.data.synth_scannet import make_indoor_scene
from lattice_net_tpu_torch.models import lnn as tlnn
from lattice_net_tpu_torch.serve import Predictor
from port_bench import program
from port_bench.reference import api as ref

torch.set_num_threads(2)

N_POINTS, N_REAL, CAPS = 2048, 1800, (16384, 16384, 8192)
# ScanNet's modes and classes, at a width the CPU runs in seconds
MODEL = dict(
    positions_mode="xyz+rgb",
    values_mode="rgb+height",
    pointnet_channels_per_layer=[16, 32],
    pointnet_start_nr_channels=16,
    nr_downsamples=2,
    nr_blocks_down_stage=[1, 1],
    nr_blocks_bottleneck=1,
    nr_blocks_up_stage=[1, 1],
)
CLASSES = 21
SIGMAS = {"one": 0.08, "per_axis": (0.08, 0.08, 0.08, 0.12, 0.16, 0.2)}


@pytest.fixture(scope="module")
def room():
    v, c, labels = make_indoor_scene(N_REAL, seed=3)
    cloud = types.SimpleNamespace(V=v, C=c, L_gt=labels)
    pos, val, _ = tlnn.prepare_cloud(cloud, program.model_params(dict(model=MODEL, nr_classes=CLASSES)))
    return pos, val


@pytest.fixture(scope="module")
def weights():
    cfg = dict(model=MODEL, nr_classes=CLASSES, conv_dtype="float32")
    return program.seeded_weights(program.make_model(cfg, "cpu"), 2**32 + 21, "cpu")


@pytest.mark.parametrize("sigma", sorted(SIGMAS))
def test_the_port_equals_the_reference_at_d6(sigma, room, weights):
    sigma = SIGMAS[sigma]
    pos, val = room
    assert pos.shape[1] == 6
    model = program.make_model(dict(model=MODEL, nr_classes=CLASSES, conv_dtype="float32"), "cpu")
    model.load_state_dict(weights)
    logp, h = Predictor(model.eval(), sigma, CAPS, N_POINTS, torch.device("cpu")).forward(pos, val)
    assert [int(s.nr_overflow) for s in h.structures] == [0, 0, 0]

    net = ref.make_model(MODEL, CLASSES, weights, "cpu")
    pad = N_POINTS - N_REAL
    p = torch.from_numpy(np.pad(pos, ((0, pad), (0, 0))))
    v = torch.from_numpy(np.pad(val, ((0, pad), (0, 0))))
    mask = torch.arange(N_POINTS) < N_REAL
    with ref.precision("f32"):
        ref_logp, overflow = ref.forward(net, p, v, mask, sigma, CAPS)
    assert overflow == [0, 0, 0]
    assert torch.equal(logp[:N_REAL], ref_logp[:N_REAL])
