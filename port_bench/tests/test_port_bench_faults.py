"""``correct`` against faults: each run drives a whole cell (the card's
look skipped, tiny sizes, the port's convs in f32, where a sound run reads
0 against the reference) with the timed path broken underneath
(``port_bench/faults.py``), and sees ``correct`` come out false; the sound
run beside it comes out true.  A fault may start only once the window has
opened (the steps of set-up sound), and in a traced run it sits in the
untimed entry, which the window's stage spans bypass.  A single card has no
exchange between chips to leave out, and a batch of one cloud no half to
leave out.  The control, the reference in fp8 in the program's place, is
held on the card at the cells' own sizes."""

import pytest

from port_bench import faults, run
from port_bench.tests.conftest import tiny

SEED = 3 * 2**31 + 17


def _run(cell, trace=False, **kw):
    return run.run_cell(cell, SEED, 1.0, trace, "cpu", tiny(cell, f32=True), **kw)


# the train cells' set-up takes check_steps + warmup_extra = 4 steps
@pytest.mark.parametrize(
    "cell, fault, kwargs, trace",
    [("kitti_serve_10hz", "altered_labels", {}, False), ("scannet_eval_5m", "altered_labels", {}, False),
     ("kitti_serve_10hz", "altered_labels", {}, True), ("scannet_eval_5m", "altered_labels", {}, True),
     ("kitti_train", "unchanged_state", {}, False), ("scannet_train", "unchanged_state", {}, False),
     ("kitti_train", "unchanged_state", {"after": 4}, False), ("kitti_train", "unchanged_state", {"after": 4}, True)],
)  # fmt: skip
def test_a_planted_fault_is_not_correct(cell, fault, kwargs, trace):
    assert _run(cell, trace)["correct"]
    with faults.FAULTS[fault](**kwargs):
        out = _run(cell, trace)
    assert not out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["kitti_serve_10hz", "kitti_train", "scannet_train", "scannet_eval_5m"])
def test_the_control_is_not_correct(cell, card):
    for seed in (11, 12, 13):
        out = run.run_cell(cell, seed, 3.0, False, card, control=True)
        assert not out["correct"], out["compared"]
