"""Faults planted in the port's timed path, to show that ``correct`` fails
them: the fault tests (``tests/test_port_bench_faults.py``) on the CPU and
``calibrate.py --fault`` on the card use the same ones.  Each is a context
manager that patches the port's public call and restores it."""

from __future__ import annotations

import contextlib

from lattice_net_tpu_torch.parallel import data_parallel as dp
from lattice_net_tpu_torch.serve import Predictor


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def altered_labels():
    """Every point of every served cloud labelled with its least likely
    class, where the forward produces them."""
    forward = Predictor.forward

    def altered(self, positions, values, plain=False):
        logp, h = forward(self, positions, values, plain)
        return -logp, h

    return _patched(Predictor, "forward", altered)


def unchanged_state(after: int = 0):
    """A train step that returns its state unchanged, from the ``after``-th
    step of the process on (the steps before it are sound)."""
    update, calls = dp.apply_update, []

    def unchanged(tx, state, grads, loss=None):
        calls.append(1)
        if len(calls) <= after:
            return update(tx, state, grads, loss)
        return dp.TrainState(state.params, state.opt_state, state.step + 1)

    return _patched(dp, "apply_update", unchanged)


FAULTS = {f.__name__: f for f in (altered_labels, unchanged_state)}
