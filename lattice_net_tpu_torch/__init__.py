"""LatticeNet in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of :mod:`lattice_net_tpu` (JAX/Pallas for the TPU), which stays the
reference: module names mirror the JAX package so that each counterpart is
easy to find, and every tensor convention (sorted vertex ids,
capacity-padded tables, invalid index = capacity) is kept so that the two
compare row for row.  This package imports ``torch`` and ``numpy`` only.

Entry points take an explicit ``device``; the default is ``cuda`` and raises
where no card is present (see :func:`device.resolve_device`).
"""

from lattice_net_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
