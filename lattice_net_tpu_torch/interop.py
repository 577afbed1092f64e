"""Conversions from the JAX package's data to the port's, without JAX.

``params_from_flax`` maps a flax params tree (nested dicts of arrays) onto
the port's ``state_dict``: module paths and parameter layouts are the same,
so the mapping is by name, with no transpose.  ``opt_state_from_optax``
maps the optax state of the JAX ``make_optimizer`` chain onto the state of
the port's ``AdamWAmsgrad``, so that a JAX run resumes in the port.
``hierarchy_from_numpy`` rebuilds a :class:`LatticeHierarchy` from any
object with the JAX hierarchy's fields (arrays convertible with
``numpy.asarray``); the tests use it to feed both models the same lattice.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import structure as st


def params_from_flax(tree: Mapping) -> dict:
    """``{"params": {"PointNetModule_0": {"WNLinear_0": {"v": ...}}}}`` ->
    ``{"PointNetModule_0.WNLinear_0.v": tensor, ...}`` (f32 tensors)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk(tree, "")
    return out


def opt_state_from_optax(opt_state, device=None) -> dict:
    """The optax state of ``make_optimizer``'s chain (nested tuples of
    optax NamedTuple states) -> ``{"count", "mu", "nu", "nu_max"}`` of
    ``train.optim.AdamWAmsgrad``, tensors on ``device`` (the card unless
    ``"cpu"``).

    The amsgrad state gives the moments and the count; a schedule's count
    (``ScaleByScheduleState``) must equal it, as it does in every chain
    that ``make_optimizer`` builds."""
    device = resolve_device(device)
    amsgrad, counts = [], []

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None and {"count", "mu", "nu", "nu_max"} <= set(fields):
            amsgrad.append(node)
        elif fields == ("count",):
            counts.append(int(np.asarray(node.count)))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(amsgrad) != 1:
        raise ValueError(f"expected one amsgrad state in the chain, found {len(amsgrad)}")
    state = amsgrad[0]
    count = int(np.asarray(state.count))
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from the amsgrad count {count}")
    out = {"count": count}
    for name in ("mu", "nu", "nu_max"):
        out[name] = {k: v.to(device) for k, v in params_from_flax(getattr(state, name)).items()}
    return out


def _t(x, device, dtype=None):
    arr = np.array(x)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def _structure_from_numpy(s, device) -> st.LatticeStructure:
    keys = _t(s.keys, device, torch.int32)
    packed = torch.where(keys[:, 0] == st.SENTINEL, st._PACKED_SENTINEL, st.pack_keys(keys))
    return st.LatticeStructure(
        keys=keys,
        packed=packed,
        nr_verts=_t(s.nr_verts, device, torch.int32),
        nr_overflow=_t(s.nr_overflow, device, torch.int32),
        sigma=_t(s.sigma, device, torch.float32),
        capacity=int(s.capacity),
        pos_dim=int(s.pos_dim),
        lvl=int(s.lvl),
    )


def hierarchy_from_numpy(h, device=None) -> st.LatticeHierarchy:
    """Port hierarchy with the same tables as ``h`` (a JAX ``LatticeHierarchy``
    or anything with its fields), on ``device`` (the card unless ``"cpu"``)."""
    device = resolve_device(device)
    e = h.edges
    edges = st.EdgeSort(
        perm=_t(e.perm, device, torch.int32),
        vertex=_t(e.vertex, device, torch.int32),
        ends=_t(e.ends, device, torch.int32),
        rows=None if e.rows is None else _t(e.rows, device, torch.float32),
    )
    return st.LatticeHierarchy(
        structures=tuple(_structure_from_numpy(s, device) for s in h.structures),
        neighbors_same=tuple(_t(x, device, torch.int32) for x in h.neighbors_same),
        neighbors_coarsen=tuple(_t(x, device, torch.int32) for x in h.neighbors_coarsen),
        neighbors_finefy=tuple(_t(x, device, torch.int32) for x in h.neighbors_finefy),
        splat_idx=_t(h.splat_idx, device, torch.int32),
        splat_weights=_t(h.splat_weights, device, torch.float32),
        point_mask=_t(h.point_mask, device, torch.bool),
        edges=edges,
    )
