"""Conversions from the JAX package's data to the port's, without JAX.

``params_from_flax`` maps a flax params tree (nested dicts of arrays) onto
the port's ``state_dict``: module paths and parameter layouts are the same,
so the mapping is by name, with no transpose.  ``hierarchy_from_numpy``
rebuilds a :class:`LatticeHierarchy` from any object with the JAX
hierarchy's fields (arrays convertible with ``numpy.asarray``); the tests
use it to feed both models the same lattice.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

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


def hierarchy_from_numpy(h, device="cpu") -> st.LatticeHierarchy:
    """Port hierarchy with the same tables as ``h`` (a JAX ``LatticeHierarchy``
    or anything with its fields)."""
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
