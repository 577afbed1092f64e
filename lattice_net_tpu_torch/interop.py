"""Conversions between the JAX package's data and the port's, without JAX.

``params_from_flax`` maps a flax variables tree (nested dicts of arrays)
onto the port's ``state_dict``: module paths and parameter layouts are the
same, so the mapping is by name, with no transpose; flax's ``batch_stats``
collection (``BatchNormLattice``'s ``mean`` and ``var``) maps onto the
modules' buffers of those names.  ``params_to_flax`` is its inverse.  ``opt_state_from_optax`` maps the optax state of the JAX
``make_optimizer`` chain (as optax NamedTuples, or in the nested-dict
layout of a flax checkpoint) onto the state of the port's ``AdamWAmsgrad``,
so that a JAX run resumes in the port; ``opt_state_to_optax_tree`` gives
the port's state in that checkpoint layout, so that a port run resumes in
JAX.  ``hierarchy_from_numpy`` rebuilds a :class:`LatticeHierarchy` from any
object with the JAX hierarchy's fields (arrays convertible with
``numpy.asarray``); the tests use it to feed both models the same lattice.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from lattice_net_tpu_torch.device import resolve_device
from lattice_net_tpu_torch.lattice import structure as st
from lattice_net_tpu_torch.train.optim import PLATEAU_FIELDS

_AMSGRAD_FIELDS = ("count", "mu", "nu", "nu_max")
# flax collections a variables tree may hold, and the leaves of batch_stats
_COLLECTIONS = ("params", "batch_stats")
BATCH_STATS_LEAVES = ("mean", "var")


def params_from_flax(tree: Mapping) -> dict:
    """``{"params": {"PointNetModule_0": {"WNLinear_0": {"v": ...}}}}`` ->
    ``{"PointNetModule_0.WNLinear_0.v": tensor, ...}`` (f32 tensors).  A
    ``batch_stats`` collection beside ``params`` adds its leaves under the
    same module paths (``BatchNormLattice_0.mean``, the buffers)."""
    if "params" in tree and set(tree) <= set(_COLLECTIONS):
        return {k: v for c in _COLLECTIONS if c in tree for k, v in params_from_flax(tree[c]).items()}
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


def params_to_flax(params: Mapping) -> dict:
    """The inverse of :func:`params_from_flax`: ``{name: tensor}`` ->
    ``{"params": nested dicts of f32 numpy arrays}``, the layout of the
    JAX package's params (flax module and leaf names contain no dot), and
    ``"batch_stats"`` beside it for the leaves named ``mean`` or ``var``
    where there are any."""
    tree: dict = {"params": {}}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree.setdefault("batch_stats" if leaf in BATCH_STATS_LEAVES else "params", {})
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def _as_state_dict(node):
    """An optax state (NamedTuples in tuples, params trees in dicts) in the
    nested-dict layout of ``flax.serialization.to_state_dict``: a tuple
    becomes a dict keyed ``"0"``, ``"1"``, ..., a NamedTuple a dict by field
    (``EmptyState`` becomes ``{}``); a dict already has that layout."""
    fields = getattr(node, "_fields", None)
    if fields is not None:
        return {f: _as_state_dict(getattr(node, f)) for f in fields}
    if isinstance(node, (tuple, list)):
        return {str(i): _as_state_dict(c) for i, c in enumerate(node)}
    if isinstance(node, Mapping):
        return {str(k): _as_state_dict(v) for k, v in node.items()}
    return node


def opt_state_from_optax(opt_state, device=None) -> dict:
    """The optax state of ``make_optimizer``'s chain -> the state of
    ``train.optim.AdamWAmsgrad`` (``{"count", "mu", "nu", "nu_max"}`` and,
    for ``reduce_on_plateau``, ``"plateau"``), tensors on ``device`` (the
    card unless ``"cpu"``).  ``opt_state`` is the optax NamedTuple state or
    its state-dict layout (a restored checkpoint's ``"opt_state"``).

    The amsgrad state gives the moments and the count; a schedule's count
    (``ScaleByScheduleState``) must equal it, as it does in every chain
    that ``make_optimizer`` builds."""
    device = resolve_device(device)
    amsgrad, counts, plateau = [], [], []

    def walk(node):
        keys = set(node)
        if set(_AMSGRAD_FIELDS) <= keys:
            amsgrad.append(node)
        elif keys == {"count"}:
            counts.append(int(np.asarray(node["count"])))
        elif keys == set(PLATEAU_FIELDS):
            plateau.append(node)
        else:
            for child in node.values():
                if isinstance(child, Mapping):
                    walk(child)

    walk(_as_state_dict(opt_state))
    if len(amsgrad) != 1 or len(plateau) > 1:
        raise ValueError(
            f"expected one amsgrad state and at most one plateau state in the chain, "
            f"found {len(amsgrad)} and {len(plateau)}"
        )
    state = amsgrad[0]
    count = int(np.asarray(state["count"]))
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from the amsgrad count {count}")
    out = {"count": count}
    for name in ("mu", "nu", "nu_max"):
        out[name] = {k: v.to(device) for k, v in params_from_flax(state[name]).items()}
    if plateau:
        out["plateau"] = {
            k: torch.from_numpy(np.array(plateau[0][k])).to(device) for k in PLATEAU_FIELDS
        }
    return out


def opt_state_to_optax_tree(opt_state: dict, tx) -> dict:
    """The port's optimizer state in the layout that
    ``flax.serialization.to_state_dict`` gives the optax state of the JAX
    ``make_optimizer`` chain that ``tx`` mirrors: the chain ``(amsgrad,
    add_decayed_weights, scale_by_learning_rate)``, behind
    ``clip_by_global_norm`` when ``tx.max_grad_norm`` is set and in front of
    ``reduce_on_plateau`` when ``tx.plateau`` is.  Counts are int32 and the
    plateau's floats f32 0-d arrays, as in JAX."""
    count = np.asarray(opt_state["count"], np.int32)
    amsgrad = {"count": count}
    for name in ("mu", "nu", "nu_max"):
        amsgrad[name] = params_to_flax(opt_state[name])
    # a schedule keeps its own count (ScaleByScheduleState); a constant lr none
    lr_state = {"count": count.copy()} if callable(tx.learning_rate) else {}
    tree = {"0": amsgrad, "1": {}, "2": lr_state}
    if tx.max_grad_norm is not None:
        tree = {"0": {}, "1": tree}
    if tx.plateau is not None:
        plateau = {k: opt_state["plateau"][k].detach().cpu().numpy() for k in PLATEAU_FIELDS}
        tree = {"0": tree, "1": plateau}
    return tree


def _t(x, device, dtype=None):
    arr = np.array(x)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def _structure_from_numpy(s, device) -> st.LatticeStructure:
    keys = _t(s.keys, device, torch.int32)
    return st.LatticeStructure(
        keys=keys,
        packed=st.pack_key_table(keys),
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
        weights=None if getattr(e, "weights", None) is None else _t(e.weights, device, torch.float32),
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
