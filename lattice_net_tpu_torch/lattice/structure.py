"""Sparse lattice structures with static shapes, built once per cloud.

Counterpart of ``lattice_net_tpu/lattice/structure.py``: ``build_hierarchy``
with its coarse modes, the canonical point order and its corner-dedup fast
build, and the neighbour tables by lookup.  The outputs are the reference's,
row for row:

  * every per-vertex table is padded to ``capacity`` rows and vertex ids are
    assigned in sorted-key order;
  * empty key-table rows hold ``SENTINEL`` (INT32_MAX) in every column;
  * the invalid / not-found index is ``capacity``;
  * ``nr_verts`` and ``nr_overflow`` are 0-dim device tensors (no host read).

The mechanics are the card's, not the TPU's.  The integer keys pack into
int64 columns of up to three coordinates each (each coordinate + 2^15 in 16
bits, |k| < ``PACK_BOUND``): one column for d <= 3, two for d = 4..6.  With
one column a single stable ``torch.sort`` gives the (key, edge index) order
that the JAX build reaches through folded multi-operand sorts, and a lookup
is a ``torch.searchsorted`` on the packed table plus an equality test.  With
two, the order is two stable sorts (the low column first) and a lookup is
the JAX package's direct lookup, a lower-bound search per query over the
occupied rows (``ops_cuda.lookup.lookup2``: a kernel on the card).

Where the JAX package offers two formulations of a build step, each giving
the same tables, the port has one: the per-vertex run ends by a sort of
the run-end markers, and the point -> vertex map by a scatter of the edge
permutation.

Inside :func:`static_general_branches` (batches of clouds) every
data-dependent fast path takes its general branch without a host read.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Sequence

import torch

from lattice_net_tpu_torch import tracing
from lattice_net_tpu_torch.lattice import permutohedral
from lattice_net_tpu_torch.ops_cuda import lookup

__all__ = [
    "LatticeStructure",
    "EdgeSort",
    "LatticeHierarchy",
    "build_structure",
    "build_structure_from_elevated",
    "build_neighbors_same_level",
    "build_neighbors_coarse_from_fine",
    "build_neighbors_fine_from_coarse",
    "finefy_from_coarsen_transpose",
    "canonical_point_order",
    "default_capacity_schedule",
    "capacity_schedule_from_occupancy",
    "escalate_capacities",
    "compact_hierarchy",
    "build_hierarchy",
    "static_general_branches",
]

# key-table value of empty rows; sorts after every real coordinate
SENTINEL = torch.iinfo(torch.int32).max
# |lattice key| bound of the packed representation (as in the JAX package)
PACK_BOUND = 1 << 14
# packed value of masked edges and empty table rows; above every real key
_PACKED_SENTINEL = torch.iinfo(torch.int64).max
_FIELD_BITS = 16
_FIELD_OFFSET = 1 << 15
_COLUMN_FIELDS = 3  # 16-bit fields an int64 column holds below its sign bit


def key_columns(pos_dim: int) -> int:
    """int64 columns of a packed key: 1 for d <= 3, 2 for d = 4..6."""
    return -(-pos_dim // _COLUMN_FIELDS)


def pack_keys(keys: torch.Tensor) -> torch.Tensor:
    """(..., d) int32 keys -> (...,) int64 for d <= 3, else (..., 2) int64
    columns; the order of the columns, lexicographic, is the keys'."""
    d = keys.shape[-1]
    if d > 2 * _COLUMN_FIELDS:
        raise ValueError(f"packed keys hold at most {2 * _COLUMN_FIELDS} coordinates, got d={d}")
    cols = []
    for c0 in range(0, d, _COLUMN_FIELDS):
        packed = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
        for i in range(c0, min(c0 + _COLUMN_FIELDS, d)):
            packed = (packed << _FIELD_BITS) | (keys[..., i].to(torch.int64) + _FIELD_OFFSET)
        cols.append(packed)
    return cols[0] if len(cols) == 1 else torch.stack(cols, dim=-1)


def pack_key_table(keys: torch.Tensor) -> torch.Tensor:
    """:func:`pack_keys` of a (capacity, d) key table whose empty rows
    (``SENTINEL``) pack to ``_PACKED_SENTINEL`` in every column."""
    packed = pack_keys(keys)
    empty = keys[:, 0] == SENTINEL
    return torch.where(empty if packed.dim() == 1 else empty[:, None], _PACKED_SENTINEL, packed)


def unpack_keys(packed: torch.Tensor, pos_dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_keys` (sentinel rows are not special-cased)."""
    cols = [packed] if key_columns(pos_dim) == 1 else packed.unbind(-1)
    out = []
    for j, col in enumerate(cols):
        nf = min(_COLUMN_FIELDS, pos_dim - j * _COLUMN_FIELDS)
        out += [((col >> (_FIELD_BITS * (nf - 1 - i))) & 0xFFFF) - _FIELD_OFFSET for i in range(nf)]
    return torch.stack(out, dim=-1).to(torch.int32)


def _sort_packed(packed: torch.Tensor):
    """Stable lexicographic sort of (M,) or (M, n) int64 packed keys:
    ``(sorted, order)``.  Several columns sort as stable sorts from the last
    column to the first."""
    if packed.dim() == 1:
        return torch.sort(packed, stable=True)
    with tracing.span(tracing.BUILD_SORT2):
        order = torch.argsort(packed[:, -1], stable=True)
        for j in range(packed.shape[1] - 2, -1, -1):
            order = order[torch.argsort(packed[order, j], stable=True)]
        return packed[order], order


def _packed_valid(sp: torch.Tensor) -> torch.Tensor:
    return (sp if sp.dim() == 1 else sp[:, 0]) != _PACKED_SENTINEL


def _packed_differs(sp: torch.Tensor) -> torch.Tensor:
    """(M - 1,) True where a sorted key differs from the one before it."""
    ne = sp[1:] != sp[:-1]
    return ne if sp.dim() == 1 else ne.any(-1)


# Inside static_general_branches() every data-dependent fast path of the
# build takes its general branch, with no host read (the JAX package's
# _cond_general rule): batches of clouds trace under it there
_STATIC_GENERAL = contextvars.ContextVar("lnt_static_general", default=False)


@contextlib.contextmanager
def static_general_branches():
    """Builds inside the block take the general branch of every
    data-dependent fast path: the coarse levels re-splat every point, and
    the canonical build sorts every edge.  The outputs are the same; no
    overflow count is read back to the host."""
    tok = _STATIC_GENERAL.set(True)
    try:
        yield
    finally:
        _STATIC_GENERAL.reset(tok)


def _read_count(t: torch.Tensor) -> int:
    """The build's one host read: an overflow count that picks a fast path
    or its general fallback (never inside :func:`static_general_branches`)."""
    with tracing.span(tracing.HOST_READ):
        return int(t)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatticeStructure:
    """Topology of one lattice level (``LatticeStructure`` of the JAX package).

    ``packed`` is the int64 form of ``keys`` (:func:`pack_keys`) and takes
    the place of the JAX package's pair-packed ``keys2``."""

    keys: torch.Tensor  # (capacity, d) int32, sorted; SENTINEL rows last
    # (capacity,) int64 for d <= 3, (capacity, 2) for d > 3; sorted,
    # _PACKED_SENTINEL rows last
    packed: torch.Tensor
    nr_verts: torch.Tensor  # () int32
    nr_overflow: torch.Tensor  # () int32
    sigma: torch.Tensor  # (d,) float32
    capacity: int
    pos_dim: int
    lvl: int

    def occupancy_mask(self) -> torch.Tensor:
        """(capacity,) bool, True for real vertices."""
        ar = torch.arange(self.capacity, dtype=torch.int32, device=self.keys.device)
        return ar < self.nr_verts

    def lookup(self, query_keys: torch.Tensor) -> torch.Tensor:
        """Resolve (..., d) int32 keys to row indices; misses -> capacity.

        The JAX package's direct lookup (a binary search on the table) and
        its merged lookup (one sort of [table; queries]) give the same ids;
        here both are :meth:`merge_lookup`."""
        return self.merge_lookup(query_keys)

    def merge_lookup(self, query_keys: torch.Tensor) -> torch.Tensor:
        """Resolve (..., d) int32 keys to row indices; misses -> capacity.

        One binary search per query on the sorted packed table: for
        one-column keys (d <= 3) ``torch.searchsorted`` plus an equality
        test, for two columns :func:`~lattice_net_tpu_torch.ops_cuda.lookup.lookup2`
        over the first ``nr_verts`` rows."""
        q = pack_keys(query_keys)
        if q.dim() == query_keys.dim():
            with tracing.span(tracing.BUILD_LOOKUP2):
                return lookup.lookup2(self.packed, self.nr_verts, q.reshape(-1, 2)).reshape(query_keys.shape[:-1])
        pos = torch.searchsorted(self.packed, q.reshape(-1)).reshape(q.shape)
        hit = self.packed[pos.clamp(max=self.capacity - 1)] == q
        found = (pos < self.capacity) & hit
        return torch.where(found, pos, self.capacity).to(torch.int32)


@dataclasses.dataclass
class EdgeSort:
    """The (point, simplex-vertex) edges of level 0, sorted by vertex id.

    Downstream segment reductions (local mean, PointNet max-pool) are run
    reductions over this order."""

    # sorted position -> original flat edge index (edge e = point e // (d+1));
    # on rows of invalid edges 0 or the edge's own index, as in the reference
    perm: torch.Tensor  # (M,) int32
    # vertex id per sorted position; nondecreasing, invalid/overflow = capacity
    vertex: torch.Tensor  # (M,) int32
    # last sorted position of each vertex's run; -1 for rows >= nr_verts
    ends: torch.Tensor  # (capacity,) int32
    # [point_feats..., bary weight] per sorted edge, or None
    rows: Any = None  # (M, F + 1) float32
    # barycentric weight per sorted edge, or None (no build here makes it: the
    # distribute reads it from its rows, or folds splat_weights into its
    # row gather)
    weights: Any = None  # (M,) float32
    # ``ends`` made nondecreasing (the cummax of ``ends``): rows >= nr_verts
    # take the last vertex's end, so their runs are empty; computed once here
    # for every run reduction of the forward
    run_end: torch.Tensor = dataclasses.field(init=False)  # (capacity,) int32

    def __post_init__(self):
        # ends rise on the vertex prefix and are -1 past it, so the cummax is
        # the prefix's last end filled into the tail
        self.run_end = torch.where(self.ends >= 0, self.ends, self.ends.max())


@dataclasses.dataclass
class LatticeHierarchy:
    """All structures and index tables the LNN forward needs, for one cloud."""

    structures: tuple  # finest first; nr_levels + 1 entries
    neighbors_same: tuple  # per level (capacity_l, 2(d+1)) int32
    neighbors_coarsen: tuple  # [i]: (capacity_{i+1}, 2(d+1)+1) ids into level i
    neighbors_finefy: tuple  # [i]: (capacity_i, 2(d+1)+1) ids into level i+1
    splat_idx: torch.Tensor  # (N, d+1) int32, invalid = capacity_0
    splat_weights: torch.Tensor  # (N, d+1) float32
    point_mask: torch.Tensor  # (N,) bool
    edges: Any = None  # EdgeSort of level 0


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_structure(
    positions: torch.Tensor,
    sigma,
    capacity: int,
    lvl: int = 0,
    point_mask: torch.Tensor | None = None,
    with_edges: bool = False,
    point_feats: torch.Tensor | None = None,
    need_point_maps: bool = False,
):
    """Build one lattice level from raw (N, d) positions.

    Returns ``(structure, splat_idx, splat_weights, edges)``: the point ->
    vertex map, the barycentric weights and the level's :class:`EdgeSort`
    with ``with_edges`` (level 0); the map and the weights without the edges
    with ``need_point_maps``; three Nones without either (coarse levels need
    only the key table).
    """
    n, d = positions.shape
    sigma = torch.as_tensor(sigma, dtype=positions.dtype, device=positions.device)
    sigma = sigma.broadcast_to((d,))
    keys, bary = permutohedral.splat_coords(positions / sigma)  # (N, d+1, d), (N, d+1)
    edge_feats = None
    if point_feats is not None and with_edges:
        d1 = d + 1
        f = point_feats.shape[1]
        per_edge = point_feats.to(torch.float32)[:, None, :].expand(n, d1, f)
        edge_feats = torch.cat(
            [per_edge.reshape(n * d1, f), bary.reshape(n * d1, 1).to(torch.float32)], dim=1
        )
    structure, vid, edges = _dedup_build(
        keys, sigma, capacity, lvl, point_mask, with_edges, edge_feats, need_point_maps
    )
    if vid is None:
        return structure, None, None, None
    return structure, vid, bary, edges


def build_structure_from_elevated(
    elevated: torch.Tensor,
    sigma,
    capacity: int,
    lvl: int,
    point_mask: torch.Tensor | None = None,
) -> LatticeStructure:
    """The key table of a level built from points already in elevated
    (H_d) coordinates."""
    d = elevated.shape[-1] - 1
    keys, _ = permutohedral.splat_coords_elevated(elevated)
    sigma = torch.as_tensor(sigma, device=elevated.device).broadcast_to((d,)).to(elevated.dtype)
    return _dedup_build(keys, sigma, capacity, lvl, point_mask, False)[0]


def _dedup_build(
    keys: torch.Tensor,
    sigma: torch.Tensor,
    capacity: int,
    lvl: int,
    point_mask: torch.Tensor | None,
    with_edges: bool,
    edge_feats: torch.Tensor | None = None,
    need_point_maps: bool = False,
):
    """(N, d+1, d) simplex keys -> sorted, deduplicated key table.

    Returns ``(structure, splat_idx (N, d+1), edges)``: both None without
    ``with_edges`` or ``need_point_maps``, the edges None without
    ``with_edges``."""
    n, d1, d = keys.shape
    m = n * d1
    dev = keys.device
    packed = pack_keys(keys)  # edge-major: e = point * (d+1) + corner
    packed = packed.reshape((m,) + packed.shape[2:])
    if point_mask is not None:
        edge_valid = point_mask[:, None].expand(n, d1).reshape(m)
        packed = torch.where(edge_valid if packed.dim() == 1 else edge_valid[:, None], packed, _PACKED_SENTINEL)

    # stable: equal keys keep edge-index order, the reference's (key, edge) order
    spacked, order = _sort_packed(packed)
    svalid = _packed_valid(spacked)
    differs = _packed_differs(spacked)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = svalid & torch.cat([true1, differs])
    uid = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    nr_unique = is_new.sum(dtype=torch.int32)
    nr_verts = torch.clamp(nr_unique, max=capacity)
    nr_overflow = nr_unique - nr_verts

    # per-vertex run ends; one end per vertex
    is_last = torch.cat([differs, true1]) & svalid
    real_end = is_last & (uid < capacity)
    # the real ends carry their (distinct, dense) vertex id as the key and
    # every other row a larger one: the sorted positions' first nr_verts
    # entries are the ends in vertex order
    end_key = torch.where(real_end, uid, SENTINEL)
    end_pos = torch.sort(end_key, stable=True)[1].to(torch.int32)
    if capacity > m:
        end_pos = torch.cat([end_pos, end_pos.new_full((capacity - m,), -1)])
    ar = torch.arange(capacity, dtype=torch.int32, device=dev)
    ends = torch.where(ar < nr_verts, end_pos[:capacity], -1)

    present = ends >= 0
    gathered = spacked[ends.clamp(min=0)]
    packed_table = torch.where(present if gathered.dim() == 1 else present[:, None], gathered, _PACKED_SENTINEL)
    keys_table = torch.where(present[:, None], unpack_keys(packed_table, d), SENTINEL)
    structure = LatticeStructure(
        keys=keys_table,
        packed=packed_table,
        nr_verts=nr_verts,
        nr_overflow=nr_overflow,
        sigma=sigma,
        capacity=capacity,
        pos_dim=d,
        lvl=lvl,
    )
    if not (with_edges or need_point_maps):
        return structure, None, None

    uid_ok = torch.where(svalid & (uid < capacity), uid, capacity)
    vid = torch.empty(m, dtype=torch.int32, device=dev).scatter_(0, order, uid_ok)
    if not with_edges:
        return structure, vid.reshape(n, d1), None
    # the edge index of an invalid row is JAX's: 0 where its folded sort ran
    # (odd d, the last key column within the fold's range, outside
    # static_general_branches), else the row's own; no consumer reads it
    bits_k = 31 - max(1, m - 1).bit_length()
    if d % 2 == 1 and bits_k >= 10 and not _STATIC_GENERAL.get():
        solo = keys[:, :, d - 1].reshape(m).to(torch.int64)
        if point_mask is not None:
            solo = torch.where(edge_valid, solo, 0)
        keep = svalid | (solo.abs().max() >= (1 << (bits_k - 1)) - 1)
    else:
        keep = torch.ones_like(svalid)
    edges = EdgeSort(
        perm=torch.where(keep, order, 0).to(torch.int32),
        vertex=uid_ok,
        ends=ends,
        rows=None if edge_feats is None else edge_feats[order],
    )
    return structure, vid.reshape(n, d1), edges


# ---------------------------------------------------------------------------
# neighbour tables
# ---------------------------------------------------------------------------


def _axis_moves(pos_dim: int, device) -> torch.Tensor:
    """(d+1, d) int32: the '+' move along each of the d+1 lattice axes."""
    moves = torch.ones((pos_dim + 1, pos_dim), dtype=torch.int32, device=device)
    for a in range(pos_dim):
        moves[a, a] = -pos_dim
    return moves


def _interleave_neighbors(idx_plus: torch.Tensor, idx_minus: torch.Tensor) -> torch.Tensor:
    """Per-axis +/- ids as [a0+, a0-, a1+, a1-, ...] (the reference im2row layout)."""
    v, d1 = idx_plus.shape
    return torch.stack([idx_plus, idx_minus], dim=-1).reshape(v, 2 * d1)


def _lookup_rows(table: LatticeStructure, queries: torch.Tensor, valid_rows: torch.Tensor):
    """(Q, K, d) lookups into ``table``; rows where ``valid_rows`` is False
    read ``table.capacity``."""
    idx = table.merge_lookup(queries)
    return torch.where(valid_rows[:, None], idx, table.capacity)


def build_neighbors_same_level(s: LatticeStructure) -> torch.Tensor:
    """(capacity, 2(d+1)) same-level neighbour ids; rows past ``nr_verts``
    are all invalid.

    Only the '+' moves are looked up; the '-' table follows by symmetry
    (u = v + m_a <=> v = u - m_a) through one collision-free scatter whose
    misses land in the dropped block past ``capacity``."""
    d, cap = s.pos_dim, s.capacity
    d1 = d + 1
    dev = s.keys.device
    occ = s.occupancy_mask()
    # sentinel rows are zeroed first: SENTINEL + move would wrap int32
    base = torch.where(occ[:, None], s.keys, 0)
    idx_p = _lookup_rows(s, base[:, None, :] + _axis_moves(d, dev)[None], occ)
    v_ids = torch.arange(cap, dtype=torch.int32, device=dev)[:, None].expand(cap, d1)
    cols = torch.arange(d1, dtype=torch.int64, device=dev)[None, :]
    flat = (idx_p.to(torch.int64) * d1 + cols).reshape(-1)
    idx_m = torch.full(((cap + 1) * d1,), cap, dtype=torch.int32, device=dev)
    idx_m[flat] = v_ids.reshape(-1)
    nbr = _interleave_neighbors(idx_p, idx_m.reshape(cap + 1, d1)[:cap])
    return torch.where(occ[:, None], nbr, cap)


def build_neighbors_coarse_from_fine(coarse: LatticeStructure, fine: LatticeStructure) -> torch.Tensor:
    """(capacity_coarse, 2(d+1)+1) ids into the FINE table for coarsen convs:
    a coarse vertex at key k sits at fine key 2k; its patch is the fine
    vertices at 2k +/- each axis move, then the centre 2k."""
    d1 = coarse.pos_dim + 1
    moves = _axis_moves(coarse.pos_dim, coarse.keys.device)
    occ = coarse.occupancy_mask()
    base = torch.where(occ[:, None], coarse.keys, 0) * 2
    cand = torch.cat(
        [base[:, None, :] + moves[None], base[:, None, :] - moves[None], base[:, None, :]], dim=1
    )
    idx = _lookup_rows(fine, cand, occ)
    idx_p, idx_m, center = idx[:, :d1], idx[:, d1 : 2 * d1], idx[:, 2 * d1]
    nbr = torch.cat([_interleave_neighbors(idx_p, idx_m), center[:, None]], dim=-1)
    return torch.where(occ[:, None], nbr, fine.capacity)


def build_neighbors_fine_from_coarse(fine: LatticeStructure, coarse: LatticeStructure):
    """(capacity_fine, 2(d+1)+1) ids into the COARSE table for finefy convs,
    by direct lookup (:meth:`LatticeStructure.lookup`): a fine key k maps to
    the coarse key k/2 only where every coordinate is even (the implicit one
    then is too), so each candidate (k +/- move, then k) is halved where it
    is even and misses elsewhere.  ``build_hierarchy`` takes the finefy
    tables as transposes of the coarsen tables instead."""
    moves = _axis_moves(fine.pos_dim, fine.keys.device)
    occ = fine.occupancy_mask()
    keys = torch.where(occ[:, None], fine.keys, 0)

    def lookup_half(cand):
        even = (cand % 2 == 0).all(-1)
        idx = coarse.lookup(torch.div(cand, 2, rounding_mode="floor"))
        return torch.where(even, idx, coarse.capacity)

    idx_p = lookup_half(keys[:, None, :] + moves[None])
    idx_m = lookup_half(keys[:, None, :] - moves[None])
    center = lookup_half(keys)
    nbr = torch.cat([_interleave_neighbors(idx_p, idx_m), center[:, None]], dim=-1)
    return torch.where(occ[:, None], nbr, coarse.capacity).to(torch.int32)


def finefy_from_coarsen_transpose(
    coarsen_table: torch.Tensor, cap_fine: int, cap_coarse: int
) -> torch.Tensor:
    """The finefy table as the exact transpose of the coarsen table:
    finefy[f][+a] = c <=> coarsen[c][-a] = f, centre <-> centre."""
    cc, extent = coarsen_table.shape
    d1 = (extent - 1) // 2
    dev = coarsen_table.device
    swap = list(range(extent))
    swap[0 : 2 * d1 : 2] = range(1, 2 * d1, 2)
    swap[1 : 2 * d1 : 2] = range(0, 2 * d1, 2)
    src = coarsen_table[:, swap].to(torch.int64)
    c_ids = torch.arange(cc, dtype=torch.int32, device=dev)[:, None].expand(cc, extent)
    cols = torch.arange(extent, dtype=torch.int64, device=dev)[None, :]
    flat = (src * extent + cols).reshape(-1)  # src == cap_fine lands in the dropped block
    out = torch.full(((cap_fine + 1) * extent,), cap_coarse, dtype=torch.int32, device=dev)
    out[flat] = c_ids.reshape(-1)
    return out.reshape(cap_fine + 1, extent)[:cap_fine]


def default_capacity_schedule(capacity: int, nr_levels: int, minimum: int = 256) -> tuple:
    """Halve capacity per coarsening level."""
    return tuple(max(minimum, capacity >> lvl) for lvl in range(nr_levels + 1))


def capacity_schedule_from_occupancy(
    occupancy: Sequence[int], headroom: float = 2.0, minimum: int = 256, snap_pow2: bool = True
) -> tuple:
    """Per-level capacities from measured occupancy: ``headroom`` times each
    level's vertex count, at least ``minimum``, snapped up to a power of two
    (or to a multiple of 256 without ``snap_pow2``).  Every per-vertex array
    is as long as its capacity, so capacities near the occupancy save the
    work a worst-case schedule pads in."""
    caps = []
    for occ in occupancy:
        want = max(minimum, int(math.ceil(max(int(occ), 1) * headroom)))
        if snap_pow2:
            want = 1 << (want - 1).bit_length()
        else:
            want = -(-want // 256) * 256
        caps.append(max(minimum, want))
    return tuple(caps)


def escalate_capacities(
    capacities: Sequence[int],
    overflow: Sequence[int],
    occupancy: Sequence[int] | None = None,
    headroom: float = 1.5,
) -> tuple:
    """Grow every level that overflowed.  The builders count the vertices
    that did not fit, so with ``occupancy`` the exact count is occupancy +
    overflow and one escalation suffices; without it, double."""
    if occupancy is not None:
        return tuple(
            c if int(o) == 0 else capacity_schedule_from_occupancy([int(n) + int(o)], headroom)[0]
            for c, o, n in zip(capacities, overflow, occupancy)
        )
    return tuple(c * 2 if int(o) > 0 else c for c, o in zip(capacities, overflow))


def compact_hierarchy(h: LatticeHierarchy, new_capacities: Sequence[int]) -> LatticeHierarchy:
    """Re-pack a hierarchy into smaller per-level capacities by slicing.

    The builders store the vertices densely at the front of each table, so
    shrinking a level slices every per-vertex array (key tables, packed
    keys, neighbour tables, the edge sort's run ends) to the new row count
    and clamps the invalid id from the old capacity to the new one (valid
    ids are below ``nr_verts``, so ``min`` is exact).  Vertices past a new
    capacity are counted in ``nr_overflow``."""
    caps = tuple(int(c) for c in new_capacities)
    if len(caps) != len(h.structures):
        raise ValueError(f"need {len(h.structures)} capacities, got {len(caps)}")
    for st, nc in zip(h.structures, caps):
        if nc > st.capacity:
            raise ValueError(f"compact_hierarchy only shrinks: level {st.lvl} {st.capacity} -> {nc}")

    def clamp(idx, cap):
        return torch.clamp(idx, max=cap)

    structures = tuple(
        dataclasses.replace(
            st,
            keys=st.keys[:nc],
            packed=st.packed[:nc],
            nr_verts=torch.clamp(st.nr_verts, max=nc),
            nr_overflow=st.nr_overflow + torch.clamp(st.nr_verts - nc, min=0),
            capacity=nc,
        )
        for st, nc in zip(h.structures, caps)
    )
    edges = h.edges
    if edges is not None:
        edges = EdgeSort(
            perm=edges.perm, vertex=clamp(edges.vertex, caps[0]), ends=edges.ends[: caps[0]],
            rows=edges.rows, weights=edges.weights,
        )  # fmt: skip
    return LatticeHierarchy(
        structures=structures,
        neighbors_same=tuple(clamp(t[:nc], nc) for t, nc in zip(h.neighbors_same, caps)),
        # coarsen[i]: rows on level i+1, ids into level i; finefy[i] the mirror
        neighbors_coarsen=tuple(
            clamp(t[: caps[i + 1]], caps[i]) for i, t in enumerate(h.neighbors_coarsen)
        ),
        neighbors_finefy=tuple(
            clamp(t[: caps[i]], caps[i + 1]) for i, t in enumerate(h.neighbors_finefy)
        ),
        splat_idx=None if h.splat_idx is None else clamp(h.splat_idx, caps[0]),
        splat_weights=h.splat_weights,
        point_mask=h.point_mask,
        edges=edges,
    )


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------


def _simplex_reps(
    positions: torch.Tensor,
    sigma: torch.Tensor,
    splat_idx: torch.Tensor,
    point_mask: torch.Tensor,
    structure0: LatticeStructure,
    s_cap: int,
):
    """One barycenter per occupied level-0 simplex.

    The triangulations at sigma and 2 sigma are nested, so the coarse vertex
    set is a function of the occupied level-0 simplices: re-splatting one
    interior point (the barycenter) per simplex gives the same coarse keys.
    A simplex is the signature (remainder-0 vertex id, packed rank), and its
    barycenter in level-0 elevated coordinates is ``rem0 + d/2 - rank``.

    Returns ``valid`` (s_cap,) bool, ``bary_elev`` (s_cap, d+1) and
    ``overflow`` () int: nonzero means the slots ran out or a point's level-0
    vertex overflowed, and the caller re-splats every point instead.
    """
    n, d = positions.shape
    dev = positions.device
    cap0 = structure0.capacity
    bpe = max(1, d.bit_length())  # bits per rank entry
    rbits = bpe * (d + 1)
    _, rank, _ = permutohedral.find_enclosing_simplex(permutohedral.elevate(positions / sigma))
    w = torch.tensor([1 << (bpe * i) for i in range(d + 1)], dtype=torch.int64, device=dev)
    packed_rank = (rank.to(torch.int64) * w).sum(-1)
    id0 = splat_idx[:, 0].to(torch.int64)
    sentinel = torch.iinfo(torch.int64).max
    sig = torch.where(point_mask & (id0 < cap0), (id0 << rbits) + packed_rank, sentinel)
    n_bad = (point_mask & (id0 >= cap0)).sum()

    ssig, _ = torch.sort(sig)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = (ssig != sentinel) & torch.cat([true1, ssig[1:] != ssig[:-1]])
    rrank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    s_count = is_new.sum()
    slot = torch.where(is_new & (rrank < s_cap), rrank, s_cap)
    usig = torch.full((s_cap + 1,), sentinel, dtype=torch.int64, device=dev)
    usig = usig.scatter_reduce(0, slot, ssig, "amin")[:s_cap]
    overflow = s_count - torch.clamp(s_count, max=s_cap) + n_bad

    valid = usig != sentinel
    uid0 = torch.where(valid, usig >> rbits, 0)
    urank_packed = torch.where(valid, usig & ((1 << rbits) - 1), 0)
    shifts = torch.tensor([bpe * i for i in range(d + 1)], dtype=torch.int64, device=dev)
    urank = (urank_packed[:, None] >> shifts[None, :]) & ((1 << bpe) - 1)
    rem0 = structure0.keys[uid0]
    rem0_full = torch.cat([rem0, -rem0.sum(-1, keepdim=True, dtype=torch.int32)], dim=-1)
    f = positions.dtype
    bary_elev = rem0_full.to(f) + d / 2.0 - urank.to(f)
    return valid, bary_elev, overflow


def canonical_point_order(
    positions: torch.Tensor, sigma, point_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(N,) int64 permutation sorting points by (level-0 simplex, rank): the
    remainder-0 key, lexicographic, then the packed rank (entry d most
    significant), ties in input order.  Points of one simplex become
    adjacent, which the corner-dedup fast build (``build_hierarchy(...,
    canonical_points=True)``) needs to be fast, not to be right.  With
    ``point_mask``, masked points sort strictly last, so the reordered mask
    is a prefix, the fast build's precondition.  The lattice is permutation
    invariant: outputs come back in input order by the inverse permutation."""
    n, d = positions.shape
    sigma = torch.as_tensor(sigma, dtype=positions.dtype, device=positions.device)
    elev = permutohedral.elevate(positions / sigma.broadcast_to((d,)))
    rem0, rank, _ = permutohedral.find_enclosing_simplex(elev)
    bpe = max(1, d.bit_length())
    w = torch.tensor([1 << (bpe * i) for i in range(d + 1)], dtype=torch.int64, device=positions.device)
    rank_packed = (rank.to(torch.int64) * w).sum(-1)
    packed = pack_keys(rem0[:, :d])
    if packed.dim() == 1:
        key = (packed << (bpe * (d + 1))) | rank_packed
    else:  # two key columns: the packed rank is a third
        key = torch.cat([packed, rank_packed[:, None]], dim=1)
    if point_mask is not None:
        key = torch.where(point_mask if key.dim() == 1 else point_mask[:, None], key, _PACKED_SENTINEL)
    return _sort_packed(key)[1]


def _canonical_fast_build(positions, sigma, capacity: int, s_cap: int, point_mask):
    """Level-0 build for canonically ordered points: dedup one corner set
    per occupied SIMPLEX instead of one key per (point, vertex) edge.

    Points of a simplex are adjacent, so the simplex runs fall out of one
    adjacent-equality pass; the table is the dedup of the runs' (d+1) corner
    keys (closed form from rem0 and rank), and the sorted edge stream is
    rebuilt by expanding the sorted corner blocks with their run lengths.
    An order that is not canonical only fragments runs (duplicate corner
    sets dedup to the same vertices).  The precondition is that masked
    points form a suffix.  Where the runs outnumber ``s_cap`` (one host
    read), the generic full-stream build runs instead, with the same
    outputs.  Its :class:`EdgeSort` carries no rows.

    Returns ``(structure, splat_idx, bary, edges, runs)`` with ``runs =
    (run_valid (s_cap,), rem0_runs (s_cap, d+1), rank_runs (s_cap, d+1),
    overflow)``, ``overflow`` a host int, for the coarse levels' barycenters."""
    n, d = positions.shape
    d1 = d + 1
    m = n * d1
    dev = positions.device
    rem0, rank, bary = permutohedral.find_enclosing_simplex(permutohedral.elevate(positions / sigma))
    same = (rem0[1:] == rem0[:-1]).all(-1) & (rank[1:] == rank[:-1]).all(-1)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = point_mask & torch.cat([true1, ~same])
    runid_raw = torch.cumsum(is_new.to(torch.int64), 0) - 1
    runid = torch.where(point_mask & (runid_raw < s_cap), runid_raw, s_cap)
    n_runs = is_new.sum()
    ii = torch.arange(n, dtype=torch.int64, device=dev)
    run_start = torch.full((s_cap + 1,), n, dtype=torch.int64, device=dev)
    run_start = run_start.scatter_reduce(0, runid, ii, "amin")[:s_cap]
    run_end = torch.full((s_cap + 1,), -1, dtype=torch.int64, device=dev)
    run_end = run_end.scatter_reduce(0, runid, ii, "amax")[:s_cap]
    run_valid = torch.arange(s_cap, device=dev) < torch.clamp(n_runs, max=s_cap)
    run_len = torch.where(run_valid, run_end - run_start + 1, 0)
    rs = run_start.clamp(max=n - 1)
    rem0_runs, rank_runs = rem0[rs], rank[rs]
    # host read: picks the branch; None (no read) inside static_general_branches
    overflow = None if _STATIC_GENERAL.get() else _read_count(torch.clamp(n_runs - s_cap, min=0))
    runs = (run_valid, rem0_runs, rank_runs, overflow)

    if overflow != 0:
        with tracing.span(tracing.BUILD_FALLBACK) if overflow is not None else contextlib.nullcontext():
            keys = permutohedral.vertex_keys(rem0, rank)
            structure, splat_idx, edges = _dedup_build(keys, sigma, capacity, 0, point_mask, True)
        return structure, splat_idx, bary, edges, runs

    corner_keys = permutohedral.vertex_keys(rem0_runs, rank_runs)
    structure, corner_vid, edges_b = _dedup_build(corner_keys, sigma, capacity, 0, run_valid, True)
    # every point of a run shares the run's corner ids
    splat_idx = torch.where((runid < s_cap)[:, None], corner_vid[runid.clamp(max=s_cap - 1)], capacity)

    # expand the sorted corner blocks (one per (run, corner)) into the
    # sorted edge stream: block b covers run_len edges from bstart
    b_sorted = edges_b.perm.to(torch.int64)
    v_sorted = edges_b.vertex
    r_of, j_of = b_sorted // d1, b_sorted % d1
    bsz = torch.where(v_sorted < capacity, run_len[r_of], 0)
    csum = torch.cumsum(bsz, 0)
    bstart = csum - bsz
    live = bsz > 0
    at = torch.where(live, bstart, m)
    seq = torch.arange(b_sorted.shape[0], dtype=torch.int64, device=dev)
    mark = torch.full((m + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(0, at, seq, "amax")
    b_of = torch.cummax(mark[:m], 0)[0].clamp(min=0)
    vmark = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    vmark = vmark.scatter_reduce(0, at, v_sorted.to(torch.int64), "amax")
    ie = torch.arange(m, dtype=torch.int64, device=dev)
    in_range = ie < csum[-1]
    vertex = torch.where(in_range, torch.cummax(vmark[:m], 0)[0], capacity)
    point = (run_start[r_of] - bstart)[b_of] + ie
    perm = torch.where(in_range, point * d1 + j_of[b_of], 0)
    ends = torch.full((capacity + 1,), -1, dtype=torch.int64, device=dev)
    ends = ends.scatter_reduce(0, torch.where(live, v_sorted.to(torch.int64), capacity),
                               bstart + bsz - 1, "amax")[:capacity]  # fmt: skip
    edges = EdgeSort(perm=perm.to(torch.int32), vertex=vertex.to(torch.int32), ends=ends.to(torch.int32))
    return structure, splat_idx, bary, edges, runs


def build_hierarchy(
    positions: torch.Tensor,
    sigma,
    nr_levels: int,
    capacities: Sequence[int],
    point_mask: torch.Tensor | None = None,
    point_feats: torch.Tensor | None = None,
    coarse_mode: str | None = None,
    coarse_from_vertices: bool = False,
    canonical_points: bool = False,
) -> LatticeHierarchy:
    """Build every level and every index table of one cloud.

    Level 0 comes from the points, with the edge sort and, given
    ``point_feats``, the carried rows ``[positions, point_feats, bary]``.  With
    ``canonical_points`` (points ordered by :func:`canonical_point_order`,
    masked ones last) it comes from the corner-dedup fast build, whose edge
    sort carries no rows.

    ``coarse_mode`` builds the coarse levels:

    * ``"resplat"``: re-splat every point at sigma * 2^l;
    * ``"simplex"``: re-splat one barycenter per occupied level-0 simplex
      (the nested triangulations give the same key set); it needs d == 3
      and a (vertex id, rank) signature of at most 30 bits, and falls back
      to the re-splat when the rep slots run out;
    * ``"auto"`` (default): ``"simplex"`` where it is allowed, else
      ``"resplat"``;
    * ``"vertices"`` (``coarse_from_vertices=True``): splat the previous
      level's vertices, the reference's approximation, which misses some
      reachable coarse vertices.

    Neighbour tables come by lookup, one binary search a query per table
    (the JAX package's merged and direct lookups give the same tables),
    finefy tables as transposes of the coarsen tables.

    Tensors stay on ``positions.device``.  At most one host read happens:
    the simplex-rep overflow (or the canonical build's run overflow), which
    picks the fallback (the JAX package keeps both branches on the device
    under ``lax.cond``).  Inside :func:`static_general_branches` none
    happens: the coarse levels re-splat every point, as the fallback does.
    """
    with tracing.span(tracing.BUILD):
        n, d = positions.shape
        if len(capacities) != nr_levels + 1:
            raise ValueError(f"need {nr_levels + 1} capacities, got {len(capacities)}")
        mask_given = point_mask is not None
        if point_mask is None:
            point_mask = torch.ones(n, dtype=torch.bool, device=positions.device)
        if point_feats is not None:
            point_feats = torch.cat([positions, point_feats.to(positions.dtype)], dim=-1)

        if coarse_mode is None:
            coarse_mode = "vertices" if coarse_from_vertices else "auto"
        # the (vertex id, rank) signature of the simplex reps must fit 30 bits
        bpe = max(1, d.bit_length())
        sig_bits = bpe * (d + 1) + (int(capacities[0]) + 1).bit_length()
        simplex_ok = d == 3 and sig_bits <= 30
        if coarse_mode == "auto":
            coarse_mode = "simplex" if simplex_ok else "resplat"
        elif coarse_mode == "simplex" and not simplex_ok:
            raise ValueError(
                f"coarse_mode='simplex' needs d == 3 and a 31-bit signature "
                f"(d={d}, sig_bits={sig_bits}, capacity={int(capacities[0])}); "
                "use coarse_mode='resplat' for this configuration"
            )
        if coarse_mode not in ("resplat", "simplex", "vertices"):
            raise ValueError(f"unknown coarse_mode {coarse_mode!r}")

        sigma = torch.as_tensor(sigma, dtype=positions.dtype, device=positions.device)
        sigma = sigma.broadcast_to((d,))
        s_cap = min(n, max(256, int(capacities[0]) // 2))

        reps = None  # (valid, level-0 elevated barycenters) of the simplex reps
        missed = False  # the simplex reps overflowed: the coarse levels re-splat every point
        with tracing.span(tracing.BUILD_LEVEL0):
            if canonical_points:
                s0, splat_idx, splat_w, edges, runs = _canonical_fast_build(
                    positions, sigma, int(capacities[0]), s_cap, point_mask
                )
                run_valid, rem0_runs, rank_runs, run_overflow = runs
                if coarse_mode == "simplex" and run_overflow == 0:
                    f = positions.dtype
                    reps = (run_valid, rem0_runs.to(f) + d / 2.0 - rank_runs.to(f))
            else:
                s0, splat_idx, splat_w, edges = build_structure(
                    positions, sigma, int(capacities[0]), lvl=0,
                    point_mask=point_mask if mask_given else None, with_edges=True, point_feats=point_feats,
                )  # fmt: skip
                if coarse_mode == "simplex" and nr_levels > 0 and not _STATIC_GENERAL.get():
                    rep_valid, bary_elev, rep_overflow = _simplex_reps(
                        positions, sigma, splat_idx, point_mask, s0, s_cap
                    )
                    if _read_count(rep_overflow) == 0:  # host read: the fallback is data-dependent
                        reps = (rep_valid, bary_elev)
                    else:
                        missed = True
        structures = [s0]
        fallback = tracing.span(tracing.BUILD_FALLBACK) if missed else contextlib.nullcontext()
        with tracing.span(tracing.BUILD_COARSE), fallback:
            for lvl in range(1, nr_levels + 1):
                scale = 2.0**lvl
                cap = int(capacities[lvl])
                if coarse_mode == "vertices":
                    prev = structures[-1]
                    occ = prev.occupancy_mask()
                    k = torch.where(occ[:, None], prev.keys, 0)
                    elevated = torch.cat([k, -k.sum(-1, keepdim=True, dtype=torch.int32)], dim=-1)
                    s = build_structure_from_elevated(
                        elevated.to(torch.float32) / 2.0, sigma * scale, cap, lvl, point_mask=occ
                    )
                elif reps is not None:
                    s = build_structure_from_elevated(
                        reps[1] / scale, sigma * scale, cap, lvl, point_mask=reps[0]
                    )
                else:
                    s = build_structure(positions, sigma * scale, cap, lvl, point_mask=point_mask)[0]
                structures.append(s)

        with tracing.span(tracing.BUILD_TABLES):
            neighbors_same = tuple(build_neighbors_same_level(s) for s in structures)
            neighbors_coarsen = tuple(
                build_neighbors_coarse_from_fine(structures[i + 1], structures[i]) for i in range(nr_levels)
            )
            neighbors_finefy = tuple(
                finefy_from_coarsen_transpose(
                    neighbors_coarsen[i], structures[i].capacity, structures[i + 1].capacity
                )
                for i in range(nr_levels)
            )
        return LatticeHierarchy(
            structures=tuple(structures),
            neighbors_same=neighbors_same,
            neighbors_coarsen=neighbors_coarsen,
            neighbors_finefy=neighbors_finefy,
            splat_idx=splat_idx,
            splat_weights=splat_w,
            point_mask=point_mask,
            edges=edges,
        )
