"""Sparse lattice structures with static shapes, built once per cloud: a
frozen copy of the port's ``lattice/structure.py`` on its default path
(``build_hierarchy`` with the automatic coarse mode, the neighbour tables
by lookup).  The outputs are the port's, row for row:

  * every per-vertex table is padded to ``capacity`` rows and vertex ids are
    assigned in sorted-key order;
  * empty key-table rows hold ``SENTINEL`` (INT32_MAX) in every column;
  * the invalid / not-found index is ``capacity``;
  * ``nr_verts`` and ``nr_overflow`` are 0-dim device tensors.

The integer keys pack into int64 columns of up to three coordinates each
(each coordinate + 2^15 in 16 bits, |k| < ``PACK_BOUND``): one column for
d <= 3, two for d = 4..6.  With one column a single stable ``torch.sort``
gives the (key, edge index) order and a lookup is a ``torch.searchsorted``
on the packed table plus an equality test.  With two, the order is two
stable sorts (the low column first) and a lookup is the merged lookup: one
sort of [table; queries].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from . import permutohedral

__all__ = ["LatticeStructure", "EdgeSort", "LatticeHierarchy", "build_hierarchy"]

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

    def merge_lookup(self, query_keys: torch.Tensor) -> torch.Tensor:
        """Resolve (..., d) int32 keys to row indices; misses -> capacity.

        One-column keys (d <= 3): one binary search per query on the sorted
        packed table.  Two columns: the JAX package's merged lookup, one
        stable sort of [table; queries] in which each query's candidate is
        the last table row at or before it."""
        q = pack_keys(query_keys)
        if q.dim() == query_keys.dim():
            return self._merged(q.reshape(-1, q.shape[-1])).reshape(query_keys.shape[:-1])
        pos = torch.searchsorted(self.packed, q.reshape(-1)).reshape(q.shape)
        hit = self.packed[pos.clamp(max=self.capacity - 1)] == q
        found = (pos < self.capacity) & hit
        return torch.where(found, pos, self.capacity).to(torch.int32)

    def _merged(self, q: torch.Tensor) -> torch.Tensor:
        """(nq, n) packed queries -> (nq,) int32 ids by the sort of [table;
        queries] (stable: a table row precedes its equal queries).  A hit is
        verified by a fill-forward of run starts; the results return to
        query order by a sort."""
        c, nq = self.capacity, q.shape[0]
        dev = q.device
        sk, sid = _sort_packed(torch.cat([self.packed, q]))
        last_table = torch.cummax(torch.where(sid < c, sid, -1), 0)[0]
        cand = last_table.clamp(min=0)
        # a query hits iff its run of equal keys starts with a table row
        # (table keys are unique): tag run starts, fill forward
        differs = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), _packed_differs(sk)])
        pos = torch.arange(c + nq, dtype=torch.int64, device=dev)
        tag = torch.where(differs, (pos << 1) | (sid < c).to(torch.int64), -1)
        eq = (torch.cummax(tag, 0)[0] & 1) == 1
        res = torch.where(eq, cand, c).to(torch.int32)
        qslot = torch.where(sid >= c, sid - c, nq)
        # the query slots are a permutation of [0, nq) with the table rows
        # at nq, past them: sorting them puts the results in order
        return res[torch.sort(qslot, stable=True)[1][:nq]]


@dataclasses.dataclass
class EdgeSort:
    """The (point, simplex-vertex) edges of level 0, sorted by vertex id.

    Downstream segment reductions (local mean, PointNet max-pool) are run
    reductions over this order."""

    # sorted position -> original flat edge index (edge e = point e // (d+1))
    perm: torch.Tensor  # (M,) int32
    # vertex id per sorted position; nondecreasing, invalid/overflow = capacity
    vertex: torch.Tensor  # (M,) int32
    # last sorted position of each vertex's run; -1 for rows >= nr_verts
    ends: torch.Tensor  # (capacity,) int32
    # [point_feats..., bary weight] per sorted edge, or None
    rows: Any = None  # (M, F + 1) float32
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
):
    """Build one lattice level from raw (N, d) positions.

    Returns ``(structure, splat_idx, splat_weights, edges)``: the point ->
    vertex map, the barycentric weights and the level's :class:`EdgeSort`
    with ``with_edges`` (level 0); three Nones without (coarse levels need
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
    structure, vid, edges = _dedup_build(keys, sigma, capacity, lvl, point_mask, with_edges, edge_feats)
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
):
    """(N, d+1, d) simplex keys -> sorted, deduplicated key table.

    Returns ``(structure, splat_idx (N, d+1), edges)``, both None without
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
    if not with_edges:
        return structure, None, None

    uid_ok = torch.where(svalid & (uid < capacity), uid, capacity)
    vid = torch.empty(m, dtype=torch.int32, device=dev).scatter_(0, order, uid_ok)
    edges = EdgeSort(
        perm=order.to(torch.int32),
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


def build_hierarchy(
    positions: torch.Tensor,
    sigma,
    nr_levels: int,
    capacities: Sequence[int],
    point_mask: torch.Tensor,
    point_feats: torch.Tensor,
) -> LatticeHierarchy:
    """Build every level and every index table of one padded cloud.

    Level 0 comes from the points, with the edge sort and the carried rows
    ``[positions, point_feats, bary]``.  The coarse levels re-splat one
    barycenter per occupied level-0 simplex (the nested triangulations give
    the same key set) where d == 3 and the (vertex id, rank) signature fits
    30 bits, and every point at sigma * 2^l otherwise or when the rep slots
    run out (one host read decides).  Neighbour tables come by lookup, one
    per table, the finefy tables as transposes of the coarsen tables.
    Tensors stay on ``positions.device``.
    """
    n, d = positions.shape
    if len(capacities) != nr_levels + 1:
        raise ValueError(f"need {nr_levels + 1} capacities, got {len(capacities)}")
    point_feats = torch.cat([positions, point_feats.to(positions.dtype)], dim=-1)
    # the (vertex id, rank) signature of the simplex reps must fit 30 bits
    bpe = max(1, d.bit_length())
    sig_bits = bpe * (d + 1) + (int(capacities[0]) + 1).bit_length()
    simplex = d == 3 and sig_bits <= 30

    sigma = torch.as_tensor(sigma, dtype=positions.dtype, device=positions.device)
    sigma = sigma.broadcast_to((d,))
    s_cap = min(n, max(256, int(capacities[0]) // 2))

    s0, splat_idx, splat_w, edges = build_structure(
        positions, sigma, int(capacities[0]), lvl=0, point_mask=point_mask, with_edges=True,
        point_feats=point_feats,
    )  # fmt: skip
    reps = None  # (valid, level-0 elevated barycenters) of the simplex reps
    if simplex and nr_levels > 0:
        rep_valid, bary_elev, rep_overflow = _simplex_reps(positions, sigma, splat_idx, point_mask, s0, s_cap)
        if int(rep_overflow) == 0:  # host read: the fallback is data-dependent
            reps = (rep_valid, bary_elev)
    structures = [s0]
    for lvl in range(1, nr_levels + 1):
        scale = 2.0**lvl
        cap = int(capacities[lvl])
        if reps is not None:
            s = build_structure_from_elevated(reps[1] / scale, sigma * scale, cap, lvl, point_mask=reps[0])
        else:
            s = build_structure(positions, sigma * scale, cap, lvl, point_mask=point_mask)[0]
        structures.append(s)

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
