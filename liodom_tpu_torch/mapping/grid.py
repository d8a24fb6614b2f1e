"""Global hash-grid map on torch tensors (port of ``liodom_tpu/mapping/grid.py``).

The reference's ``Map`` (map.cc) keeps an ``unordered_map`` of per-cell PCL
clouds and re-voxelises every modified cell at ``resolution``.  Here the map
is a fixed-shape open-addressing hash table over resolution leaves: each slot
holds one filtered point (the centroid of its 0.4 m leaf), its cell key and a
packed (cell, leaf) identity code.  An update inserts the frame's points with
a data-parallel probe loop and folds per-slot sums into the stored centroids
(a previously filtered leaf is one point of weight 1, so the fold is
VoxelGrid over {stored centroid} + {new points}).  :func:`update_map_full` is
the sorted-soup oracle the hash path is held against.

Layout: the JAX package stores the 57-bit code as two uint32 words
``(code1, code2)`` with the all-ones pair as the empty sentinel.  The port
stores one int64 ``code = code1 << 26 | code2`` (valid codes stay below
2^57) with :data:`EMPTY`, above every valid code, in empty slots; the
lexicographic-min claim of the two words becomes one ``amin`` of the code,
and the slot layout is the JAX package's, slot for slot.

The probe loop and the slot hash live in ``ops/probe_insert.py``: on CUDA
one kernel (``csrc/probe_insert.cu``) runs every round in one launch, so
the update never waits on the host; on the CPU the rounds are torch ops.
Local-map extraction (:func:`get_local_map`) runs K7
(``ops/compact_pallas.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.ops.compact_pallas import compact_hits
from liodom_tpu_torch.ops.probe_insert import EMPTY, probe_insert
from liodom_tpu_torch.runtime import tracer


class MapState(NamedTuple):
    xyz: torch.Tensor       # (C, 3) slot centroid (world frame); 0 when empty
    key: torch.Tensor       # (C, 3) int32 cell key of the slot
    valid: torch.Tensor     # (C,) bool, slot occupied
    overflow: torch.Tensor  # () int32, points dropped (probe/capacity), cum.
    code: torch.Tensor      # (C,) int64 packed (cell, leaf) code; EMPTY if free


# Packed code: bits per cell index / per-cell leaf offset (see _packed_codes).
# 12 cell bits = +-2^11 cells per axis (+-82 km at 40 m cells); 7 leaf bits
# require ceil(size/res) + 2 <= 128.
_CELL_BITS = 12
_LEAF_BITS = 7


def init_map(capacity: int, dtype=torch.float32, device=None) -> MapState:
    dev = resolve_device(device)
    return MapState(
        torch.zeros((capacity, 3), dtype=dtype, device=dev),
        torch.zeros((capacity, 3), dtype=torch.int32, device=dev),
        torch.zeros((capacity,), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.full((capacity,), EMPTY, dtype=torch.int64, device=dev),
    )


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device.  (On CUDA a
    Python-scalar divisor becomes a multiply by its reciprocal, which moves
    a ``floor`` at a cell or leaf boundary; a 0-d device tensor does not.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def cell_keys(xyz: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Per-point cell key, replicating map.cc:103-105 exactly:
    ``int(floor(p/size)*size + size/2)`` per axis (trunc toward zero)."""
    xy, z = cfg.voxel_xysize, cfg.voxel_zsize
    kx = torch.trunc(torch.floor(_div(xyz[..., 0], xy)) * xy + xy / 2.0)
    ky = torch.trunc(torch.floor(_div(xyz[..., 1], xy)) * xy + xy / 2.0)
    kz = torch.trunc(torch.floor(_div(xyz[..., 2], z)) * z + z / 2.0)
    return torch.stack([kx, ky, kz], dim=-1).to(torch.int32)


def _leaf_index(xyz: torch.Tensor, res: float) -> torch.Tensor:
    """Global-grid leaf index per axis (PCL VoxelGrid: ``floor(p / leaf)``)."""
    return torch.floor(_div(xyz, res)).to(torch.int32)


def _lex_order(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row order sorting lexicographically by cols[0] (major) .. cols[-1],
    by stable sorts from the minor to the major column."""
    order = torch.argsort(cols[-1], stable=True)
    for c in cols[-2::-1]:
        order = order[torch.argsort(c[order], stable=True)]
    return order


def packable(cfg: MapConfig) -> bool:
    """True when (cell, leaf) codes fit the packed 57-bit key layout."""
    per_leaf = max(cfg.voxel_xysize, cfg.voxel_zsize) / cfg.resolution
    return (per_leaf + 2.0) <= float(1 << _LEAF_BITS) and \
        min(cfg.voxel_xysize, cfg.voxel_zsize, cfg.resolution) >= 0.01


def _packed_codes(xyz: torch.Tensor, ok: torch.Tensor, cfg: MapConfig
                  ) -> torch.Tensor:
    """Packed (cell, leaf) identity code per point, int64: ordering by it is
    the 6-column (cell key, leaf index) lex order of ``update_map_full``.

    ``[cx | cy | cz | lrx | lry | lrz]``, 12-bit offset cell indices and
    7-bit per-cell leaf offsets, cell-major: equal codes mean the same
    (cell, leaf).  Rows not ``ok`` get :data:`EMPTY`."""
    sx, sz, res = cfg.voxel_xysize, cfg.voxel_zsize, cfg.resolution
    half_cells = 1 << (_CELL_BITS - 1)

    def axis_codes(p, size):
        c = torch.floor(_div(p, size))
        leaf = torch.floor(_div(p, res))
        base = torch.floor(_div(c * size, res))
        rel = torch.clamp((leaf - base).to(torch.int32), 0,
                          (1 << _LEAF_BITS) - 1).to(torch.int64)
        cu = torch.clamp(c.to(torch.int32) + half_cells, 0,
                         (1 << _CELL_BITS) - 1).to(torch.int64)
        return cu, rel

    cux, lrx = axis_codes(xyz[:, 0], sx)
    cuy, lry = axis_codes(xyz[:, 1], sx)
    cuz, lrz = axis_codes(xyz[:, 2], sz)
    code = ((cux << 45) | (cuy << 33) | (cuz << 21) | (lrx << 14)
            | (lry << 7) | lrz)
    return torch.where(ok, code, EMPTY)


def _decode_cell_keys(code: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Inverse of the cell part of :func:`_packed_codes`: the reference's
    meter-valued cell key (map.cc:103-105) recovered from the code, as the
    same float32 expression ``trunc(c*size + size/2)`` of the cell index."""
    sx, sz = cfg.voxel_xysize, cfg.voxel_zsize
    half = 1 << (_CELL_BITS - 1)
    cell = (1 << _CELL_BITS) - 1

    def axis_key(shift, size):
        c = (((code >> shift) & cell) - half).to(torch.float32)
        return torch.trunc(c * size + size / 2.0).to(torch.int32)

    return torch.stack([axis_key(45, sx), axis_key(33, sx),
                        axis_key(21, sz)], dim=-1)


def _slot_sums(slot: torch.Tensor, payload: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot sums of the frame's rows: a stable sort by slot, then each
    slot's rows added in row order (``segment_reduce``), the order of JAX's
    scatter-add on the CPU, so a sum is the same on every device and from
    run to run (``index_add_`` on CUDA adds in atomic order).  Returns (the
    slot of each segment (E,) int64, its sums (E, W)); the segments past
    the last slot are empty and name ``cap``."""
    e = slot.shape[0]
    dev = slot.device
    order = torch.argsort(slot, stable=True)
    slot_s = slot[order]
    head = torch.ones_like(slot_s, dtype=torch.bool)
    head[1:] = slot_s[1:] != slot_s[:-1]
    seg = torch.cumsum(head.to(torch.int64), dim=0) - 1
    lengths = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones_like(seg))
    # unsafe: the lengths sum to E by construction; checking it would read
    # them back to the host
    sums = torch.segment_reduce(payload[order], "sum", lengths=lengths,
                                axis=0, unsafe=True)
    # every row of a segment holds its slot: any writer gives the same value
    seg_slot = torch.full((e,), cap, dtype=torch.int64,
                          device=dev).scatter_(0, seg, slot_s)
    return seg_slot, sums


def update_map(state: MapState, pts: torch.Tensor, valid: torch.Tensor,
               pose: Pose, cfg: MapConfig) -> MapState:
    """Hash-grid ``Map::updateMap`` (map.cc:90-129), the production path.

    Transform to world, route each point to its (cell, leaf), find or
    insert its slot, then fold the new points into the slot centroids: the
    E-sized per-slot sums of ``[x y z 1]`` (:func:`_slot_sums`, in row
    order, so the map is the same from run to run on the card) and C-sized
    element-wise passes (``key`` and ``valid`` decoded from the table).
    Points are dropped, and counted in ``overflow``, when the probe
    exhausts its 64 rounds.  Non-packable configs take
    :func:`update_map_full`.

    With the span recorder armed (``runtime/tracer``) the two halves are
    the device spans ``map.probe`` and ``map.fold``, and the counters
    ``map.probe_rounds`` and ``map.claimed`` (:func:`_count_claimed`) are
    kept; off, the update is what it is without them."""
    if not packable(cfg):
        return update_map_full(state, pts, valid, pose, cfg)
    with tracer.span("map.probe", device=True):
        ins = insert_frame(state, pts, valid, pose, cfg)
    with tracer.span("map.fold", device=True):
        out = fold_frame(state, valid, ins, cfg)
    _count_claimed(state, out)
    return out


def _count_claimed(before: MapState, after: MapState) -> None:
    """``map.claimed``: the slots an update claimed (occupied after it, not
    before), counted on the tensors' device while the recorder is armed."""
    if tracer.RECORDER.on:
        tracer.count("map.claimed",
                     after.valid.sum() - before.valid.sum())


class Inserted(NamedTuple):
    """A frame found or inserted in the table (:func:`insert_frame`)."""
    xyz: torch.Tensor       # (E, 3) the frame's points in the world frame
    table: torch.Tensor     # (C,) int64 the table after the insert
    slot: torch.Tensor      # (E,) int32 each point's slot
    claimed: torch.Tensor   # (E,) bool, the point claimed its slot
    failed: torch.Tensor    # (E,) bool, the probe gave up on the point


def insert_frame(state: MapState, pts: torch.Tensor, valid: torch.Tensor,
                 pose: Pose, cfg: MapConfig) -> Inserted:
    """The first half of :func:`update_map` and its sparse epilogue: the
    frame to world, its packed (cell, leaf) codes, and the probe kernel's
    find-or-insert of each code (packable configs only)."""
    new_xyz = se3.transform(pose, pts.to(state.xyz.dtype))
    code = _packed_codes(new_xyz, valid, cfg)
    if not tracer.RECORDER.on:
        return Inserted(new_xyz, *probe_insert(state.code, code, valid))
    *found, rounds = probe_insert(state.code, code, valid, with_rounds=True)
    tracer.count("map.probe_rounds", rounds)
    return Inserted(new_xyz, *found)


def fold_frame(state: MapState, valid: torch.Tensor, ins: Inserted,
               cfg: MapConfig) -> MapState:
    """The second half of :func:`update_map`: the per-slot sums of the
    inserted frame folded into the stored centroids, ``key`` and ``valid``
    decoded from the table, the dropped points counted."""
    cap = state.xyz.shape[0]
    dtype = state.xyz.dtype
    new_xyz, tab, slot, failed = ins.xyz, ins.table, ins.slot, ins.failed
    ok = valid & ~failed
    slot_c = torch.where(ok, slot.to(torch.int64), cap)  # cap: spare, dropped

    payload = torch.cat([torch.where(ok[:, None], new_xyz, 0.0),
                         ok[:, None].to(dtype)], dim=1)        # (E, 4)
    seg_slot, sums = _slot_sums(slot_c, payload, cap)
    acc = torch.zeros((cap + 1, 4), dtype=dtype, device=new_xyz.device)
    acc = acc.index_copy_(0, seg_slot, sums)[:cap]
    add_sum, add_cnt = acc[:, :3], acc[:, 3]
    base_w = state.valid.to(dtype)                  # stored centroid weight
    touched = add_cnt > 0
    out_xyz = torch.where(touched[:, None],
                          (state.xyz * base_w[:, None] + add_sum)
                          / (base_w + add_cnt)[:, None],
                          state.xyz)
    out_valid = tab != EMPTY
    out_key = torch.where(out_valid[:, None], _decode_cell_keys(tab, cfg), 0)

    dropped = (valid & failed).sum(dtype=torch.int32)
    return MapState(out_xyz, out_key, out_valid, state.overflow + dropped, tab)


def update_map_sparse_epilogue(state: MapState, pts: torch.Tensor,
                               valid: torch.Tensor, pose: Pose,
                               cfg: MapConfig) -> MapState:
    """The O(E) variant of :func:`update_map` (``grid.py:334``), which the
    JAX package measured slower and keeps for the comparison of
    ``scripts/map_epilogue_sweep.py``: every pass after the probe is
    frame-sized.  The per-slot sums are :func:`update_map`'s
    (:func:`_slot_sums`); the touched centroids are gathered, updated and
    written back in place of the C-sized fold, and ``key`` and
    ``valid`` are stamped only at the slots claimed by this call (a matched
    slot carries them already); the key is the reference expression on the
    claiming point, the packed-code decode of :func:`update_map` for every
    cell the code does not alias.  Same slots, keys, validity, table and
    overflow as :func:`update_map`; centroids to float32 rounding.
    Non-packable configs take :func:`update_map_full`."""
    if not packable(cfg):
        return update_map_full(state, pts, valid, pose, cfg)
    with tracer.span("map.probe", device=True):
        ins = insert_frame(state, pts, valid, pose, cfg)
    with tracer.span("map.fold", device=True):
        out = _sparse_fold(state, valid, ins, cfg)
    _count_claimed(state, out)
    return out


def _sparse_fold(state: MapState, valid: torch.Tensor, ins: Inserted,
                 cfg: MapConfig) -> MapState:
    """The frame-sized second half of :func:`update_map_sparse_epilogue`."""
    cap = state.xyz.shape[0]
    dtype = state.xyz.dtype
    new_xyz, tab, slot, claimed, failed = ins
    ok = valid & ~failed
    slot = slot.to(torch.int64)
    slot_c = torch.where(ok, slot, cap)             # cap -> spare row, dropped

    payload = torch.cat([torch.where(ok[:, None], new_xyz, 0.0),
                         ok[:, None].to(dtype)], dim=1)        # (E, 4)
    seg_slot, acc = _slot_sums(slot_c, payload, cap)
    sums, cnts = acc[:, :3], acc[:, 3]

    # new centroid per touched slot = VoxelGrid over {stored centroid
    # (weight = valid)} + {this frame's points in the leaf}
    tgt = torch.where((cnts > 0) & (seg_slot < cap), seg_slot, cap)
    g = torch.clamp(tgt, max=cap - 1)                # a safe gather index
    w0 = state.valid[g].to(dtype)
    cent = ((state.xyz[g] * w0[:, None] + sums)
            / torch.clamp(w0 + cnts, min=1.0)[:, None])
    spare = state.xyz.new_zeros((1, 3))
    out_xyz = torch.cat([state.xyz, spare]).index_copy_(0, tgt, cent)[:cap]

    claim_tgt = torch.where(claimed, slot, cap)
    out_key = torch.cat([state.key, state.key.new_zeros((1, 3))]).index_copy_(
        0, claim_tgt, cell_keys(new_xyz, cfg))[:cap]
    out_valid = torch.cat([state.valid, state.valid.new_zeros(1)]).index_fill_(
        0, claim_tgt, True)[:cap]

    dropped = (valid & failed).sum(dtype=torch.int32)
    return MapState(out_xyz, out_key, out_valid, state.overflow + dropped, tab)


def update_map_full(state: MapState, pts: torch.Tensor, valid: torch.Tensor,
                    pose: Pose, cfg: MapConfig) -> MapState:
    """Sorted-soup ``Map::updateMap``, the semantic oracle and the
    non-packable fallback.

    World transform, cell keys, merge with the stored points, stable sort by
    (cell, leaf), segment centroids, rows ascending by code.  Overflow past
    capacity is counted and the smallest keys are kept.  Its states use the
    sorted-rows layout: feed them back to ``update_map_full`` only."""
    cap = state.xyz.shape[0]
    dtype = state.xyz.dtype
    dev = state.xyz.device

    new_xyz = se3.transform(pose, pts.to(dtype))
    xyz = torch.cat([state.xyz, new_xyz], dim=0)
    key = torch.cat([state.key, cell_keys(new_xyz, cfg)], dim=0)
    ok = torch.cat([state.valid, valid], dim=0)
    n = xyz.shape[0]

    leaf = _leaf_index(xyz, cfg.resolution)
    if packable(cfg):
        code = _packed_codes(xyz, ok, cfg)
        order = torch.argsort(code, stable=True)
        code_s = code[order]
    else:
        # generic 6-column lex sort; invalid rows last via a bumped major key
        inval = (~ok).to(torch.int32)
        cols = [key[:, 0] + inval * (1 << 30), key[:, 1], key[:, 2],
                leaf[:, 0], leaf[:, 1], leaf[:, 2]]
        order = _lex_order(cols)
        code_s = torch.full((n,), EMPTY, dtype=torch.int64, device=dev)
    xyz_s, key_s, leaf_s, ok_s = xyz[order], key[order], leaf[order], ok[order]

    same = torch.ones((n - 1,), dtype=torch.bool, device=dev)
    for c_s in (key_s, leaf_s):
        for a in range(3):
            same = same & (c_s[1:, a] == c_s[:-1, a])
    head = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(head.to(torch.int64), dim=0) - 1
    w = ok_s.to(dtype)
    # seg ascends, so each segment's rows are added in row order
    # (``segment_reduce``, as in :func:`_slot_sums`): the same sums on every
    # device and from run to run; the lengths' integer adds are exact in any
    # order.  unsafe: they sum to n by construction, and checking it would
    # read them back to the host
    lengths = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones_like(seg))
    acc = torch.segment_reduce(torch.cat([xyz_s * w[:, None], w[:, None]],
                                         dim=1),
                               "sum", lengths=lengths, axis=0, unsafe=True)
    sums, cnts = acc[:, :3], acc[:, 3]
    means = sums / torch.clamp(cnts, min=1.0)[:, None]
    # segment -> its head row; a segment with no rows reads row n - 1 (the
    # JAX gather's clamp), masked out below
    rows = torch.arange(n, device=dev)
    head_rows = torch.where(head, rows, n - 1)
    seg_first = torch.full((n,), n - 1, dtype=torch.int64, device=dev)
    seg_first = seg_first.scatter_reduce_(0, seg, head_rows, "amin")
    seg_key = key_s[seg_first]

    n_seg = (head & ok_s).sum()
    live = rows < n_seg
    out_xyz = torch.where(live[:, None], means, 0.0)[:cap]
    out_key = torch.where(live[:, None], seg_key, 0)[:cap]
    out_code = torch.where(live, code_s[seg_first], EMPTY)[:cap]
    dropped = torch.clamp(n_seg - cap, min=0).to(torch.int32)
    return MapState(out_xyz, out_key, live[:cap], state.overflow + dropped,
                    out_code)


def count_cells(state: MapState) -> int:
    """Exact distinct-cell count (the reference's ``map_.size()``), a
    host-side diagnostic computed on demand from either layout."""
    key = state.key.cpu().numpy()[state.valid.cpu().numpy()]
    if key.size == 0:
        return 0
    return int(len(np.unique(key, axis=0)))


def get_map(state: MapState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full map cloud + mask (``Map::getMap``, map.cc:131-139)."""
    return state.xyz, state.valid


def local_map_offsets(cfg: MapConfig, cells_xy: Optional[int] = None,
                      cells_z: Optional[int] = None) -> np.ndarray:
    """Static neighbour-key offsets for getLocalMap (map.cc:141-189), host
    numpy.  An XY block ``(2*cells_xy+1)^2`` at the pose's z-level plus a
    vertical column whose loop bounds use ``voxel_xysize`` but whose step is
    ``voxel_zsize`` (map.cc:175-178), replicated verbatim; C++ int truncation
    of double increments throughout."""
    cxy = cfg.cells_xy if cells_xy is None else cells_xy
    cz = cfg.cells_z if cells_z is None else cells_z
    xy, zs = cfg.voxel_xysize, cfg.voxel_zsize
    offs = []

    def int_range(init: float, end: float, step: float):
        vals, i = [], float(init)
        while int(i) <= int(end):
            vals.append(int(i))
            i = int(i) + step
        return vals

    for dx in int_range(-cxy * xy, cxy * xy, xy):
        for dy in int_range(-cxy * xy, cxy * xy, xy):
            offs.append((dx, dy, 0))
    # z column: bounds with the XY size, step with the Z size (the quirk)
    for dz in int_range(-cz * xy, cz * xy, zs):
        offs.append((0, 0, dz))
    return np.asarray(offs, dtype=np.int32)


def get_local_map(state: MapState, position: torch.Tensor, cfg: MapConfig,
                  cells_xy: Optional[int] = None,
                  cells_z: Optional[int] = None,
                  capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbourhood extraction (``Map::getLocalMap``, map.cc:141-189): the
    map points whose cell key lies in the XY block / Z column around
    ``position``, in ascending row order, cut to ``capacity`` rows.

    Returns ``(xyz (cap, 3), valid (cap,), n_hits ())``; ``n_hits`` counts
    the neighbourhood before the cut, so a caller can see a lossy
    extraction.  The pose translation is truncated to int before
    quantising (map.cc:146-154).  Works on either map layout.  K7 on CUDA,
    its plain version on the CPU; no host synchronisation either way."""
    c = state.xyz.shape[0]
    cap = capacity if capacity is not None else c
    base = cell_keys(torch.trunc(position), cfg)             # (3,)
    offs = local_map_offsets(cfg, cells_xy, cells_z)          # (K, 3) host
    return compact_hits(state.xyz, state.key, state.valid, base, offs, cap)


def map_entropy(state: MapState, bucket_count: Optional[int] = None) -> float:
    """Shannon entropy of hash-bucket occupancy (``Map::getMapEntropy``,
    map.cc:191-211), host-side.  The reference hashes cell keys with
    ``(h1 ^ h2<<1) ^ h3<<2`` into ``unordered_map`` buckets; the bucket count
    defaults to the smallest prime >= the cell count."""
    key = state.key.cpu().numpy()[state.valid.cpu().numpy()]
    if key.size == 0:
        return 0.0
    cells = np.unique(key, axis=0).astype(np.int64)
    n = len(cells)
    if bucket_count is None:
        bucket_count = int(_next_prime(max(n, 2)))
    h = (cells[:, 0] ^ (cells[:, 1] << 1)) ^ (cells[:, 2] << 2)
    buckets = h % bucket_count
    _, counts = np.unique(buckets, return_counts=True)
    p = counts / float(n)
    return float(-(p * np.log(p)).sum())


def _next_prime(n: int) -> int:
    def is_prime(k):
        if k < 2:
            return False
        for d in range(2, int(k ** 0.5) + 1):
            if k % d == 0:
                return False
        return True

    while not is_prime(n):
        n += 1
    return n
