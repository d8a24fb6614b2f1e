"""K3, K4, K5 and K6: exact k-NN with neighbour coordinates, batched, with
indices, and with the line-fit gate fused in: CUDA kernel wrappers + plain
versions.

Port of ``liodom_tpu/ops/knn_pallas.py``: ``knn_coords_pallas`` (K3),
``knn_coords_pallas_batched`` (K4), ``knn_pallas`` (K5) and
``knn_lines_pallas`` (K6), with their helpers.  The correspondence search
(laser_odometry.cc:318-323) runs an exact 5-NN of every edge against the
matching map, twice a frame; the line fit only reads the neighbours'
coordinates, so the kernels return those (K3, K4) or the fitted line itself
(K6).  k is the caller's (``LiodomConfig.knn_k``, 5 by default), any k
from 1 to the number of refs: the register walk is built for every 1 <= k
<= ``MAX_K`` and a larger k takes the run-time-k walk (``ListWalk``, the
``*_any_k`` launches: the same split over a cluster, partial lists kept
by merging 8-ref batches, one keyed merge), whose lists sit in shared
memory or, above ~210 neighbours, in a device scratch
(:func:`knn_any_k_shape`).
The map-sharded step (``parallel/sharded.py``) gathers its neighbours' rows
itself and merges them across ranks, so K5 returns the indices into the
caller's map shard.

CUDA route: both sides are sorted on coarse 2 m cells (:func:`_spatial_order`;
the map once a frame by :func:`spatial_sort_points`), per-tile bounding boxes
give (query tile, ref tile) pair flags (:func:`_pair_flags`), and
``csrc/knn_coords.cu`` / ``csrc/knn_lines.cu`` / ``csrc/knn_index.cu``
visit the flagged pairs only:
a cluster of blocks a query tile deals its flagged ref tiles over its
blocks, thread groups a block split each staged tile, and the partial lists
merge (``csrc/knn_search.cuh``; :func:`knn_walk_shape` reads the split).
:func:`knn_launch_plain` and :func:`knn_lines_launch_plain` compute what
those launches return from the same prepared tensors, exactly.
Invalid refs are displaced by ``2 * _FAR`` and read back through
``_FAR_PICK_D2``.  Neighbours within ``max_radius`` are exact; beyond it a
distance may read ``_BIG``, which the consumer's accept gate
(``d2[k-1] < max_sq_dist``) treats the same.  Every helper takes a leading
batch dimension: a batch element gets its own sort, boxes and flags
(:func:`knn_prepare_batched`), and K3's :func:`knn_prepare` is its B = 1 case.

CPU route (:func:`knn_coords_plain`): exact brute force over ref chunks with
``torch.topk``, invalid refs at ``_BIG``; K4's and K6's plain versions loop
it over the batch (and K6's adds ``neighbors._line_fit``).

K5 (``csrc/knn_index.cu``, the same walk with an index epilogue, one launch
a call) searches without a radius on the sharded path: nothing is sorted
then, so its indices address the caller's ref directly, and the flags only
skip empty tiles; :func:`knn_index_launch_plain` computes what its launch
returns.  With a radius both sides are sorted
and the indices are mapped back through the ref permutation, as
``knn_pallas.py:249-255`` does.  Its plain version (:func:`knn_index_plain`)
selects on int64 keys ``(d2 bits << 32) | index``, so that equal distances
go to the lower index, the TPU kernel's tie order, as a stable sort would.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from liodom_tpu_torch import kernels

_BIG = 1e30
_FAR = 1.0e4  # invalid-point displacement (d2 >= ~9.7e7 >> max real d2)
# Invalid refs are displaced by 2*_FAR, so any picked-invalid distance is at
# least ~(2e4 - 240)^2 ~ 3.9e8, while real squared ranges top out around
# (2 * max_range)^2 ~ 5.8e4: anything past this threshold is a FAR pick.
# Sound only while |world coordinate| << _FAR on every axis — LiDAR odometry
# coordinates are bounded by trajectory length (km scale at most).
_FAR_PICK_D2 = 1.0e6

TILE_E = 64    # queries per block in csrc/knn_search.cuh
TILE_M = 512   # refs per staged tile in csrc/knn_search.cuh
K = 5          # neighbours a search keeps unless the caller asks for k
MAX_K = 16     # the largest k of the register walk (csrc/knn_search.cuh)
SORT_CELL = 2.0  # metres; the spatial sort's cell on the CUDA route
_CHUNK = 4096    # refs per brute-force chunk of the plain version
_QBLOCK = 512    # queries per block of the plain version

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SHAPE_SIG = ("liodom_knn_walk_shape", [_INT, _PTR])
_ANY_K_SHAPE_SIG = ("liodom_knn_any_k_shape", [_INT, _INT, _PTR])
_SIG = [("liodom_knn_coords", [_PTR] * 6 + [_INT] * 6 + [_PTR]),
        ("liodom_knn_coords_batched", [_PTR] * 6 + [_INT] * 7 + [_PTR]),
        ("liodom_knn_coords_any_k", [_PTR] * 7 + [_INT] * 7 + [_PTR]),
        _SHAPE_SIG, _ANY_K_SHAPE_SIG]
_LINES_SIG = [("liodom_knn_lines", [_PTR] * 7 + [_INT] * 7
               + [ctypes.c_float] * 3 + [_PTR]),
              ("liodom_knn_lines_any_k", [_PTR] * 8 + [_INT] * 7
               + [ctypes.c_float] * 3 + [_PTR]),
              _SHAPE_SIG, _ANY_K_SHAPE_SIG]
_INDEX_SIG = [("liodom_knn_index", [_PTR] * 6 + [_INT] * 8 + [_PTR]),
              ("liodom_knn_index_any_k", [_PTR] * 7 + [_INT] * 8 + [_PTR]),
              _SHAPE_SIG, _ANY_K_SHAPE_SIG]
_SIGS = {"knn_coords": _SIG, "knn_lines": _LINES_SIG,
         "knn_index": _INDEX_SIG}


def _rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x`` (..., N) or (..., N, C) reordered along N by ``perm`` (..., N)."""
    if x.ndim == perm.ndim:
        return x.gather(-1, perm)
    return x.gather(-2, perm[..., None].expand(perm.shape + x.shape[-1:]))


def _spatial_order(xyz: torch.Tensor, mask: torch.Tensor,
                   cell: float = SORT_CELL) -> torch.Tensor:
    """Permutation grouping valid points by coarse spatial cell (x-major
    lexicographic; 64-cell wrap per axis), along the point axis of
    (..., N, 3).  Wrap aliasing only weakens tile locality — correctness
    never depends on the key, only on the per-tile boxes computed from real
    coordinates.  Invalid points sort last."""
    c = torch.clamp(torch.floor(xyz / cell).to(torch.int32) & 63, 0, 63)
    key = (c[..., 0] << 12) | (c[..., 1] << 6) | c[..., 2]
    key = torch.where(mask, key, torch.full_like(key, 1 << 20))
    return torch.argsort(key, dim=-1, stable=True)


def _tile_aabbs(xyz: torch.Tensor, mask: torch.Tensor, tile: int):
    """Per-tile axis-aligned bounding boxes over valid points + non-empty
    flag.  xyz (..., N, 3) with N % tile == 0."""
    n = xyz.shape[-2] // tile
    x = xyz.reshape(xyz.shape[:-2] + (n, tile, 3))
    v = mask.reshape(mask.shape[:-1] + (n, tile, 1))
    lo = x.masked_fill(~v, _BIG).amin(dim=-2)
    hi = x.masked_fill(~v, -_BIG).amax(dim=-2)
    return lo, hi, v[..., 0].any(dim=-1)


def _pair_flags(qlo, qhi, qne, rlo, rhi, rne,
                max_radius: Optional[float]) -> torch.Tensor:
    """(..., n_e, n_m) int32: 1 where both tiles hold points and (under
    radius pruning) their boxes are within ``max_radius``."""
    ne = qne[..., :, None] & rne[..., None, :]
    if max_radius is None:
        return ne.to(torch.int32)
    gap = torch.clamp(
        torch.maximum(qlo[..., :, None, :] - rhi[..., None, :, :],
                      rlo[..., None, :, :] - qhi[..., :, None, :]),
        min=0.0)
    d2 = (gap * gap).sum(dim=-1)
    return (ne & (d2 <= max_radius * max_radius)).to(torch.int32)


def spatial_sort_points(xyz: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially order a padded point set (..., N, 3) (valid rows
    front-compacted, grouped by coarse cell) so repeated kNN calls over it
    can pass ``ref_presorted=True``.  The point set is unchanged; the order
    of the matching map carries no semantics."""
    perm = _spatial_order(xyz, mask)
    ok = _rows(mask, perm)
    return torch.where(ok[..., None], _rows(xyz, perm),
                       torch.zeros_like(xyz)), ok


def knn_coords_plain(query: torch.Tensor, qmask: torch.Tensor,
                     ref: torch.Tensor, rmask: torch.Tensor, k: int = K
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by brute force over ref chunks: query (E, 3), qmask (E,),
    ref (M, 3), rmask (M,) -> (d2 (E, k) ascending, coords (E, k, 3)).

    d2 is ``(dx*dx + dy*dy) + dz*dz`` with each operation rounded, the
    kernel's expression.  Invalid refs sit at ``_BIG``; invalid queries get
    ``_BIG``.  The carried best stays ahead of a chunk's entries on equal
    distances (stable merge), the kernel's tie order.  The valid refs are
    gathered first, in their order, so no distance to an invalid ref is
    computed; queries go in blocks of ``_QBLOCK`` so the distance tile stays
    cache-sized, and blocks without a valid query are skipped (their rows
    read ``_BIG`` either way).  Rows with fewer than k valid refs keep
    ``_BIG`` entries with zero coordinates."""
    e = query.shape[0]
    best_d = torch.full((e, k), _BIG, dtype=query.dtype, device=query.device)
    best_c = torch.zeros((e, k, 3), dtype=query.dtype, device=query.device)
    ref = ref[torch.nonzero(rmask).squeeze(1)]
    planes = ref.t().contiguous()            # (3, M_valid), contiguous rows
    m = ref.shape[0]
    for q0 in range(0, e, _QBLOCK):
        q1 = q0 + _QBLOCK
        if not bool(qmask[q0:q1].any()):
            continue
        q = query[q0:q1]
        bd, bc = best_d[q0:q1], best_c[q0:q1]
        for off in range(0, m, _CHUNK):
            r = ref[off:off + _CHUNK]
            rx, ry, rz = planes[:, off:off + _CHUNK]
            d2 = q[:, 0:1] - rx[None, :]
            d2.mul_(d2)
            t = q[:, 1:2] - ry[None, :]
            t.mul_(t)
            d2.add_(t)
            torch.sub(q[:, 2:3], rz[None, :], out=t)
            t.mul_(t)
            d2.add_(t)
            cd, ci = torch.topk(d2, min(k, r.shape[0]), dim=1, largest=False,
                                sorted=True)
            alld = torch.cat([bd, cd], dim=1)
            allc = torch.cat([bc, r[ci]], dim=1)
            sd, si = torch.sort(alld, dim=1, stable=True)
            bd = sd[:, :k]
            bc = torch.gather(allc, 1, si[:, :k, None].expand(-1, -1, 3))
        best_d[q0:q1] = bd
        best_c[q0:q1] = bc
    best_d = best_d.masked_fill(~qmask[:, None], _BIG)
    return torch.clamp(best_d, min=0.0), best_c


def knn_coords_batched_plain(query: torch.Tensor, qmask: torch.Tensor,
                             ref: torch.Tensor, rmask: torch.Tensor,
                             k: int = K) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: :func:`knn_coords_plain` on each of B independent
    (query, ref) pairs, query (B, E, 3) ... -> (d2 (B, E, k),
    coords (B, E, k, 3))."""
    outs = [knn_coords_plain(query[b], qmask[b], ref[b], rmask[b], k)
            for b in range(query.shape[0])]
    return (torch.stack([d for d, _ in outs]),
            torch.stack([c for _, c in outs]))


def knn_prepare_batched(query: torch.Tensor, qmask: torch.Tensor,
                        ref: torch.Tensor, rmask: torch.Tensor,
                        max_radius: Optional[float],
                        ref_presorted: bool = False):
    """The wrappers' tensor work before a launch, all on the device, for B
    independent pairs (query (B, E, 3), qmask (B, E), ref (B, M, 3), rmask
    (B, M)): sorted and padded queries ``q4`` (B, Ep, 4) [x y z valid],
    encoded and padded refs ``r4`` (B, Mp, 4), the (B, n_e, n_m) pair flags
    and the query permutation (B, E).  Each element gets its own sort, boxes
    and flags (``knn_pallas.py:464-494``).  Without ``max_radius`` nothing
    is sorted (``knn_pallas.py:182-187``): the permutation is the identity
    and the flags only mark the non-empty tile pairs."""
    return _prepare_batched(query, qmask, ref, rmask, max_radius,
                            ref_presorted)[:4]


def _prepare_batched(query, qmask, ref, rmask, max_radius, ref_presorted):
    """:func:`knn_prepare_batched` plus the ref permutation it applied (B,
    M), or None where the refs kept the caller's order."""
    b, e, m = query.shape[0], query.shape[1], ref.shape[1]
    dev = query.device
    rperm = None
    if max_radius is None:
        qperm = torch.arange(e, device=dev).expand(b, e)
        qs, qms = query, qmask
    else:
        qperm = _spatial_order(query, qmask)
        qs, qms = _rows(query, qperm), _rows(qmask, qperm)
        if not ref_presorted:
            rperm = _spatial_order(ref, rmask)
            ref, rmask = _rows(ref, rperm), _rows(rmask, rperm)
    ep = e + (-e) % TILE_E
    mp = m + (-m) % TILE_M
    q4 = torch.zeros((b, ep, 4), dtype=torch.float32, device=dev)
    q4[:, :e, :3] = qs
    q4[:, :e, 3] = qms.to(torch.float32)
    r4 = torch.full((b, mp, 4), _FAR, dtype=torch.float32, device=dev)
    r4[:, :m, :3] = torch.where(rmask[..., None], ref, ref + 2.0 * _FAR)
    qm_p = torch.zeros((b, ep), dtype=torch.bool, device=dev)
    qm_p[:, :e] = qms
    rm_p = torch.zeros((b, mp), dtype=torch.bool, device=dev)
    rm_p[:, :m] = rmask
    qlo, qhi, qne = _tile_aabbs(q4[..., :3], qm_p, TILE_E)
    rlo, rhi, rne = _tile_aabbs(r4[..., :3], rm_p, TILE_M)
    flags = _pair_flags(qlo, qhi, qne, rlo, rhi, rne, max_radius).contiguous()
    return q4, r4, flags, qperm.to(torch.int32).contiguous(), rperm


def knn_prepare(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
                rmask: torch.Tensor, max_radius: Optional[float],
                ref_presorted: bool = False):
    """:func:`knn_prepare_batched` for one pair: q4 (Ep, 4), r4 (Mp, 4),
    flags (n_e, n_m), qperm (E,)."""
    prep = knn_prepare_batched(query[None], qmask[None], ref[None],
                               rmask[None], max_radius, ref_presorted)
    return tuple(t[0] for t in prep)


def _check_prepared(q4, r4, flags, qperm, what: str) -> Tuple[int, int, int]:
    """Validate tensors laid out by :func:`knn_prepare_batched` (with or
    without the batch dimension); returns (E, n_e, n_m)."""
    if not all(t.is_cuda and t.device == q4.device
               for t in (q4, r4, flags, qperm)):
        raise ValueError(f"{what} needs all tensors on one CUDA device")
    if (q4.dtype != torch.float32 or r4.dtype != torch.float32
            or flags.dtype != torch.int32 or qperm.dtype != torch.int32):
        raise TypeError(f"{what} takes float32 points and int32 flags and "
                        f"permutation")
    lead = flags.shape[:-2]
    n_e, n_m = flags.shape[-2:]
    e = qperm.shape[-1]
    if (q4.shape != lead + (n_e * TILE_E, 4)
            or r4.shape != lead + (n_m * TILE_M, 4)
            or qperm.shape != lead + (e,) or e > n_e * TILE_E):
        raise ValueError(f"{what} shapes: q4 {tuple(q4.shape)}, r4 "
                         f"{tuple(r4.shape)}, flags {tuple(flags.shape)}, "
                         f"qperm {tuple(qperm.shape)}")
    if not all(t.is_contiguous() for t in (q4, r4, flags, qperm)):
        raise ValueError(f"{what} needs contiguous tensors")
    return e, n_e, n_m


def knn_walk_shape(source: str, n_m: int) -> dict:
    """The register walk of ``csrc/knn_search.cuh`` as the built library of
    ``source`` (``"knn_coords"``, ``"knn_lines"`` or ``"knn_index"``) has
    it: blocks a query tile's cluster, thread groups a block, and a block's
    dynamic shared memory for ``n_m`` ref tiles at k = 5.  Builds the
    library if needed; launches nothing."""
    lib = kernels.load(source, _SIGS[source])
    out = (ctypes.c_int * 3)()
    kernels.check(lib.liodom_knn_walk_shape(n_m, ctypes.addressof(out)),
                  "liodom_knn_walk_shape")
    return {"cluster_blocks": out[0], "thread_groups_per_block": out[1],
            "dynamic_smem_bytes": out[2]}


def knn_any_k_shape(source: str, n_m: int, k: int) -> dict:
    """``ListWalk`` (the ``*_any_k`` launches) as the built library of
    ``source`` has it for ``n_m`` ref tiles and ``k`` neighbours: threads a
    block, blocks a query tile's cluster, thread groups a block, whether a
    block's lists fit its shared memory, a block's dynamic shared memory as
    launched, and otherwise the scratch bytes a query tile (a list for each
    of the cluster's blocks and groups).  Builds the library if needed;
    launches nothing."""
    lib = kernels.load(source, _SIGS[source])
    out = (ctypes.c_int * 6)()
    kernels.check(lib.liodom_knn_any_k_shape(n_m, k, ctypes.addressof(out)),
                  "liodom_knn_any_k_shape")
    return {"threads": out[0], "cluster_blocks": out[4],
            "thread_groups_per_block": out[5],
            "lists_in_smem": bool(out[1]), "dynamic_smem_bytes": out[2],
            "scratch_bytes_per_tile": out[3]}


def knn_any_k_list_edge(source: str, n_m: int) -> int:
    """The largest k whose ``ListWalk`` lists fit a block's shared memory
    at ``n_m`` ref tiles, as the built library of ``source`` reports it
    (k + 1 is the first in the device scratch).  Launches nothing."""
    fits, past = 1, 1 << 16
    if (not knn_any_k_shape(source, n_m, fits)["lists_in_smem"]
            or knn_any_k_shape(source, n_m, past)["lists_in_smem"]):
        raise RuntimeError(f"ListWalk's boundary at {n_m} ref tiles is not "
                           f"between k = {fits} and {past}")
    while past - fits > 1:
        mid = (fits + past) // 2
        if knn_any_k_shape(source, n_m, mid)["lists_in_smem"]:
            fits = mid
        else:
            past = mid
    return fits


def _check_k(k: int, refs: int, what: str) -> None:
    """Any k from 1 to the number of ref rows the walk sees (the refs
    padded to whole tiles), as ``torch.topk`` and ``lax.top_k`` take."""
    if not 1 <= k <= refs:
        raise ValueError(f"{what}: k={k} outside 1..{refs}, the ref rows")


def _any_k(source: str, symbol: str, q4, r4, flags, qperm, k, outs,
           extra_ints=(), extra_floats=()) -> None:
    """Launch ``symbol`` of ``source`` (a ``ListWalk`` entry point) on
    prepared tensors with a leading batch dimension, the lists in shared
    memory where the library says they fit, else in the device scratch."""
    b, n_e, n_m = flags.shape
    shape = knn_any_k_shape(source, n_m, k)
    scratch = None
    if not shape["lists_in_smem"]:
        # one buffer a device, written before it is read, never cleared
        scratch = kernels.device_scratch(
            "knn_lists", q4.device,
            b * n_e * shape["scratch_bytes_per_tile"] // 4, torch.float32,
            floor=1 << 20)
    lib = kernels.load(source, _SIGS[source])
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            *(t.data_ptr() for t in outs), b, qperm.shape[-1], n_e, n_m,
            *extra_ints, TILE_E, TILE_M, k, *extra_floats, stream)
    kernels.check(err, symbol)


def knn_launch(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
               qperm: torch.Tensor, k: int = K
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the prepared tensors -> (d2 (E, k), coords (E, k, 3)) in
    the caller's query order; k above ``MAX_K`` launches
    :func:`knn_launch_any_k`."""
    if flags.ndim != 2:
        raise ValueError(f"knn_launch takes one pair, flags "
                         f"{tuple(flags.shape)}")
    e, n_e, n_m = _check_prepared(q4, r4, flags, qperm, "knn_launch")
    _check_k(k, r4.shape[0], "knn_launch")
    if k > MAX_K:
        return knn_launch_any_k(q4, r4, flags, qperm, k)
    out_d = torch.empty((e, k), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((e, k, 3), dtype=torch.float32, device=q4.device)
    lib = kernels.load("knn_coords", _SIG)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_knn_coords(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            out_d.data_ptr(), out_c.data_ptr(), e, n_e, n_m, TILE_E, TILE_M,
            k, stream)
    kernels.check(err, "liodom_knn_coords")
    knn_launch.launches += 1
    return out_d, out_c


knn_launch.launches = 0


def knn_launch_any_k(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
                     qperm: torch.Tensor, k: int = K
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on ``ListWalk`` (``liodom_knn_coords_any_k``) at any k, the same
    contract as :func:`knn_launch`."""
    if flags.ndim != 2:
        raise ValueError(f"knn_launch_any_k takes one pair, flags "
                         f"{tuple(flags.shape)}")
    e, _, _ = _check_prepared(q4, r4, flags, qperm, "knn_launch_any_k")
    _check_k(k, r4.shape[0], "knn_launch_any_k")
    out_d = torch.empty((1, e, k), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((1, e, k, 3), dtype=torch.float32, device=q4.device)
    _any_k("knn_coords", "liodom_knn_coords_any_k", q4, r4, flags[None],
           qperm, k, (out_d, out_c))
    knn_launch_any_k.launches += 1
    return out_d[0], out_c[0]


knn_launch_any_k.launches = 0


def knn_launch_batched(q4: torch.Tensor, r4: torch.Tensor,
                       flags: torch.Tensor, qperm: torch.Tensor, k: int = K
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on tensors from :func:`knn_prepare_batched` -> (d2 (B, E,
    k), coords (B, E, k, 3)) in each element's query order; k above
    ``MAX_K`` launches :func:`knn_launch_batched_any_k`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_launch_batched takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, n_e, n_m = _check_prepared(q4, r4, flags, qperm, "knn_launch_batched")
    _check_k(k, r4.shape[1], "knn_launch_batched")
    if k > MAX_K:
        return knn_launch_batched_any_k(q4, r4, flags, qperm, k)
    b = flags.shape[0]
    out_d = torch.empty((b, e, k), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((b, e, k, 3), dtype=torch.float32, device=q4.device)
    lib = kernels.load("knn_coords", _SIG)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_knn_coords_batched(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            out_d.data_ptr(), out_c.data_ptr(), b, e, n_e, n_m, TILE_E,
            TILE_M, k, stream)
    kernels.check(err, "liodom_knn_coords_batched")
    knn_launch_batched.launches += 1
    return out_d, out_c


knn_launch_batched.launches = 0


def knn_launch_batched_any_k(q4: torch.Tensor, r4: torch.Tensor,
                             flags: torch.Tensor, qperm: torch.Tensor,
                             k: int = K
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on ``ListWalk`` at any k, the same contract as
    :func:`knn_launch_batched`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_launch_batched_any_k takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, _, _ = _check_prepared(q4, r4, flags, qperm,
                              "knn_launch_batched_any_k")
    _check_k(k, r4.shape[1], "knn_launch_batched_any_k")
    b = flags.shape[0]
    out_d = torch.empty((b, e, k), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((b, e, k, 3), dtype=torch.float32, device=q4.device)
    _any_k("knn_coords", "liodom_knn_coords_any_k", q4, r4, flags, qperm, k,
           (out_d, out_c))
    knn_launch_batched_any_k.launches += 1
    return out_d, out_c


knn_launch_batched_any_k.launches = 0


def _check_points(query, qmask, ref, rmask, k: int, batched: bool,
                  what: str) -> None:
    _check_k(k, ref.shape[-2] + (-ref.shape[-2]) % TILE_M, what)
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 points")
    nd = 3 if batched else 2
    if (query.ndim != nd or query.shape[-1] != 3 or ref.ndim != nd
            or ref.shape[-1] != 3 or ref.shape[:-2] != query.shape[:-2]
            or qmask.shape != query.shape[:-1]
            or rmask.shape != ref.shape[:-1]):
        raise ValueError(f"{what} shapes: query {tuple(query.shape)}, qmask "
                         f"{tuple(qmask.shape)}, ref {tuple(ref.shape)}, "
                         f"rmask {tuple(rmask.shape)}")


def knn_coords_cuda(query: torch.Tensor, qmask: torch.Tensor,
                    ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                    max_radius: Optional[float] = None,
                    ref_presorted: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors (see the module docstring for the contract)."""
    _check_points(query, qmask, ref, rmask, k, False, "knn_coords_cuda")
    q4, r4, flags, qperm = knn_prepare(query, qmask, ref, rmask, max_radius,
                                       ref_presorted)
    return knn_launch(q4, r4, flags, qperm, k)


def knn_coords_batched_cuda(query: torch.Tensor, qmask: torch.Tensor,
                            ref: torch.Tensor, rmask: torch.Tensor,
                            k: int = K, max_radius: Optional[float] = None,
                            ref_presorted: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors: K3 over B independent (query, ref) pairs in one
    launch, query (B, E, 3), qmask (B, E), ref (B, M, 3), rmask (B, M) ->
    (d2 (B, E, k), coords (B, E, k, 3))."""
    _check_points(query, qmask, ref, rmask, k, True,
                  "knn_coords_batched_cuda")
    return knn_launch_batched(*knn_prepare_batched(query, qmask, ref, rmask, max_radius,
                                       ref_presorted), k)


def knn_coords(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
               rmask: torch.Tensor, k: int = K,
               max_radius: Optional[float] = None,
               ref_presorted: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain brute force for CPU tensors (which needs no sort or pruning)."""
    if query.is_cuda:
        return knn_coords_cuda(query, qmask, ref, rmask, k, max_radius,
                               ref_presorted)
    kernels.require_cpu(query, "knn_coords")
    return knn_coords_plain(query, qmask, ref, rmask, k)


def knn_coords_batched(query: torch.Tensor, qmask: torch.Tensor,
                       ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                       max_radius: Optional[float] = None,
                       ref_presorted: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if query.is_cuda:
        return knn_coords_batched_cuda(query, qmask, ref, rmask, k,
                                       max_radius, ref_presorted)
    kernels.require_cpu(query, "knn_coords_batched")
    return knn_coords_batched_plain(query, qmask, ref, rmask, k)


def knn_lines_launch(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
                     qperm: torch.Tensor, max_sq_dist: float,
                     eig_ratio: float, min_line_sep: float, k: int = K
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K6 on tensors from :func:`knn_prepare_batched` (flags radius
    ``sqrt(max_sq_dist)``) -> (lpa (B, E, 3), lpb (B, E, 3), valid (B, E))
    in each element's query order; ``valid`` includes the query mask.  The
    line fit needs k >= 2; k above ``MAX_K`` launches
    :func:`knn_lines_launch_any_k`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_lines_launch takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, n_e, n_m = _check_prepared(q4, r4, flags, qperm, "knn_lines_launch")
    _check_lines_k(k, r4.shape[1], "knn_lines_launch")
    if k > MAX_K:
        return knn_lines_launch_any_k(q4, r4, flags, qperm, max_sq_dist,
                                      eig_ratio, min_line_sep, k)
    b = flags.shape[0]
    lpa = torch.empty((b, e, 3), dtype=torch.float32, device=q4.device)
    lpb = torch.empty((b, e, 3), dtype=torch.float32, device=q4.device)
    ok = torch.empty((b, e), dtype=torch.bool, device=q4.device)
    lib = kernels.load("knn_lines", _LINES_SIG)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_knn_lines(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            lpa.data_ptr(), lpb.data_ptr(), ok.data_ptr(), b, e, n_e, n_m,
            TILE_E, TILE_M, k, float(max_sq_dist), float(eig_ratio),
            float(min_line_sep) * float(min_line_sep), stream)
    kernels.check(err, "liodom_knn_lines")
    knn_lines_launch.launches += 1
    return lpa, lpb, ok


knn_lines_launch.launches = 0


def _check_lines_k(k: int, refs: int, what: str) -> None:
    _check_k(k, refs, what)
    if k < 2:
        raise ValueError(f"{what}: k={k}, a line needs 2 neighbours")


def knn_lines_launch_any_k(q4: torch.Tensor, r4: torch.Tensor,
                           flags: torch.Tensor, qperm: torch.Tensor,
                           max_sq_dist: float, eig_ratio: float,
                           min_line_sep: float, k: int = K
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K6 on ``ListWalk`` at any k >= 2, the same contract as
    :func:`knn_lines_launch`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_lines_launch_any_k takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, _, _ = _check_prepared(q4, r4, flags, qperm, "knn_lines_launch_any_k")
    _check_lines_k(k, r4.shape[1], "knn_lines_launch_any_k")
    b = flags.shape[0]
    lpa = torch.empty((b, e, 3), dtype=torch.float32, device=q4.device)
    lpb = torch.empty((b, e, 3), dtype=torch.float32, device=q4.device)
    ok = torch.empty((b, e), dtype=torch.bool, device=q4.device)
    _any_k("knn_lines", "liodom_knn_lines_any_k", q4, r4, flags, qperm, k,
           (lpa, lpb, ok),
           extra_floats=(float(max_sq_dist), float(eig_ratio),
                         float(min_line_sep) * float(min_line_sep)))
    knn_lines_launch_any_k.launches += 1
    return lpa, lpb, ok


knn_lines_launch_any_k.launches = 0


def knn_lines_cuda(query: torch.Tensor, qmask: torch.Tensor,
                   ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                   max_sq_dist: float = 1.0, eig_ratio: float = 3.0,
                   min_line_sep: float = 0.01, ref_presorted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors, one pair (query (E, 3), ...) or a batch (query
    (B, E, 3), ...) -> (lpa, lpb, valid) with the query's leading shape.
    Radius pruning always uses ``sqrt(max_sq_dist)`` (``knn_pallas.py:733``):
    the distance gate drops any farther edge anyway."""
    batched = query.ndim == 3
    _check_points(query, qmask, ref, rmask, k, batched, "knn_lines_cuda")
    if not batched:
        query, qmask, ref, rmask = (t[None] for t in (query, qmask, ref,
                                                      rmask))
    prep = knn_prepare_batched(query, qmask, ref, rmask,
                               float(max_sq_dist) ** 0.5, ref_presorted)
    out = knn_lines_launch(*prep, max_sq_dist, eig_ratio, min_line_sep, k)
    return out if batched else tuple(t[0] for t in out)


def knn_lines_plain(query: torch.Tensor, qmask: torch.Tensor,
                    ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                    max_sq_dist: float = 1.0, eig_ratio: float = 3.0,
                    min_line_sep: float = 0.01
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's plain version: :func:`knn_coords_plain` (per element when
    batched) followed by ``neighbors._line_fit``."""
    # imported here: neighbors builds on this module
    from liodom_tpu_torch.ops.neighbors import _line_fit
    knn = knn_coords_batched_plain if query.ndim == 3 else knn_coords_plain
    d2, near = knn(query, qmask, ref, rmask, k)
    return tuple(_line_fit(near, d2[..., k - 1], qmask, max_sq_dist,
                           eig_ratio, min_line_sep))


def knn_lines(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
              rmask: torch.Tensor, k: int = K, max_sq_dist: float = 1.0,
              eig_ratio: float = 3.0, min_line_sep: float = 0.01,
              ref_presorted: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if query.is_cuda:
        return knn_lines_cuda(query, qmask, ref, rmask, k, max_sq_dist,
                              eig_ratio, min_line_sep, ref_presorted)
    kernels.require_cpu(query, "knn_lines")
    return knn_lines_plain(query, qmask, ref, rmask, k, max_sq_dist,
                           eig_ratio, min_line_sep)


def _index_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (d2, index) pairs lexicographically: a
    non-negative float32's bits order as the float does."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | idx


_NONE = 0x7FFFFFFF   # the kernels' index of an empty slot


def _walk_plain(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk's merged lists for one prepared pair: per query position,
    the k smallest (d2, ref index) pairs over the refs of its tile's flagged
    ref tiles (FAR-encoded and padding rows included, at distances under
    ``_BIG``), selected on int64 keys (:func:`_index_keys`) so that equal
    distances go to the lower index, the kernels' tie order, whatever
    ``topk``'s.  Returns raw (d2 (Ep, k), idx (Ep, k) int64), ``_BIG`` and
    ``_NONE`` in an empty slot.  A host loop over query tiles."""
    dev = q4.device
    none = int(_index_keys(torch.full((), _BIG, dtype=torch.float32),
                           torch.tensor(_NONE, dtype=torch.int64)))
    best = torch.full((q4.shape[0], k), none, dtype=torch.int64, device=dev)
    cols = torch.arange(TILE_M, device=dev)
    for et, row in enumerate(flags.cpu()):
        tiles = torch.nonzero(row).squeeze(1).to(dev)
        if tiles.numel() == 0:
            continue
        idx = (tiles[:, None] * TILE_M + cols).flatten()
        q = q4[et * TILE_E:(et + 1) * TILE_E]
        r = r4[idx]
        d2 = q[:, 0:1] - r[None, :, 0]
        d2.mul_(d2)
        t = q[:, 1:2] - r[None, :, 1]
        t.mul_(t)
        d2.add_(t)
        torch.sub(q[:, 2:3], r[None, :, 2], out=t)
        t.mul_(t)
        d2.add_(t)
        keys = torch.where(d2 < _BIG, _index_keys(d2, idx[None, :]),
                           torch.full_like(t, none, dtype=torch.int64))
        if keys.shape[1] < k:            # fewer candidates than slots
            keys = torch.cat([keys, torch.full(
                (TILE_E, k - keys.shape[1]), none, dtype=torch.int64,
                device=dev)], dim=1)
        best[et * TILE_E:(et + 1) * TILE_E] = torch.topk(
            keys, k, dim=1, largest=False, sorted=True).values
    return (best >> 32).to(torch.int32).view(torch.float32), best & 0xFFFFFFFF


def _read_back(d2: torch.Tensor, q4: torch.Tensor) -> torch.Tensor:
    """The kernels' read-back of a merged d2 list: a FAR pick or an invalid
    query reads ``_BIG``, d2 is clamped at 0."""
    d2 = torch.where(d2 > _FAR_PICK_D2, _BIG, d2)
    return torch.where(q4[:, 3:4] != 0, torch.clamp(d2, min=0.0), _BIG)


def knn_launch_plain(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
                     qperm: torch.Tensor, k: int = K
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K3 (flags (n_e, n_m)) or K4 (a leading batch dimension) returns
    on tensors from :func:`knn_prepare_batched`, in plain PyTorch: the
    walk's lists (:func:`_walk_plain`), then the read-back rules (a FAR pick
    or an invalid query reads ``_BIG``, d2 is clamped at 0, an empty slot
    reads ``_BIG`` with zero coordinates) and each row at its query's
    original index.  A reference for checks, not a route."""
    if flags.ndim == 3:
        outs = [knn_launch_plain(q4[b], r4[b], flags[b], qperm[b], k)
                for b in range(flags.shape[0])]
        return (torch.stack([d for d, _ in outs]),
                torch.stack([c for _, c in outs]))
    e = qperm.shape[0]
    d2, idx = _walk_plain(q4, r4, flags, k)
    empty = idx == _NONE
    coords = torch.where(empty[..., None], 0.0,
                         r4[torch.where(empty, 0, idx), :3])
    out_d = torch.empty((e, k), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((e, k, 3), dtype=torch.float32, device=q4.device)
    out_d[qperm.long()] = _read_back(d2, q4)[:e]
    out_c[qperm.long()] = coords[:e]
    return out_d, out_c


def knn_index_launch_plain(q4: torch.Tensor, r4: torch.Tensor,
                           flags: torch.Tensor, qperm: torch.Tensor, m: int,
                           k: int = K) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K5 (:func:`knn_index_launch`) returns on tensors from
    :func:`knn_prepare_batched` (flags (B, n_e, n_m), ``m`` refs before
    padding), in plain PyTorch: the walk's lists read back as
    :func:`knn_launch_plain` does, the indices clamped to ``m - 1`` and an
    empty slot at index 0 (the TPU kernel's initial index).  A reference
    for checks, not a route."""
    outs = []
    for b in range(flags.shape[0]):
        e = qperm.shape[-1]
        d2, idx = _walk_plain(q4[b], r4[b], flags[b], k)
        idx = torch.where(idx == _NONE, 0, torch.clamp(idx, max=m - 1))
        out_d = torch.empty((e, k), dtype=torch.float32, device=q4.device)
        out_i = torch.empty((e, k), dtype=torch.int32, device=q4.device)
        out_d[qperm[b].long()] = _read_back(d2, q4[b])[:e]
        out_i[qperm[b].long()] = idx[:e].to(torch.int32)
        outs.append((out_d, out_i))
    return (torch.stack([d for d, _ in outs]),
            torch.stack([i for _, i in outs]))


def knn_lines_launch_plain(q4: torch.Tensor, r4: torch.Tensor,
                           flags: torch.Tensor, qperm: torch.Tensor,
                           max_sq_dist: float, eig_ratio: float,
                           min_line_sep: float, k: int = K
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """What K6 returns on tensors from :func:`knn_prepare_batched` (flags
    (B, n_e, n_m)): :func:`knn_launch_plain`'s neighbours through
    ``neighbors._line_fit`` with each query's own mask -> (lpa, lpb, valid)
    (B, E, ...)."""
    # imported here: neighbors builds on this module
    from liodom_tpu_torch.ops.neighbors import _line_fit
    d2, near = knn_launch_plain(q4, r4, flags, qperm, k)
    qmask = torch.zeros(qperm.shape, dtype=torch.bool, device=q4.device)
    qmask.scatter_(-1, qperm.long(), q4[..., :qperm.shape[-1], 3] != 0)
    return tuple(_line_fit(near, d2[..., k - 1], qmask, max_sq_dist,
                           eig_ratio, min_line_sep))


def knn_index_plain(query: torch.Tensor, qmask: torch.Tensor,
                    ref: torch.Tensor, rmask: torch.Tensor, k: int = K
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: exact k-NN by brute force over ref chunks, query
    (..., E, 3), qmask (..., E), ref (..., M, 3), rmask (..., M) -> (d2
    (..., E, k) ascending, idx (..., E, k) int32 into ref); a leading batch
    dimension is looped.

    d2 is ``(dx*dx + dy*dy) + dz*dz`` with each operation rounded, the
    kernel's expression; equal distances go to the lower index.  Invalid
    refs are never picked and invalid queries read ``_BIG``; a row with
    fewer than k valid refs is filled with ``_BIG`` at index ``M - 1``
    (``knn_pallas.py:244-247`` clamps there).  As in :func:`knn_coords_plain`
    only the valid refs are searched, and blocks of queries without a valid
    one are skipped."""
    if query.ndim == 3:
        outs = [knn_index_plain(query[b], qmask[b], ref[b], rmask[b], k)
                for b in range(query.shape[0])]
        return (torch.stack([d for d, _ in outs]),
                torch.stack([i for _, i in outs]))
    e, m = query.shape[0], ref.shape[0]
    dev = query.device
    keep = torch.nonzero(rmask).squeeze(1)              # valid refs, in order
    planes = ref[keep].t().contiguous()                 # (3, M_valid)
    none = _index_keys(torch.full((), _BIG, dtype=torch.float32),
                       torch.tensor(m - 1, dtype=torch.int64))
    best = torch.full((e, k), int(none), dtype=torch.int64, device=dev)
    for q0 in range(0, e, _QBLOCK):
        q1 = q0 + _QBLOCK
        if not bool(qmask[q0:q1].any()):
            continue
        q = query[q0:q1]
        bk = best[q0:q1]
        for off in range(0, keep.shape[0], _CHUNK):
            rx, ry, rz = planes[:, off:off + _CHUNK]
            d2 = q[:, 0:1] - rx[None, :]
            d2.mul_(d2)
            t = q[:, 1:2] - ry[None, :]
            t.mul_(t)
            d2.add_(t)
            torch.sub(q[:, 2:3], rz[None, :], out=t)
            t.mul_(t)
            d2.add_(t)
            ck = _index_keys(d2, keep[None, off:off + _CHUNK])
            ck = torch.topk(ck, min(k, ck.shape[1]), dim=1, largest=False,
                            sorted=True).values
            bk = torch.topk(torch.cat([bk, ck], dim=1), k, dim=1,
                            largest=False, sorted=True).values
        best[q0:q1] = bk
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    idx = (best & 0xFFFFFFFF).to(torch.int32)
    d2 = d2.masked_fill(~qmask[:, None], _BIG)
    return torch.clamp(d2, min=0.0), idx


def knn_index_launch(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
                     qperm: torch.Tensor, m: int, k: int = K
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on tensors from :func:`knn_prepare_batched` (``m`` refs
    before padding) -> (d2 (B, E, k), idx (B, E, k) int32 into the r4 rows,
    clamped to ``m - 1``) in each element's query order: one kernel
    launch; k above ``MAX_K`` launches :func:`knn_index_launch_any_k`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_index_launch takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, n_e, n_m = _check_prepared(q4, r4, flags, qperm, "knn_index_launch")
    _check_k(k, r4.shape[1], "knn_index_launch")
    if not 0 < m <= r4.shape[1]:
        raise ValueError(f"knn_index_launch: {m} refs in {r4.shape[1]} rows")
    if k > MAX_K:
        return knn_index_launch_any_k(q4, r4, flags, qperm, m, k)
    b = flags.shape[0]
    dev = q4.device
    out_d = torch.empty((b, e, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, e, k), dtype=torch.int32, device=dev)
    lib = kernels.load("knn_index", _INDEX_SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_knn_index(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), b, e, n_e, n_m, m, TILE_E,
            TILE_M, k, stream)
    kernels.check(err, "liodom_knn_index")
    knn_index_launch.launches += 1
    return out_d, out_i


knn_index_launch.launches = 0


def knn_index_launch_any_k(q4: torch.Tensor, r4: torch.Tensor,
                           flags: torch.Tensor, qperm: torch.Tensor, m: int,
                           k: int = K
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on ``ListWalk`` at any k, the same contract as
    :func:`knn_index_launch`."""
    if flags.ndim != 3:
        raise ValueError(f"knn_index_launch_any_k takes a batch, flags "
                         f"{tuple(flags.shape)}")
    e, _, _ = _check_prepared(q4, r4, flags, qperm, "knn_index_launch_any_k")
    _check_k(k, r4.shape[1], "knn_index_launch_any_k")
    if not 0 < m <= r4.shape[1]:
        raise ValueError(f"knn_index_launch_any_k: {m} refs in "
                         f"{r4.shape[1]} rows")
    b = flags.shape[0]
    out_d = torch.empty((b, e, k), dtype=torch.float32, device=q4.device)
    out_i = torch.empty((b, e, k), dtype=torch.int32, device=q4.device)
    _any_k("knn_index", "liodom_knn_index_any_k", q4, r4, flags, qperm, k,
           (out_d, out_i), extra_ints=(m,))
    knn_index_launch_any_k.launches += 1
    return out_d, out_i


knn_index_launch_any_k.launches = 0


def knn_index_cuda(query: torch.Tensor, qmask: torch.Tensor,
                   ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                   max_radius: Optional[float] = None,
                   ref_presorted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors, one pair (query (E, 3), ...) or a batch (query
    (B, E, 3), ...) -> (d2, idx) with the query's leading shape, the
    contract of ``knn_pallas.py:144-256``: idx int32 into the caller's ref.
    With ``max_radius`` neighbours within it are exact and farther ones may
    read ``_BIG``; both sides are sorted and the indices mapped back."""
    batched = query.ndim == 3
    _check_points(query, qmask, ref, rmask, k, batched, "knn_index_cuda")
    if not batched:
        query, qmask, ref, rmask = (t[None] for t in (query, qmask, ref,
                                                      rmask))
    *prep, rperm = _prepare_batched(query, qmask, ref, rmask, max_radius,
                                    ref_presorted)
    d2, idx = knn_index_launch(*prep, ref.shape[1], k)
    if rperm is not None:
        idx = rperm.gather(1, idx.flatten(1).long()).view(idx.shape).to(
            torch.int32)
    return (d2, idx) if batched else (d2[0], idx[0])


def knn_index(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
              rmask: torch.Tensor, k: int = K,
              max_radius: Optional[float] = None,
              ref_presorted: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain brute force for CPU tensors (exact everywhere, so it needs no
    sort or radius)."""
    if query.is_cuda:
        return knn_index_cuda(query, qmask, ref, rmask, k, max_radius,
                              ref_presorted)
    kernels.require_cpu(query, "knn_index")
    return knn_index_plain(query, qmask, ref, rmask, k)
