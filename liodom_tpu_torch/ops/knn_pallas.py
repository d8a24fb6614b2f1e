"""K3, exact 5-NN with neighbour coordinates: CUDA kernel wrapper + plain
version.

Port of ``liodom_tpu/ops/knn_pallas.py:knn_coords_pallas`` and its helpers.
The correspondence search (laser_odometry.cc:318-323) runs an exact 5-NN of
every edge against the matching map, twice a frame; the line fit only reads
the neighbours' coordinates, so the kernel returns those instead of indices.

CUDA route (:func:`knn_coords_cuda`): both sides are sorted on coarse 2 m
cells (:func:`_spatial_order`; the map once a frame by
:func:`spatial_sort_points`), per-tile bounding boxes give (query tile, ref
tile) pair flags (:func:`_pair_flags`), and ``csrc/knn_coords.cu`` visits the
flagged pairs only.  Invalid refs are displaced by ``2 * _FAR`` and read back
through ``_FAR_PICK_D2``.  Neighbours within ``max_radius`` are exact; beyond
it a distance may read ``_BIG``, which the consumer's accept gate
(``d2[k-1] < max_sq_dist``) treats the same.

CPU route (:func:`knn_coords_plain`): exact brute force over ref chunks with
``torch.topk``, invalid refs at ``_BIG``.
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

TILE_E = 64    # queries per block in csrc/knn_coords.cu
TILE_M = 512   # refs per staged tile in csrc/knn_coords.cu
K = 5          # neighbours the kernel keeps
SORT_CELL = 2.0  # metres; the spatial sort's cell on the CUDA route
_CHUNK = 4096    # refs per brute-force chunk of the plain version
_QBLOCK = 512    # queries per block of the plain version

_SIG = [("liodom_knn_coords", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
         + [ctypes.c_void_p])]


def _spatial_order(xyz: torch.Tensor, mask: torch.Tensor,
                   cell: float = SORT_CELL) -> torch.Tensor:
    """Permutation grouping valid points by coarse spatial cell (x-major
    lexicographic; 64-cell wrap per axis).  Wrap aliasing only weakens tile
    locality — correctness never depends on the key, only on the per-tile
    boxes computed from real coordinates.  Invalid points sort last."""
    c = torch.clamp(torch.floor(xyz / cell).to(torch.int32) & 63, 0, 63)
    key = (c[:, 0] << 12) | (c[:, 1] << 6) | c[:, 2]
    key = torch.where(mask, key, torch.full_like(key, 1 << 20))
    return torch.argsort(key, stable=True)


def _tile_aabbs(xyz: torch.Tensor, mask: torch.Tensor, tile: int):
    """Per-tile axis-aligned bounding boxes over valid points + non-empty
    flag.  xyz (N, 3) with N % tile == 0."""
    n = xyz.shape[0] // tile
    x = xyz.reshape(n, tile, 3)
    v = mask.reshape(n, tile, 1)
    lo = x.masked_fill(~v, _BIG).amin(dim=1)
    hi = x.masked_fill(~v, -_BIG).amax(dim=1)
    return lo, hi, v[:, :, 0].any(dim=1)


def _pair_flags(qlo, qhi, qne, rlo, rhi, rne,
                max_radius: Optional[float]) -> torch.Tensor:
    """(n_e, n_m) int32: 1 where both tiles hold points and (under radius
    pruning) their boxes are within ``max_radius``."""
    ne = qne[:, None] & rne[None, :]
    if max_radius is None:
        return ne.to(torch.int32)
    gap = torch.clamp(torch.maximum(qlo[:, None, :] - rhi[None, :, :],
                                    rlo[None, :, :] - qhi[:, None, :]),
                      min=0.0)
    d2 = (gap * gap).sum(dim=-1)
    return (ne & (d2 <= max_radius * max_radius)).to(torch.int32)


def spatial_sort_points(xyz: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially order a padded point set (valid rows front-compacted,
    grouped by coarse cell) so repeated kNN calls over it can pass
    ``ref_presorted=True``.  The point set is unchanged; the order of the
    matching map carries no semantics."""
    perm = _spatial_order(xyz, mask)
    ok = mask[perm]
    return torch.where(ok[:, None], xyz[perm], torch.zeros_like(xyz)), ok


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


def knn_prepare(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
                rmask: torch.Tensor, max_radius: Optional[float],
                ref_presorted: bool = False):
    """The wrapper's tensor work before the launch, all on the device:
    sorted and padded queries ``q4`` [x y z valid], encoded and padded refs
    ``r4``, the (n_e, n_m) pair flags and the query permutation."""
    e, m = query.shape[0], ref.shape[0]
    qperm = _spatial_order(query, qmask)
    qs, qms = query[qperm], qmask[qperm]
    if not ref_presorted:
        rperm = _spatial_order(ref, rmask)
        ref, rmask = ref[rperm], rmask[rperm]
    ep = e + (-e) % TILE_E
    mp = m + (-m) % TILE_M
    dev = query.device
    q4 = torch.zeros((ep, 4), dtype=torch.float32, device=dev)
    q4[:e, :3] = qs
    q4[:e, 3] = qms.to(torch.float32)
    r4 = torch.full((mp, 4), _FAR, dtype=torch.float32, device=dev)
    r4[:m, :3] = torch.where(rmask[:, None], ref, ref + 2.0 * _FAR)
    qm_p = torch.zeros(ep, dtype=torch.bool, device=dev)
    qm_p[:e] = qms
    rm_p = torch.zeros(mp, dtype=torch.bool, device=dev)
    rm_p[:m] = rmask
    qlo, qhi, qne = _tile_aabbs(q4[:, :3], qm_p, TILE_E)
    rlo, rhi, rne = _tile_aabbs(r4[:, :3], rm_p, TILE_M)
    flags = _pair_flags(qlo, qhi, qne, rlo, rhi, rne, max_radius).contiguous()
    return q4, r4, flags, qperm.to(torch.int32)


def knn_launch(q4: torch.Tensor, r4: torch.Tensor, flags: torch.Tensor,
               qperm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the prepared tensors -> (d2 (E, 5), coords (E, 5, 3)) in
    the caller's query order."""
    if not all(t.is_cuda and t.device == q4.device
               for t in (q4, r4, flags, qperm)):
        raise ValueError("knn_launch needs all tensors on one CUDA device")
    if (q4.dtype != torch.float32 or r4.dtype != torch.float32
            or flags.dtype != torch.int32 or qperm.dtype != torch.int32):
        raise TypeError("knn_launch takes float32 points and int32 flags "
                        "and permutation")
    n_e, n_m = flags.shape
    e = qperm.shape[0]
    if (q4.shape != (n_e * TILE_E, 4) or r4.shape != (n_m * TILE_M, 4)
            or e > n_e * TILE_E):
        raise ValueError(f"knn_launch shapes: q4 {tuple(q4.shape)}, r4 "
                         f"{tuple(r4.shape)}, flags {tuple(flags.shape)}, "
                         f"qperm {tuple(qperm.shape)}")
    if not all(t.is_contiguous() for t in (q4, r4, flags, qperm)):
        raise ValueError("knn_launch needs contiguous tensors")
    out_d = torch.empty((e, K), dtype=torch.float32, device=q4.device)
    out_c = torch.empty((e, K, 3), dtype=torch.float32, device=q4.device)
    lib = kernels.load("knn_coords", _SIG)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_knn_coords(
            q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
            out_d.data_ptr(), out_c.data_ptr(), e, n_e, n_m, TILE_E, TILE_M,
            K, stream)
    kernels.check(err, "liodom_knn_coords")
    knn_launch.launches += 1
    return out_d, out_c


knn_launch.launches = 0


def knn_coords_cuda(query: torch.Tensor, qmask: torch.Tensor,
                    ref: torch.Tensor, rmask: torch.Tensor, k: int = K,
                    max_radius: Optional[float] = None,
                    ref_presorted: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors (see the module docstring for the contract)."""
    if k != K:
        raise NotImplementedError(f"the kNN kernel keeps k={K}, asked {k}")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("knn_coords_cuda takes float32 points")
    if (query.ndim != 2 or query.shape[1] != 3 or ref.ndim != 2
            or ref.shape[1] != 3 or qmask.shape != query.shape[:1]
            or rmask.shape != ref.shape[:1]):
        raise ValueError(f"knn_coords_cuda shapes: query "
                         f"{tuple(query.shape)}, ref {tuple(ref.shape)}")
    q4, r4, flags, qperm = knn_prepare(query, qmask, ref, rmask, max_radius,
                                       ref_presorted)
    return knn_launch(q4, r4, flags, qperm)


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
