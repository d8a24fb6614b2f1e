"""K2, region-wise greedy edge selection: CUDA kernel wrapper + plain version.

Port of ``liodom_tpu/ops/select_pallas.py``.  The pick chain of
``extractFeaturesFromRegion`` (feature_extractor.cc:256-313) is serial by
construction: per ring, ``scan_regions x (edges_per_region + 1)`` dependent
picks, each the highest-smoothness unpicked point of its region (lowest
column on ties), which suppresses up to 5 neighbours per side.

:func:`select_edges_kernel` dispatches on the tensor's device: a CUDA tensor
launches ``csrc/select.cu``; a CPU tensor takes :func:`select_plain`, which
runs the chain with all rings in lockstep exactly as the TPU kernel does.
Both compare values and never compute with them, so they are bit-exact with
each other and with the TPU kernel for the same smoothness plane.  The JAX
package lays out at most 128 slots a ring in its kernel and takes
``select_edges_xla`` above that; the CUDA kernel takes any slot count whose
lists fit a block's shared memory (:func:`select_smem_bytes`).

The kernel walks each region's columns in (value desc, column asc) order
instead of repeating an arg-max: :func:`select_walk` is that algorithm in
plain code (the top ``L = 11 * max_picks + 5`` columns of every region,
then the ordered walk in windows of 32 entries, one warp step a window and
a round of its resolution), the tests' model of the kernel and the count
of its dependent steps.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import EdgeCloud, RingImage

_SMEM_LIMIT = 232448   # a block's shared memory on the card, 227 KB
_WARP = 32             # entries a step of the kernel's walk

_SIG = [("liodom_select_edges", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
         + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
        ("liodom_select_shape", [ctypes.c_int] * 3 + [ctypes.c_void_p])]


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a threshold the JAX
    package applies to float32 arrays as a float32 value."""
    return float(np.float32(x))


def _reach_plane(xyz: torch.Tensor, gap_thr: float) -> torch.Tensor:
    """int32 (R, W) plane; bit (l-1) at column j = "a pick at j-l suppresses
    j" (l in 1..5), bit (l+4) at column j = "a pick at j+l suppresses j".

    The reference walks outward from a pick, stopping at the first
    consecutive-point gap^2 > thr (feature_extractor.cc:280-310): forward
    neighbour j = b+l needs the gaps at columns (j-l, j] small, backward
    neighbour j = b-l the gaps at columns j+1..j+l (gap[m] = |p[m]-p[m-1]|^2).
    Rolls wrap around the row exactly as the TPU wrapper's do."""
    diff = xyz - torch.roll(xyz, 1, dims=1)
    gap = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
           + diff[..., 2] * diff[..., 2])
    gap_ok = gap <= f32(gap_thr)
    plane = torch.zeros(gap_ok.shape, dtype=torch.int32, device=xyz.device)
    fwd = torch.ones_like(gap_ok)
    for l in range(1, 6):
        fwd = fwd & torch.roll(gap_ok, -l, dims=1)
        plane = plane | (torch.roll(fwd, l, dims=1).to(torch.int32)
                         << (l - 1))
        plane = plane | (fwd.to(torch.int32) << (l + 4))
    return plane


def select_plain(smooth: torch.Tensor, reach: torch.Tensor,
                 count: torch.Tensor, cfg: LiodomConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pick chain in plain PyTorch, all rings in lockstep:
    smooth (R, W) f32, reach (R, W) i32, count (R,) -> bidx (R, S) i32,
    bval (R, S) bool, S = scan_regions * (edges_per_region + 1)."""
    r, w = smooth.shape
    dev = smooth.device
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    s = n_regions * max_picks
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    count = count.to(torch.int32)
    total = torch.clamp(count - 10, min=0)[:, None]
    sector = total // n_regions
    active = (count >= cfg.min_points_per_scan)[:, None]
    fwd_bits = [((reach >> (l - 1)) & 1) != 0 for l in range(1, 6)]
    bwd_bits = [((reach >> (l + 4)) & 1) != 0 for l in range(1, 6)]
    thr = f32(cfg.smoothness_threshold)
    neg_inf = torch.tensor(float("-inf"), dtype=smooth.dtype, device=dev)

    picked = torch.zeros((r, w), dtype=torch.bool, device=dev)
    done = torch.zeros((r, 1), dtype=torch.bool, device=dev)
    bidx = torch.zeros((r, s), dtype=torch.int32, device=dev)
    bval = torch.zeros((r, s), dtype=torch.bool, device=dev)
    for k in range(s):
        j, p = divmod(k, max_picks)
        start = 5 + sector * j
        end = 5 + (total if j == n_regions - 1 else sector * (j + 1))
        if p == 0:
            done = torch.zeros_like(done)   # a fresh region resets the break
        cand = (cols >= start) & (cols < end) & ~picked & active & ~done
        masked = torch.where(cand, smooth, neg_inf)
        bv = masked.amax(dim=1, keepdim=True)
        # lowest column among the maxima: the reference's stable sort
        bi = torch.where(cand & (masked == bv), cols,
                         torch.full_like(cols, w)).amin(dim=1, keepdim=True)
        do_pick = (bv >= thr) & (bv > neg_inf)
        done = done | ~do_pick
        bidx[:, k] = torch.where(do_pick, bi, torch.zeros_like(bi))[:, 0]
        bval[:, k] = do_pick[:, 0]
        newly = cols == bi
        for l in range(1, 6):
            newly = newly | ((cols - bi == l) & fwd_bits[l - 1])
            newly = newly | ((bi - cols == l) & bwd_bits[l - 1])
        picked = picked | (newly & do_pick)
    return bidx, bval


def walk_list_len(max_picks: int) -> int:
    """L, the entries of a region's (value desc, column asc) order that the
    kernel's walk can visit: each pick marks at most 10 other columns and
    the earlier regions' picks at most the region's first 5."""
    return 11 * max_picks + 5


def select_smem_bytes(width: int, n_regions: int, max_picks: int) -> int:
    """A K2 block's dynamic shared memory (``csrc/select.cu``): the
    regions' lists, min(L, its length) entries each at 8 bytes (the regions
    are disjoint, so min(n_regions L, width) in all), the slots at 4, a
    region's values at 4 bytes a column and its gap flags at 1 (10 more)."""
    lists = min(n_regions * walk_list_len(max_picks), width)
    return 8 * lists + 4 * n_regions * max_picks + 5 * width + 10


def select_walk(smooth: torch.Tensor, reach: torch.Tensor,
                count: torch.Tensor, cfg: LiodomConfig,
                list_len: Optional[int] = None):
    """The kernel's algorithm in plain code, a model for checks: per ring
    and region, the region's columns ranked by (value desc, column asc)
    (-0.0 as +0.0, NaN as -inf) and cut to the first ``list_len`` (default
    L, :func:`walk_list_len`); then the regions in order, walked a window
    of 32 entries at a time as ``csrc/select.cu``'s warp does: the open
    entries (not marked by an earlier window's pick) not marked by this
    window's picks so far are candidates; every candidate before the first
    that an earlier candidate's pick would mark (a conflict) and before the
    first below the threshold is a pick, up to the picks left; a conflict
    is dropped and the rest resolved again; a failing candidate ends the
    region.  A pick marks itself and the neighbours its reach bits allow.

    Returns ``(bidx (R, S) i32, bval (R, S) bool, stats)``: the slots as
    :func:`select_plain` lays them out, and ``stats`` with per ring
    ``steps`` (the walk's dependent steps: a window read and each round of
    its resolution), ``visited`` (the most entries of one region's order
    read up to its last pick or failing entry) and ``overflow`` (regions
    whose cut list ran out before the walk ended, where the cut changed the
    answer: 0 whenever ``list_len`` >= L)."""
    r, w = smooth.shape
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    cap = walk_list_len(max_picks) if list_len is None else list_len
    thr = f32(cfg.smoothness_threshold)
    sm = torch.where(torch.isnan(smooth), float("-inf"), smooth) + 0.0
    sm = torch.where(sm == 0, torch.zeros_like(sm), sm).tolist()
    reach = reach.tolist()
    count = count.tolist()
    bidx = [[0] * (n_regions * max_picks) for _ in range(r)]
    bval = [[False] * (n_regions * max_picks) for _ in range(r)]
    steps, visited, overflow = [0] * r, [0] * r, 0
    for ring in range(r):
        cnt = int(count[ring])
        if cnt < cfg.min_points_per_scan:
            continue
        total = max(cnt - 10, 0)
        sector = total // n_regions
        row, bits = sm[ring], reach[ring]
        picked = [False] * w

        def marks(c):
            """the columns a pick at c marks"""
            out = [c]
            for l in range(1, 6):
                if c + l < w and (bits[c + l] >> (l - 1)) & 1:
                    out.append(c + l)
                if c - l >= 0 and (bits[c - l] >> (l + 4)) & 1:
                    out.append(c - l)
            return out

        for j in range(n_regions):
            start = 5 + sector * j
            end = min(5 + (total if j == n_regions - 1
                           else sector * (j + 1)), w)
            order = sorted(range(start, max(end, start)),
                           key=lambda c: (-row[c], c))
            lst = order[:cap]
            picks, pos, ended = 0, 0, False
            while not ended and picks < max_picks and pos < len(lst):
                win = lst[pos:pos + _WARP]
                steps[ring] += 1
                hit = [set(marks(c)) for c in win]
                # cov[i]: the window's lanes before i whose pick marks i
                cov = [{h for h in range(i) if win[i] in hit[h]}
                       for i in range(len(win))]
                rem = [i for i, c in enumerate(win) if not picked[c]]
                taken = set()
                while rem:
                    steps[ring] += 1
                    cands = [i for i in rem if not cov[i] & taken]
                    if not cands:
                        break
                    conflict = [i for i in cands if cov[i] & set(cands)]
                    fails = [i for i in cands if i not in conflict
                             and not (row[win[i]] >= thr
                                      and row[win[i]] > float("-inf"))]
                    stop = min(conflict[:1] + fails[:1] + [_WARP])
                    acc = [i for i in cands if i < stop]
                    acc = acc[:max_picks - picks]
                    for i in acc:
                        bidx[ring][j * max_picks + picks] = win[i]
                        bval[ring][j * max_picks + picks] = True
                        picks += 1
                        for m in hit[i]:
                            picked[m] = True
                    taken |= set(acc)
                    last = (max(acc) if acc else -1)
                    if picks == max_picks:
                        break
                    if fails and (not conflict or fails[0] < conflict[0]):
                        last = fails[0]
                        ended = True
                        break
                    if stop == _WARP:
                        break
                    rem = [i for i in cands if i > conflict[0]]
                visited[ring] = max(visited[ring], pos + last + 1)
                pos += _WARP
            if (not ended and picks < max_picks and len(order) > cap):
                overflow += 1
    dev = smooth.device
    stats = {"steps": steps, "visited": visited, "overflow": overflow}
    return (torch.tensor(bidx, dtype=torch.int32, device=dev),
            torch.tensor(bval, dtype=torch.bool, device=dev), stats)


def select_edges_plain(img: RingImage, smooth: torch.Tensor,
                       cfg: LiodomConfig) -> EdgeCloud:
    """Plain version of the whole stage: reach plane, pick chain, gather.
    Slot layout: ring * S + region * max_picks + pick."""
    w = img.xyz.shape[1]
    reach = _reach_plane(img.xyz, cfg.neighbor_gap_sq)
    bidx, bval = select_plain(smooth, reach, img.count, cfg)
    idx = torch.clamp(bidx, 0, w - 1).long()
    pts = torch.gather(img.xyz, 1, idx[:, :, None].expand(-1, -1, 3))
    pts = torch.where(bval[:, :, None], pts, torch.zeros_like(pts))
    return EdgeCloud(pts.reshape(-1, 3), bval.reshape(-1))


def select_edges_cuda(img: RingImage, smooth: torch.Tensor,
                      cfg: LiodomConfig) -> EdgeCloud:
    """Launch K2 on CUDA tensors; same contract and slot layout as
    :func:`select_edges_plain`, any number of slots a ring.  The kernel
    derives the reach plane's gap flags from the ring image itself, so the
    whole stage is one launch."""
    xyz, count = img.xyz, img.count
    if not (xyz.is_cuda and count.device == xyz.device
            and smooth.device == xyz.device):
        raise ValueError("select_edges_cuda needs all tensors on one CUDA "
                         "device")
    if (xyz.dtype != torch.float32 or smooth.dtype != torch.float32
            or count.dtype != torch.int32):
        raise TypeError("select_edges_cuda takes float32 xyz and smoothness "
                        "and int32 count")
    r, w = xyz.shape[0], xyz.shape[1]
    if (xyz.ndim != 3 or xyz.shape[2] != 3 or smooth.shape != (r, w)
            or count.shape != (r,)):
        raise ValueError(f"select_edges_cuda shapes: xyz {tuple(xyz.shape)}, "
                         f"smooth {tuple(smooth.shape)}, "
                         f"count {tuple(count.shape)}")
    if not (xyz.is_contiguous() and smooth.is_contiguous()
            and count.is_contiguous()):
        raise ValueError("select_edges_cuda needs contiguous tensors")
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    s = n_regions * max_picks
    smem = select_smem_bytes(w, n_regions, max_picks)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ring width {w} with {n_regions} x {max_picks} "
                         f"slots needs {smem} bytes of the kernel's shared "
                         f"memory, more than 227 KB")
    bidx = torch.empty((r, s), dtype=torch.int32, device=xyz.device)
    bval = torch.empty((r, s), dtype=torch.int32, device=xyz.device)
    pts = torch.empty((r, s, 3), dtype=torch.float32, device=xyz.device)
    lib = kernels.load("select", _SIG)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_select_edges(
            smooth.data_ptr(), count.data_ptr(), xyz.data_ptr(),
            bidx.data_ptr(), bval.data_ptr(), pts.data_ptr(), r, w,
            n_regions, max_picks, cfg.min_points_per_scan,
            f32(cfg.smoothness_threshold), f32(cfg.neighbor_gap_sq), stream)
    kernels.check(err, "liodom_select_edges")
    select_edges_cuda.launches += 1
    return EdgeCloud(pts.reshape(-1, 3), (bval != 0).reshape(-1))


select_edges_cuda.launches = 0


def select_shape(width: int, n_regions: int, max_picks: int) -> dict:
    """K2's launch as the built library has it for a ring width and slot
    layout: blocks a ring's cluster, entries a region's list and a block's
    dynamic shared memory.  Builds the library if needed; launches
    nothing."""
    lib = kernels.load("select", _SIG)
    out = (ctypes.c_int * 3)()
    kernels.check(lib.liodom_select_shape(width, n_regions, max_picks,
                                          ctypes.addressof(out)),
                  "liodom_select_shape")
    return {"cluster_blocks": out[0], "list_entries": out[1],
            "dynamic_smem_bytes": out[2]}


def select_edges_kernel(img: RingImage, smooth: torch.Tensor,
                        cfg: LiodomConfig) -> EdgeCloud:
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if img.xyz.is_cuda:
        return select_edges_cuda(img, smooth, cfg)
    kernels.require_cpu(img.xyz, "select_edges")
    return select_edges_plain(img, smooth, cfg)
