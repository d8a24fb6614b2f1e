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
lists fit a block's shared memory (:func:`select_smem_bytes`), and a ring
too wide for that takes the same kernel with its column arrays in device
memory (:func:`select_edges_global_cuda`): any width, as JAX.

The kernel walks each region's columns in (value desc, column asc) order
instead of repeating an arg-max: :func:`select_walk` is that algorithm in
plain code (the top ``L = 11 * max_picks + 5`` columns of every region,
then the ordered walk in windows of 32 entries, one warp step a window and
a round of its resolution), the tests' model of the kernel and the count
of its dependent steps.  The device-memory path builds those lists by a
top-L selection instead of ranking every column
(:func:`select_lists_topl` models it: order keys, a radix select of the
L-th key, the ties at it taken in column order, a sorting network).
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
# bits a digit of the device-memory path's radix select (csrc/select.cu
# kRadixBits), and the most entries a list it orders by counting (one a
# thread, kThreads; longer ones by the network)
RADIX_BITS = 8
COUNT_MAX = 256

_SIG = [("liodom_select_edges", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
         + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
        ("liodom_select_edges_global", [ctypes.c_void_p] * 7
         + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p]),
        ("liodom_select_shape", [ctypes.c_int] * 3 + [ctypes.c_void_p]),
        ("liodom_select_global_shape", [ctypes.c_int] * 3
         + [ctypes.c_void_p])]


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


def order_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) whose ascending order is the descending order
    of ``values`` (float32) as the kernel folds them: NaN as -inf, -0.0 as
    +0.0.  With ``u`` the folded float's bits, ``asc = ~u`` for a negative
    value and ``u | 2^31`` otherwise (ascending with the value), and the
    key is ``~asc``: equal keys are equal values."""
    v = torch.where(torch.isnan(values), float("-inf"), values)
    v = torch.where(v == 0, torch.zeros_like(v), v).to(torch.float32)
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    asc = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return ~asc & 0xFFFFFFFF


def sort_network(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n,) sorted ascending by the kernel's network: a bitonic sort
    of the next power of two p >= n written with ascending comparators only
    (each stage's first step compares i with its mirror in the 2^s block,
    the rest i with i + j), every comparator whose upper index is n or more
    skipped.  The padding would be +inf at the top, which no such
    comparator moves, so the skip is exact and no padding is stored."""
    x = x.clone()
    n = x.numel()
    p = 1
    while p < n:
        p *= 2
    c = torch.arange(p // 2, dtype=torch.int64)
    k = 2
    while k <= p:
        j = k // 2
        while j > 0:
            off = c & (j - 1)
            lo = 2 * c - off
            hi = lo + (k - 1 - 2 * off if j == k // 2 else j)
            keep = hi < n
            a, b = x[lo[keep]], x[hi[keep]]
            x[lo[keep]] = torch.minimum(a, b)
            x[hi[keep]] = torch.maximum(a, b)
            j //= 2
        k *= 2
    return x


def select_lists_topl(values: torch.Tensor, cap: int,
                      radix_bits: int = RADIX_BITS) -> torch.Tensor:
    """One region's list as ``csrc/select.cu``'s device-memory path builds
    it: the positions (int64, 0 .. len - 1) of the first min(cap, len)
    entries of its (value desc, column asc) order, in that order, from the
    region's float32 ``values``.

    The kernel's steps: :func:`order_keys`; where cap < len, a radix select
    of the cap-th smallest key, most significant digit of ``radix_bits``
    first (a histogram of the digit over the keys that share the digits
    found so far, the digit whose counts reach the rank left), stopping
    early once every key with the prefix found is wanted; the keys below
    that prefix kept, then the lowest positions among those equal to it, up
    to the count left, by a prefix count in column order; the keys below,
    placed in any order (the kernel's atomics; here a seeded shuffle), as
    ``key << 32 | position`` ordered by counting (each entry's place is
    the count of entries below it) while the list has at most
    :data:`COUNT_MAX` entries, else through :func:`sort_network`; then the
    ties, which follow them in column order already (where every key with
    the prefix is wanted, all of them are ordered)."""
    keys = order_keys(values)
    n_all = keys.numel()
    n = min(cap, n_all)
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64)
    prefix, mask, k = 0, 0, n
    take_all = n == n_all
    hi = 32
    while not take_all and hi > 0:
        lo = max(0, hi - radix_bits)
        ones = (1 << (hi - lo)) - 1
        digits = (keys[(keys & mask) == prefix] >> lo) & ones
        hist = torch.bincount(digits, minlength=ones + 1)
        excl = torch.cumsum(hist, 0) - hist
        d = int(torch.nonzero((excl < k) & (k <= excl + hist))[0, 0])
        k -= int(excl[d])
        prefix |= d << lo
        mask |= ones << lo
        take_all = k == int(hist[d])
        hi = lo
    masked = keys & mask
    eq = masked == prefix
    below = masked < prefix
    ties = torch.zeros(0, dtype=torch.int64)
    if take_all:
        below = below | eq
    else:                 # the first k equal to t, in column order, last
        ties = torch.nonzero(eq & (torch.cumsum(eq, 0) <= k))[:, 0]
    pos = torch.nonzero(below)[:, 0]
    assert pos.numel() + ties.numel() == n
    gen = torch.Generator().manual_seed(n)
    pos = pos[torch.randperm(pos.numel(), generator=gen)]
    # the kernel's unsigned (key << 32 | position), offset by 2^63 to fit
    # int64 in the same order
    comp = ((keys[pos] - (1 << 31)) << 32) | pos
    if n <= COUNT_MAX:      # each entry's place: the entries below it
        place = (comp[None, :] < comp[:, None]).sum(1)
        ordered = torch.empty_like(comp).index_put_((place,), comp)
    else:
        ordered = sort_network(comp)
    return torch.cat([ordered & 0xFFFFFFFF, ties])


def select_walk(smooth: torch.Tensor, reach: torch.Tensor,
                count: torch.Tensor, cfg: LiodomConfig,
                list_len: Optional[int] = None, lists: str = "sorted"):
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
    ``lists``: "sorted" cuts each region's sorted order; "topl" builds the
    lists as the device-memory path does (:func:`select_lists_topl`).

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
    if lists not in ("sorted", "topl"):
        raise ValueError(f"select_walk: lists {lists!r}")
    raw = smooth.cpu()
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
            n_region = max(end - start, 0)
            if lists == "topl":
                lst = (select_lists_topl(raw[ring, start:start + n_region],
                                         cap) + start).tolist()
            else:
                lst = sorted(range(start, start + n_region),
                             key=lambda c: (-row[c], c))[:cap]
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
            if (not ended and picks < max_picks and n_region > cap):
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


def _check_cuda(img: RingImage, smooth: torch.Tensor, what: str):
    xyz, count = img.xyz, img.count
    if not (xyz.is_cuda and count.device == xyz.device
            and smooth.device == xyz.device):
        raise ValueError(f"{what} needs all tensors on one CUDA device")
    if (xyz.dtype != torch.float32 or smooth.dtype != torch.float32
            or count.dtype != torch.int32):
        raise TypeError(f"{what} takes float32 xyz and smoothness and int32 "
                        f"count")
    r, w = xyz.shape[0], xyz.shape[1]
    if (xyz.ndim != 3 or xyz.shape[2] != 3 or smooth.shape != (r, w)
            or count.shape != (r,)):
        raise ValueError(f"{what} shapes: xyz {tuple(xyz.shape)}, smooth "
                         f"{tuple(smooth.shape)}, count {tuple(count.shape)}")
    if not (xyz.is_contiguous() and smooth.is_contiguous()
            and count.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")


def _select_launch(symbol: str, img: RingImage, smooth: torch.Tensor,
                   cfg: LiodomConfig, scratch=()
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K2's ``symbol`` (``scratch``: the global path's) ->
    the slots (bidx (R, S) i32, bval (R, S) i32, pts (R, S, 3))."""
    xyz, count = img.xyz, img.count
    r, w = xyz.shape[0], xyz.shape[1]
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    s = n_regions * max_picks
    bidx = torch.empty((r, s), dtype=torch.int32, device=xyz.device)
    bval = torch.empty((r, s), dtype=torch.int32, device=xyz.device)
    pts = torch.empty((r, s, 3), dtype=torch.float32, device=xyz.device)
    lib = kernels.load("select", _SIG)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            smooth.data_ptr(), count.data_ptr(), xyz.data_ptr(),
            bidx.data_ptr(), bval.data_ptr(), pts.data_ptr(),
            *(t.data_ptr() for t in scratch), r, w, n_regions, max_picks,
            cfg.min_points_per_scan, f32(cfg.smoothness_threshold),
            f32(cfg.neighbor_gap_sq), stream)
    kernels.check(err, symbol)
    return bidx, bval, pts


def _edges(slots) -> EdgeCloud:
    _, bval, pts = slots
    return EdgeCloud(pts.reshape(-1, 3), (bval != 0).reshape(-1))


def select_edges_cuda(img: RingImage, smooth: torch.Tensor,
                      cfg: LiodomConfig) -> EdgeCloud:
    """Launch K2 on CUDA tensors; same contract and slot layout as
    :func:`select_edges_plain`, any number of slots a ring.  The kernel
    derives the reach plane's gap flags from the ring image itself, so the
    whole stage is one launch.  A ring whose arrays need more than a
    block's shared memory (:func:`select_smem_bytes`) launches
    :func:`select_edges_global_cuda`."""
    _check_cuda(img, smooth, "select_edges_cuda")
    if select_smem_bytes(img.xyz.shape[1], cfg.scan_regions,
                         cfg.max_edges_per_region) > _SMEM_LIMIT:
        return select_edges_global_cuda(img, smooth, cfg)
    out = _edges(_select_launch("liodom_select_edges", img, smooth, cfg))
    select_edges_cuda.launches += 1
    return out


select_edges_cuda.launches = 0


def select_global_shape(width: int, n_regions: int, max_picks: int) -> dict:
    """K2's global path as the built library lays it out for a ring width
    and slot layout: whether the lists and slots go to the device scratch,
    the columns of a region whose order keys a block's shared memory holds
    (a longer region's are read from the plane at each radix pass), that
    shared memory in bytes, the scratch's bytes a ring, the radix digit's
    bits and the blocks of a ring's cluster.  Builds the library if
    needed; launches nothing."""
    lib = kernels.load("select", _SIG)
    out = (ctypes.c_longlong * 6)()
    kernels.check(lib.liodom_select_global_shape(
        width, n_regions, max_picks, ctypes.addressof(out)),
        "liodom_select_global_shape")
    return {"lists_in_scratch": bool(out[0]), "keys_in_smem": out[1],
            "dynamic_smem_bytes": out[2], "scratch_bytes_per_ring": out[3],
            "radix_bits": out[4], "cluster_blocks": out[5]}


def select_slots_global(img: RingImage, smooth: torch.Tensor,
                        cfg: LiodomConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of K2's device-memory path -> its slots (bidx (R, S)
    i32, bval (R, S) i32, pts (R, S, 3)), :func:`select_plain`'s layout;
    counts nothing (:func:`select_edges_global_cuda` is the route)."""
    _check_cuda(img, smooth, "select_slots_global")
    r, w = img.xyz.shape[0], img.xyz.shape[1]
    per_ring = select_global_shape(w, cfg.scan_regions,
                                   cfg.max_edges_per_region)
    # one buffer a device, written before it is read, never cleared
    scratch = kernels.device_scratch(
        "select", img.xyz.device, r * per_ring["scratch_bytes_per_ring"],
        torch.uint8, floor=1 << 20)
    return _select_launch("liodom_select_edges_global", img, smooth, cfg,
                          (scratch,))


def select_edges_global_cuda(img: RingImage, smooth: torch.Tensor,
                             cfg: LiodomConfig) -> EdgeCloud:
    """K2 with each ring's column arrays in a device scratch
    (``liodom_select_edges_global``), at any ring width up to 2^24 - 1 and
    any slot count; the same contract, slots and picks as
    :func:`select_edges_cuda`, one launch."""
    out = _edges(select_slots_global(img, smooth, cfg))
    select_edges_global_cuda.launches += 1
    return out


select_edges_global_cuda.launches = 0


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
