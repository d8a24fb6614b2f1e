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
each other and with the TPU kernel for the same smoothness plane.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import EdgeCloud, RingImage

_SLOT_LIMIT = 128  # slots per ring the TPU kernel lays out (n_regions * max_picks)

_SIG = [("liodom_select_edges", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
         + [ctypes.c_float] * 2 + [ctypes.c_void_p])]


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
    :func:`select_edges_plain`.  The kernel derives the reach plane's gap
    flags from the ring image itself, so the whole stage is one launch."""
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
    if s > _SLOT_LIMIT:
        raise NotImplementedError(
            f"{s} edge slots per ring > {_SLOT_LIMIT}: the TPU package falls "
            f"back to select_edges_xla here, which is not ported")
    if w * 6 > 227 * 1024:
        raise ValueError(f"ring width {w} does not fit the kernel's shared "
                         f"memory (6 bytes a column, 227 KB)")
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


def select_edges_kernel(img: RingImage, smooth: torch.Tensor,
                        cfg: LiodomConfig) -> EdgeCloud:
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if img.xyz.is_cuda:
        return select_edges_cuda(img, smooth, cfg)
    kernels.require_cpu(img.xyz, "select_edges")
    return select_edges_plain(img, smooth, cfg)
