"""The ring split (NumPy, float32 as the sensor driver computes it), the
smoothness stencil and the greedy edge selection (plain PyTorch)."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Tuple

import numpy as np
import torch

# the loader's ``180.0f / 3.14159265...f``: pi rounded to float32, then a
# float32 division (57.2957764), one unit of the last place below the
# float32 of 180 / pi
RAD2DEG = np.float32(180.0) / np.float32(np.pi)


@functools.lru_cache(maxsize=1)
def _atanf():
    """The C library's single-precision arctangent, the one a compiled
    loader calls for ``std::atan(float)``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.atanf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _rings64(angle: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HDL-64 ring of each float32 elevation (degrees) and whether it is
    routed (feature_extractor.cc:127-139)."""
    upper = angle >= np.float32(-8.83)
    rid = np.where(
        upper, ((np.float32(2.0) - angle) * np.float32(3.0)
                + np.float32(0.5)).astype(np.int32),
        32 + ((np.float32(-8.83) - angle) * np.float32(2.0)
              + np.float32(0.5)).astype(np.int32))
    ok = ((angle <= np.float32(2.0)) & (angle >= np.float32(-24.33))
          & (rid >= 0) & (rid <= 63))
    return rid, ok


def split_velodyne(pts: np.ndarray, ring_width: int, min_range: float,
                   max_range: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """splitPointCloud for 64 lines: (N, 3) float32 points in sensor order
    to a ((64, ring_width, 3) image, (64,) counts, points past the width).

    Every step rounds to float32 as the loader's C++ does; the arctangent
    is the C library's ``atanf``, which NumPy's own does not always equal
    in the last place.  It is evaluated in float64 for every point, and
    ``atanf`` is called for the points whose ring or gate could move with
    two units of the last place (a few a spin)."""
    pts = np.asarray(pts, np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    d = np.sqrt(x * x + y * y)
    ok = finite & (d >= np.float32(min_range)) & (d <= np.float32(max_range))
    ratio = z / np.maximum(d, np.float32(1e-9))
    at = np.arctan(ratio.astype(np.float64)).astype(np.float32)
    decisions = []
    for steps in (-2, -1, 0, 1, 2):
        a = at
        for _ in range(abs(steps)):
            a = np.nextafter(a, np.float32(np.inf if steps > 0 else -np.inf))
        decisions.append(_rings64(a * RAD2DEG))
    rid, in_fov = decisions[2]
    unsure = np.zeros(len(at), bool)
    for r, o in decisions:
        unsure |= (r != rid) | (o != in_fov)
    unsure &= ok
    if unsure.any():
        atanf = _atanf()
        idx = np.flatnonzero(unsure)
        at[idx] = [atanf(float(v)) for v in ratio[idx]]
        rid, in_fov = _rings64(at * RAD2DEG)
    ok &= in_fov
    img = np.zeros((64, ring_width, 3), np.float32)
    counts = np.zeros(64, np.int32)
    routed = np.flatnonzero(ok)
    order = routed[np.argsort(rid[routed], kind="stable")]
    r_sorted = rid[order]
    starts = np.searchsorted(r_sorted, np.arange(64))
    col = np.arange(len(order)) - starts[r_sorted]
    keep = col < ring_width
    img[r_sorted[keep], col[keep]] = pts[order[keep]]
    np.add.at(counts, r_sorted[keep], 1)
    return img, counts, int((~keep).sum())


def smoothness(xyz: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(R, W) ``|| sum_{l=-5..5} p[j+l] - 11 p[j] ||^2`` on each ring's
    interior ``[5, count - 5)``, 0 elsewhere: ``acc = -11 p``, then the
    taps l = -5 .. 5 added in order, then the squares left to right."""
    w = xyz.shape[1]
    acc = -11.0 * xyz
    for l in range(-5, 6):
        acc = acc + torch.roll(xyz, -l, dims=1)
    s = acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1] \
        + acc[..., 2] * acc[..., 2]
    cols = torch.arange(w, device=xyz.device)
    inside = (cols[None] >= 5) & (cols[None] < count[:, None] - 5)
    return torch.where(inside, s, torch.zeros_like(s))


def _reach(xyz: torch.Tensor, gap_sq: float) -> Tuple[list, list]:
    """For l = 1 .. 5: whether a pick at column j - l suppresses j
    (forward) and whether a pick at j + l does (backward): every gap on
    the way at most ``gap_sq`` (feature_extractor.cc:280-310; gap[m] =
    |p[m] - p[m-1]|^2, the row wrapping round)."""
    diff = xyz - torch.roll(xyz, 1, dims=1)
    gap = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    small = gap <= float(np.float32(gap_sq))
    fwd, bwd = [], []
    run = torch.ones_like(small)
    for l in range(1, 6):
        run = run & torch.roll(small, -l, dims=1)
        fwd.append(torch.roll(run, l, dims=1))
        bwd.append(run)
    return fwd, bwd


def select_edges(xyz: torch.Tensor, count: torch.Tensor, smooth: torch.Tensor,
                 regions: int, edges_per_region: int, threshold: float,
                 gap_sq: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy pick chain of every ring: in each of ``regions`` sectors
    of the ring's interior, up to ``edges_per_region + 1`` picks, each the
    highest smoothness (lowest column on ties) not yet picked or
    suppressed, stopping at the first below ``threshold``; a pick
    suppresses up to 5 neighbours a side.  Rings under ``regions *
    edges_per_region + 10`` points take none.  Returns the edge slots
    (R * S, 3) and their mask, slot ``ring * S + region * picks + pick``."""
    r, w = smooth.shape
    dev = smooth.device
    picks = edges_per_region + 1
    cols = torch.arange(w, device=dev)[None]
    count = count.to(torch.int64)
    total = torch.clamp(count - 10, min=0)[:, None]
    sector = total // regions
    active = (count >= regions * edges_per_region + 10)[:, None]
    fwd, bwd = _reach(xyz, gap_sq)
    thr = float(np.float32(threshold))
    neg = torch.full_like(smooth, float("-inf"))
    taken = torch.zeros((r, w), dtype=torch.bool, device=dev)
    idx = torch.zeros((r, regions * picks), dtype=torch.int64, device=dev)
    val = torch.zeros((r, regions * picks), dtype=torch.bool, device=dev)
    for k in range(regions * picks):
        j, p = divmod(k, picks)
        if p == 0:
            stop = torch.zeros((r, 1), dtype=torch.bool, device=dev)
        lo = 5 + sector * j
        hi = 5 + (total if j == regions - 1 else sector * (j + 1))
        cand = (cols >= lo) & (cols < hi) & ~taken & active & ~stop
        v = torch.where(cand, smooth, neg)
        best = v.amax(dim=1, keepdim=True)
        at = torch.where(cand & (v == best), cols,
                         torch.full_like(cols, w)).amin(dim=1, keepdim=True)
        pick = (best >= thr) & (best > float("-inf"))
        stop = stop | ~pick
        idx[:, k] = torch.where(pick, at, 0)[:, 0]
        val[:, k] = pick[:, 0]
        gone = cols == at
        for l in range(1, 6):
            gone = gone | ((cols - at == l) & fwd[l - 1]) \
                | ((at - cols == l) & bwd[l - 1])
        taken = taken | (gone & pick)
    pts = torch.gather(xyz, 1, idx.clamp(max=w - 1)[..., None].expand(
        -1, -1, 3))
    pts = torch.where(val[..., None], pts, torch.zeros_like(pts))
    return pts.reshape(-1, 3), val.reshape(-1)
