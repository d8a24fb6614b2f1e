"""ctypes bindings for the native C++ loader (runtime/native_src/loader.cc).

The port's copy of ``liodom_tpu/runtime/native.py``; ``loader.cc`` is the
JAX package's, byte for byte.  Compiled on first use with g++ into
``native_src/build/`` (git-ignored), the library named by a hash of the
source and the flags, so an edited source is rebuilt and a copied tree
whose file times changed reuses nothing stale.  Every entry point has a
NumPy fallback, so the loader works without a toolchain (it is host code:
nothing on the card depends on it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from liodom_tpu_torch.runtime import tracer

_SRC = os.path.join(os.path.dirname(__file__), "native_src", "loader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "native_src", "build")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """The built loader for this source and these flags."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update("\0".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libliodom_loader-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)   # atomic: a reader never sees a partial .so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.liodom_read_bin.restype = ctypes.c_long
            lib.liodom_read_bin.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long]
            lib.liodom_prefetch_create.restype = ctypes.c_void_p
            lib.liodom_prefetch_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.liodom_prefetch_next.restype = ctypes.c_long
            lib.liodom_prefetch_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.liodom_prefetch_destroy.restype = None
            lib.liodom_prefetch_destroy.argtypes = [ctypes.c_void_p]
            lib.liodom_split_velodyne.restype = ctypes.c_long
            lib.liodom_split_velodyne.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
            lib.liodom_prefetch_create_split.restype = ctypes.c_void_p
            lib.liodom_prefetch_create_split.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float]
            lib.liodom_prefetch_next_split.restype = ctypes.c_long
            lib.liodom_prefetch_next_split.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None       # no toolchain: the NumPy fallbacks serve
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_bin(path: str, cap_points: int = 300000) -> np.ndarray:
    """(N, 4) float32 records from a KITTI velodyne .bin."""
    lib = _load()
    if lib is None:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    buf = np.empty((cap_points * 4,), np.float32)
    n = lib.liodom_read_bin(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size)
    if n < 0:
        raise FileNotFoundError(path)
    return buf[:n].reshape(-1, 4)


def split_velodyne_np(pts: np.ndarray, scan_lines: int, ring_width: int,
                      min_range: float, max_range: float
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """NumPy mirror of the native ring split (loader.cc split_velodyne; the
    reference's splitPointCloud, feature_extractor.cc:104-179).  All float32
    math, matching the C++ and the on-device f32 paths.

    pts: (N, >=3) float32.  Returns ((rings, width, 3) image, (rings,)
    counts, n_dropped) — ``n_dropped`` counts routed points lost to the
    ``ring_width`` clamp (the reference's vectors are unbounded, so any
    non-zero value is a lossy deviation the caller must report)."""
    pts = np.asarray(pts, np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    d = np.sqrt((x * x + y * y).astype(np.float32), dtype=np.float32)
    ok = finite & (d >= np.float32(min_range)) & (d <= np.float32(max_range))
    angle = (np.arctan(z / np.maximum(d, np.float32(1e-9)))
             * np.float32(180.0 / np.pi)).astype(np.float32)
    if scan_lines == 64:
        upper = angle >= np.float32(-8.83)
        rid = np.where(
            upper,
            ((np.float32(2.0) - angle) * np.float32(3.0)
             + np.float32(0.5)).astype(np.int32),
            32 + ((np.float32(-8.83) - angle) * np.float32(2.0)
                  + np.float32(0.5)).astype(np.int32))
        ok &= ((angle <= np.float32(2.0)) & (angle >= np.float32(-24.33))
               & (rid >= 0) & (rid <= 63))
    elif scan_lines == 32:
        rid = ((angle + np.float32(92.0 / 3.0))
               * np.float32(3.0 / 4.0)).astype(np.int32)
        ok &= (rid >= 0) & (rid <= 31)
    elif scan_lines == 16:
        rid = ((angle + np.float32(15.0)) / np.float32(2.0)
               + np.float32(0.5)).astype(np.int32)
        ok &= (rid >= 0) & (rid <= 15)
    else:
        raise ValueError(f"unsupported scan_lines: {scan_lines}")
    img = np.zeros((scan_lines, ring_width, 3), np.float32)
    counts = np.zeros((scan_lines,), np.int32)
    rid = np.where(ok, rid, scan_lines)
    order = np.flatnonzero(ok)  # ascending -> input order preserved per ring
    dropped = 0
    for r in range(scan_lines):
        members = order[rid[order] == r]
        m = min(len(members), ring_width)
        img[r, :m] = pts[members[:m], :3]
        counts[r] = m
        dropped += len(members) - m
    return img, counts, dropped


def split_ouster_np(organized: np.ndarray, ring_width: int,
                    min_range: float, max_range: float
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side Ouster-mode split (the reference's ``lidar_type=1`` branch,
    feature_extractor.cc:158-175): the cloud is row-organised, the row index
    IS the ring; invalid points (non-finite or outside the XY range gate)
    are dropped and rows are left-compacted preserving column order —
    exactly ops/features.split_scan_ouster, evaluated in numpy float32 so
    the loader does the sensor-side work (like :func:`split_velodyne_np`
    for Velodyne mode).

    organized: (rings, width0, 3) float32 with NaN rows for missing
    returns.  Returns ((rings, ring_width, 3) image, counts, n_dropped)."""
    organized = np.asarray(organized, np.float32)
    h, w0, _ = organized.shape
    x, y, z = organized[..., 0], organized[..., 1], organized[..., 2]
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    d = np.sqrt((x * x + y * y).astype(np.float32), dtype=np.float32)
    ok = finite & (d >= np.float32(min_range)) & (d <= np.float32(max_range))
    img = np.zeros((h, ring_width, 3), np.float32)
    counts = np.zeros((h,), np.int32)
    dropped = 0
    for r in range(h):
        members = np.flatnonzero(ok[r])      # ascending -> order preserved
        m = min(len(members), ring_width)
        img[r, :m] = organized[r, members[:m], :3]
        counts[r] = m
        dropped += len(members) - m
    return img, counts, dropped


def split_velodyne(pts: np.ndarray, scan_lines: int, ring_width: int,
                   min_range: float, max_range: float
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Ring-split one scan on the host: native C++ when available, numpy
    fallback otherwise.  pts: (N, 3 or 4) float32.

    Returns (image, counts, n_dropped) — see :func:`split_velodyne_np` for
    the drop accounting (the native return value is the ROUTED total, so
    drops = routed - sum(counts) with no ABI change)."""
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        return split_velodyne_np(pts, scan_lines, ring_width, min_range,
                                 max_range)
    img = np.empty((scan_lines, ring_width, 3), np.float32)
    counts = np.empty((scan_lines,), np.int32)
    n = lib.liodom_split_velodyne(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        pts.shape[1], scan_lines, min_range, max_range, ring_width,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if n < 0:
        raise ValueError(f"unsupported scan_lines: {scan_lines}")
    return img, counts, int(n - counts.sum())


class SplitPrefetcher:
    """Multithreaded loader that reads KITTI .bin scans AND ring-splits them
    in native worker threads, emitting device-ready (rings, width, 3) images.

    This is the production ingest path: the reference spends a whole pipeline
    thread on splitting (feature_extractor.cc:42-82); here it overlaps with
    the card's compute for free."""

    def __init__(self, paths: List[str], scan_lines: int, ring_width: int,
                 min_range: float, max_range: float,
                 cap_points: int = 300000, depth: int = 4,
                 n_threads: int = 2):
        self.paths = list(paths)
        self.shape = (scan_lines, ring_width, 3)
        self._args = (scan_lines, ring_width, min_range, max_range)
        self._cap = cap_points
        lib = _load()
        self._lib = lib
        self._i = 0
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._keepalive = arr
            self._h = lib.liodom_prefetch_create_split(
                arr, len(self.paths), cap_points, depth, n_threads,
                scan_lines, ring_width,
                ctypes.c_float(min_range), ctypes.c_float(max_range))
        else:
            self._h = None

    def next(self) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """((rings, width, 3) image, (rings,) counts, n_dropped) or None at
        end.  ``n_dropped`` = routed points lost to the ring_width clamp.
        Spans ``loader.next``."""
        with tracer.span("loader.next"):
            return self._next()

    def _next(self) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        if self._h is not None:
            img = np.empty(self.shape, np.float32)
            counts = np.empty((self.shape[0],), np.int32)
            n = self._lib.liodom_prefetch_next_split(
                self._h, img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            if n < 0:
                return None
            return img, counts, int(n - counts.sum())
        if self._i >= len(self.paths):
            return None
        rec = np.fromfile(self.paths[self._i], dtype=np.float32)
        self._i += 1
        rec = rec.reshape(-1, 4)[:self._cap]
        return split_velodyne_np(rec, *self._args)

    def close(self) -> None:
        if self._h is not None:
            self._lib.liodom_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Prefetcher:
    """Bounded multithreaded scan prefetcher over a file list.

    Native equivalent of the reference's ingest thread + SharedData FIFO
    (shared_data.cc:37-62) — but bounded (backpressure) and zero-GIL."""

    def __init__(self, paths: List[str], cap_points: int,
                 depth: int = 4, n_threads: int = 2):
        self.paths = list(paths)
        self.cap_points = cap_points
        lib = _load()
        self._lib = lib
        self._i = 0
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._keepalive = arr
            self._h = lib.liodom_prefetch_create(
                arr, len(self.paths), cap_points, depth, n_threads)
        else:
            self._h = None

    def next(self) -> Optional[Tuple[np.ndarray, int]]:
        """((cap_points, 3) float32 xyz, n_points) or None at end."""
        if self._h is not None:
            out = np.empty((self.cap_points, 3), np.float32)
            n = self._lib.liodom_prefetch_next(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if n < 0:
                return None
            return out, int(n)
        # fallback: synchronous numpy read
        if self._i >= len(self.paths):
            return None
        rec = np.fromfile(self.paths[self._i], dtype=np.float32)
        self._i += 1
        rec = rec.reshape(-1, 4)[:self.cap_points]
        out = np.zeros((self.cap_points, 3), np.float32)
        out[:len(rec)] = rec[:, :3]
        return out, len(rec)

    def close(self) -> None:
        if self._h is not None:
            self._lib.liodom_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_padded(paths: List[str], capacity: int, prefetch: int = 2
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (xyz (capacity, 3), valid (capacity,)) per scan file."""
    pf = Prefetcher(paths, capacity, depth=max(prefetch, 1))
    try:
        while True:
            item = pf.next()
            if item is None:
                return
            xyz, n = item
            n = min(n, capacity)
            valid = np.zeros((capacity,), bool)
            valid[:n] = True
            xyz[n:] = 0.0
            yield xyz, valid
    finally:
        pf.close()
