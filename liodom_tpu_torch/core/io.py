"""Dataset IO: KITTI odometry sequences and Ouster-style organized clouds.

The reference consumes sensor data as ROS messages from replayed rosbags
(liodom_node.cc:40-55; launch/liodom.launch feeds
``/kitti/velo/pointcloud``).  Outside ROS the canonical on-disk form of the
same data is the KITTI odometry layout::

    sequences/<seq>/velodyne/000000.bin   float32 x,y,z,intensity records
    sequences/<seq>/calib.txt             P0..P3, Tr (cam0 <- velo)
    sequences/<seq>/times.txt             per-scan timestamps [s]
    poses/<seq>.txt                       GT cam0 poses, 3x4 row-major

This module (the port's copy of ``liodom_tpu/core/io.py``) reads that
layout into the engine's fixed-shape host arrays.  Reading uses the native
C++ loader (liodom_tpu_torch.runtime.native) when available — multithreaded
preads into preallocated buffers — with a NumPy fallback.  The arrays stay
numpy: the apps stage them onto the card themselves
(runtime/device_io.py).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from liodom_tpu_torch.core.organize import organized_from_unorganized

__all__ = ["read_velodyne_bin", "load_calib", "load_poses", "velo_to_cam0",
           "poses_cam_to_velo", "KittiSequence",
           "organized_from_unorganized"]


def read_velodyne_bin(path: str, max_points: Optional[int] = None
                      ) -> np.ndarray:
    """Read one KITTI velodyne ``.bin`` -> (N, 4) float32 [x y z intensity]."""
    from liodom_tpu_torch.runtime import native
    arr = native.read_bin(path)
    if max_points is not None and len(arr) > max_points:
        arr = arr[:max_points]
    return arr


def load_calib(path: str) -> dict:
    """Parse a KITTI calib.txt into {name: (3, 4) float64}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            v = np.fromstring(vals, sep=" ")
            if v.size == 12:
                out[name.strip()] = v.reshape(3, 4)
    return out


def load_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses file -> (F, 4, 4) float64 (cam0 frame)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


def velo_to_cam0(calib: dict) -> np.ndarray:
    """(4, 4) transform cam0 <- velodyne from calib 'Tr'."""
    T = np.eye(4)
    T[:3, :4] = calib["Tr"]
    return T


def poses_cam_to_velo(poses_cam: np.ndarray, calib: dict) -> np.ndarray:
    """Re-express cam0-frame GT poses in the velodyne frame: the trajectory
    the odometry engine (which works in the laser frame) should produce.
    ``T_w_velo[k] = Tr^-1 @ T_w_cam[k] @ Tr``."""
    Tr = velo_to_cam0(calib)
    Tri = np.linalg.inv(Tr)
    return np.einsum("ij,fjk,kl->fil", Tri, poses_cam, Tr)


class KittiSequence:
    """One KITTI odometry sequence on disk."""

    def __init__(self, root: str, seq: str):
        self.root = root
        self.seq = seq
        self.velo_dir = os.path.join(root, "sequences", seq, "velodyne")
        if not os.path.isdir(self.velo_dir):
            raise FileNotFoundError(self.velo_dir)
        self.files = sorted(
            os.path.join(self.velo_dir, f)
            for f in os.listdir(self.velo_dir) if f.endswith(".bin"))
        calib_path = os.path.join(root, "sequences", seq, "calib.txt")
        self.calib = load_calib(calib_path) if os.path.exists(calib_path) \
            else None
        times_path = os.path.join(root, "sequences", seq, "times.txt")
        self.times = (np.loadtxt(times_path)
                      if os.path.exists(times_path) else None)
        poses_path = os.path.join(root, "poses", seq + ".txt")
        self.gt_cam = load_poses(poses_path) \
            if os.path.exists(poses_path) else None

    def __len__(self) -> int:
        return len(self.files)

    def gt_velo(self) -> Optional[np.ndarray]:
        if self.gt_cam is None or self.calib is None:
            return None
        return poses_cam_to_velo(self.gt_cam, self.calib)

    def scan(self, i: int, max_points: Optional[int] = None) -> np.ndarray:
        """(N, 3) xyz of scan i."""
        return read_velodyne_bin(self.files[i], max_points)[:, :3]

    def iter_padded(self, capacity: int, prefetch: int = 2
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (xyz (capacity, 3) float32, valid (capacity,) bool) with the
        native prefetcher keeping ``prefetch`` scans in flight."""
        from liodom_tpu_torch.runtime import native
        yield from native.iter_padded(self.files, capacity, prefetch)

    def iter_images(self, scan_lines: int, ring_width: int, min_range: float,
                    max_range: float, prefetch: int = 4, n_threads: int = 2
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (ring image (rings, width, 3) f32, (rings,) i32 counts,
        n_dropped), ring-split in native loader threads (loader.cc
        split_velodyne) so the device program starts at the smoothness
        kernel.  ``n_dropped`` counts points lost to the ring_width clamp —
        the caller must surface any non-zero total (the reference never
        drops; its ring vectors are unbounded)."""
        from liodom_tpu_torch.runtime import native
        pf = native.SplitPrefetcher(self.files, scan_lines, ring_width,
                                    min_range, max_range, depth=prefetch,
                                    n_threads=n_threads)
        try:
            while True:
                item = pf.next()
                if item is None:
                    return
                yield item
        finally:
            pf.close()
