"""Visualization export — the rviz-config equivalent (the port's copy of
``liodom_tpu/runtime/viz.py``; host numpy, the text of every file the JAX
package's).

The reference ships rviz dashboards displaying the raw cloud, extracted
edges, odometry path, global map and local map (rviz/liodom.rviz:87-282).
Without ROS, the portable equivalent is writing those same artifacts as PLY
(any viewer: CloudCompare, MeshLab, Open3D) — one call per artifact.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def save_ply(path: str, xyz: np.ndarray, valid: Optional[np.ndarray] = None,
             color: Optional[Sequence[int]] = None) -> int:
    """Write points (optionally masked, optionally single uint8 RGB colour)
    as binary-less ASCII PLY; returns the point count."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    if valid is not None:
        xyz = xyz[np.asarray(valid, bool).reshape(-1)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if color is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if color is None:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            r, g, b = color
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
    return len(xyz)


def save_trajectory_ply(path: str, poses: np.ndarray) -> int:
    """Write a trajectory ((F, 4, 4) or (F, 3, 4) poses) as a PLY polyline
    (vertices + edges) — the rviz Path display equivalent."""
    poses = np.asarray(poses)
    pts = poses[:, :3, 3]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {max(len(pts) - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for i in range(len(pts) - 1):
            f.write(f"{i} {i + 1}\n")
    return len(pts)


def export_frame_debug(directory: str, frame: int,
                       raw_xyz: Optional[np.ndarray] = None,
                       raw_valid: Optional[np.ndarray] = None,
                       edges_xyz: Optional[np.ndarray] = None,
                       edges_valid: Optional[np.ndarray] = None,
                       map_xyz: Optional[np.ndarray] = None,
                       map_valid: Optional[np.ndarray] = None) -> None:
    """Dump the rviz display set for one frame: raw cloud (white), edges
    (red), matching map (green)."""
    d = os.path.join(directory, f"frame_{frame:06d}")
    os.makedirs(d, exist_ok=True)
    if raw_xyz is not None:
        save_ply(os.path.join(d, "cloud.ply"), raw_xyz, raw_valid,
                 (200, 200, 200))
    if edges_xyz is not None:
        save_ply(os.path.join(d, "edges.ply"), edges_xyz, edges_valid,
                 (230, 40, 40))
    if map_xyz is not None:
        save_ply(os.path.join(d, "map_local.ply"), map_xyz, map_valid,
                 (40, 200, 40))
