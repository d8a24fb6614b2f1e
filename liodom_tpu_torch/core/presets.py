"""Deployment presets, the roslaunch-file equivalents (the port's copy of
``liodom_tpu/core/presets.py``).

The reference ships three launch configurations (SURVEY.md §2 "Launch
configs"); each preset reproduces the parameter values those XML files set,
on top of the `Params::readParams` defaults that `LiodomConfig`/`MapConfig`
already mirror.
"""

from __future__ import annotations

from typing import Tuple

from liodom_tpu_torch.core.config import LiodomConfig, MapConfig


def kitti_preset(mapping: bool = False) -> Tuple[LiodomConfig, MapConfig]:
    """launch/liodom.launch: KITTI Velodyne HDL-64 at 10 Hz.

    Params (:17-34): lidar_type 0, scan_lines 64, scan_regions 8,
    edges_per_region 10, prev_frames 15, save_results available; the optional
    mapper group (:39-57) uses 30/35 m voxels, cells 3/2, resolution 0.4."""
    cfg = LiodomConfig(
        lidar_type=0, scan_lines=64, scan_regions=8, edges_per_region=10,
        local_map_size=15, mapping=mapping, publish_tf=True,
        fixed_frame="odom", base_frame="base_link", laser_frame="velodyne")
    mcfg = MapConfig(voxel_xysize=30.0, voxel_zsize=35.0, resolution=0.4,
                     cells_xy=3, cells_z=2)
    return cfg, mcfg


def ouster_preset(scan_lines: int = 64, mapping: bool = False
                  ) -> Tuple[LiodomConfig, MapConfig]:
    """launch/liodom_ouster.launch (:19-33): lidar_type 1 (row-organized
    clouds, the row IS the ring), empty laser_frame (taken from the message
    header, laser_odometry.cc:111-113), prev_frames 15."""
    cfg = LiodomConfig(
        lidar_type=1, scan_lines=scan_lines, scan_regions=8,
        edges_per_region=10, local_map_size=15, mapping=mapping,
        publish_tf=True, fixed_frame="odom", base_frame="base_link",
        laser_frame="")
    mcfg = MapConfig(voxel_xysize=30.0, voxel_zsize=35.0, resolution=0.4,
                     cells_xy=3, cells_z=2)
    return cfg, mcfg


def mapping_preset() -> MapConfig:
    """launch/liodom_mapping.launch: standalone mapper, 20/25 m voxels."""
    return MapConfig(voxel_xysize=20.0, voxel_zsize=25.0, resolution=0.4,
                     cells_xy=2, cells_z=1)
