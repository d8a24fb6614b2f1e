"""Configuration dataclasses (the port's copy of ``liodom_tpu.core.config``).

Mirrors the reference parameter surface (names, defaults, semantics):
* odometry params — reference src/params.cc:37-110
* mapping params  — reference src/liodom_mapping_node.cc:115-134

plus the static-shape capacities the fixed-shape engine needs (the
reference's dynamic ``PointCloud::Ptr`` world becomes padded fixed-shape
tensors).  Defaults are identical to the JAX package so that both engines
run the same configuration.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LiodomConfig:
    """Odometry configuration (reference: params.cc:37-110).

    Defaults replicate ``Params::readParams``.
    """

    # --- sensor / gating (params.cc:40-53) ---
    min_range: float = 3.0          # metres, XY range gate lower bound
    max_range: float = 75.0         # metres, XY range gate upper bound
    lidar_type: int = 0             # 0 = Velodyne (ring from elevation), 1 = Ouster (row-organised)
    scan_lines: int = 64            # number of rings (16/32/64 supported in Velodyne mode)

    # --- feature extraction (params.cc:56-63) ---
    scan_regions: int = 8           # azimuthal sectors per ring
    edges_per_region: int = 10      # edge budget per sector (greedy loop admits budget+1)
    smoothness_threshold: float = 0.1   # pick gate (feature_extractor.cc:270)
    neighbor_gap_sq: float = 0.05       # suppression early-stop gap^2 (feature_extractor.cc:289)

    # --- odometry (params.cc:90-108, laser_odometry.cc) ---
    local_map_size: int = 5         # sliding window frames ("prev_frames"; launch files use 15)
    use_imu: bool = False
    filter_local_map: bool = False  # 0.4 m voxel filter of the window (laser_odometry.cc:286-295)
    mapping: bool = False           # merge received map cells into matching map (laser_odometry.cc:310-314)
    publish_tf: bool = True
    save_results: bool = False
    results_dir: str = "~/"
    fixed_frame: str = "odom"
    base_frame: str = "base_link"
    laser_frame: str = ""

    # --- solver budget (laser_odometry.cc:198-218) ---
    outer_iters: int = 2            # re-association iterations
    inner_iters: int = 4            # LM iterations per association
    huber_delta: float = 0.2        # HuberLoss(0.2) (laser_odometry.cc:201)
    knn_k: int = 5                  # nearest neighbours per edge (laser_odometry.cc:323)
    knn_max_sq_dist: float = 1.0    # accept gate on 5th NN (laser_odometry.cc:324)
    eig_ratio: float = 3.0          # line test: lambda_max > 3 * lambda_mid (laser_odometry.cc:344)
    # Minimum separation of the two line endpoints.  No reference
    # equivalent: a matching map holding duplicate points gives 2-NN
    # "lines" with lpa == lpb, whose residual divides ~0 by ~0; those rows
    # are gated out instead of poisoning the normal equations.
    min_line_sep: float = 0.01      # metres
    local_map_voxel: float = 0.4    # leaf for the optional window filter (laser_odometry.cc:290)

    # --- static-shape capacities (no reference equivalent) ---
    max_points: int = 131072        # padded raw scan capacity (KITTI HDL-64 ~ 120k pts)
    # Padded points per ring after routing.  4096 is lossless for HDL-64
    # scans: the Velodyne elevation formulas merge adjacent laser rows, so
    # a ring holds up to ~2x the azimuth width.  Pick a smaller width only
    # with the drop counter (ops.features.split_overflow) watched.
    ring_width: int = 4096
    # Derived edge capacity = scan_lines * scan_regions * (edges_per_region + 1).
    dtype: str = "float32"

    @property
    def min_points_per_scan(self) -> int:
        """Ring participation gate (params.cc:63)."""
        return self.scan_regions * self.edges_per_region + 10

    @property
    def max_edges_per_region(self) -> int:
        """The reference greedy loop breaks on ``picked > edges_per_region``,
        so it admits edges_per_region + 1 picks (feature_extractor.cc:270)."""
        return self.edges_per_region + 1

    @property
    def max_edges(self) -> int:
        return self.scan_lines * self.scan_regions * self.max_edges_per_region

    @property
    def local_map_capacity(self) -> int:
        return self.local_map_size * self.max_edges

    def replace(self, **kw) -> "LiodomConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Global hash-grid map configuration (liodom_mapping_node.cc:115-134,
    map.cc:70-81).  Not used by the odometry slice; kept so that the
    mapping slice starts from the same defaults."""

    voxel_xysize: float = 40.0      # XY cell size, metres
    voxel_zsize: float = 50.0       # Z cell size, metres
    resolution: float = 0.4         # per-cell re-voxelisation leaf
    cells_xy: int = 2               # local-map neighbourhood radius in cells (XY)
    cells_z: int = 1                # local-map vertical column half-extent
    fixed_frame: str = "world"
    base_frame: str = "base_link"

    # --- capacities ---
    map_capacity: int = 524288       # map table rows
    local_map_capacity: int = 65536  # padded rows returned by get_local_map

    def replace(self, **kw) -> "MapConfig":
        return dataclasses.replace(self, **kw)
