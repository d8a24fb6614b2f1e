"""The odometry engine: the per-frame step on torch tensors.

Port of ``liodom_tpu/odometry/pipeline.py``: ``image_step``, its batched
form ``batch_image_step``, the chunked ``chained_image_step`` and
``full_step``, which starts from the raw scan (the ring split on the
device).
Re-design of ``LaserOdometer::operator()`` (laser_odometry.cc:100-272):
local-map assembly, constant-velocity prediction, optional IMU roll/pitch
override, 2x (re-associate -> LM solve), window update, over fixed-shape
tensors.  On CUDA the step runs the hand-written kernels (smoothness, edge
selection, kNN: K3, or K4 when batched, or K6 under ``pallas_lines``) and is
enqueued without any host synchronisation; on the CPU it runs their plain
versions.  Every stage takes a leading batch dimension, so the batched step
is the solo step on (B, ...) tensors: JAX's ``vmap``.

First-frame behaviour falls out of the shapes: an empty window gives no
correspondences, the solver holds the (identity) prediction, and the
frame's edges seed the window — the reference's init branch
(laser_odometry.cc:108-137).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import EdgeCloud, RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.odometry import local_map
from liodom_tpu_torch.ops.features import (extract_features, select_edges,
                                           smoothness, split_scan_ouster)
from liodom_tpu_torch.ops.knn_pallas import spatial_sort_points
from liodom_tpu_torch.ops.neighbors import line_correspondences
from liodom_tpu_torch.ops.solver import lm_solve
from liodom_tpu_torch.ops.voxel import voxel_downsample
from liodom_tpu_torch.runtime.tracer import span


class OdomState(NamedTuple):
    window: local_map.WindowState
    odom: Pose        # latest pose (laser frame, like the reference's odom_)
    prev_odom: Pose   # previous frame's pose
    # latest local map received from the mapping service
    # (liodom_node.cc:57-64); zero-size unless cfg.mapping
    received_xyz: torch.Tensor    # (Mr, 3)
    received_valid: torch.Tensor  # (Mr,)
    imu_ori: torch.Tensor         # (4,) latest IMU orientation, wxyz


def init_state(cfg: LiodomConfig, received_capacity: int = 0,
               device=None) -> OdomState:
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    mr = received_capacity if cfg.mapping else 0
    return OdomState(
        local_map.WindowState.create(cfg.local_map_size, cfg.max_edges,
                                     dtype, dev),
        Pose.identity(dtype, device=dev),
        Pose.identity(dtype, device=dev),
        torch.zeros((mr, 3), dtype=dtype, device=dev),
        torch.zeros((mr,), dtype=torch.bool, device=dev),
        Pose.identity(dtype, device=dev).q,
    )


def set_imu(state: OdomState, quat_wxyz) -> OdomState:
    """Record the latest IMU orientation (SharedData::setLastIMUOri,
    shared_data.cc:107-112; consumed when cfg.use_imu)."""
    return state._replace(imu_ori=torch.as_tensor(
        quat_wxyz, dtype=state.imu_ori.dtype, device=state.imu_ori.device))


def set_received_map(state: OdomState, xyz, valid) -> OdomState:
    """Record the latest local map received from the mapping service
    (SharedData::setLocalMap, shared_data.cc:91-105; merged into the
    matching map when cfg.mapping)."""
    dev = state.odom.t.device
    return state._replace(
        received_xyz=torch.as_tensor(xyz, dtype=state.odom.t.dtype,
                                     device=dev),
        received_valid=torch.as_tensor(valid, dtype=torch.bool, device=dev))


def _matching_map(state: OdomState, cfg: LiodomConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """computeLocalMap + map merge (laser_odometry.cc:274-298, 310-314): the
    window cloud (with ``filter_local_map``, 0.4 m voxel-filtered once the
    window is full) plus, when mapping, the received map cells.

    JAX chooses the filtered cloud with ``lax.cond`` on the window's frame
    count; here the count stays on the device, so the filter runs every
    frame and ``torch.where`` picks its result when the window is full (no
    host synchronisation)."""
    gen_xyz, gen_valid = local_map.flatten(state.window)
    if cfg.filter_local_map and not cfg.mapping:
        full = state.window.nframes == cfg.local_map_size
        f_xyz, f_valid = voxel_downsample(gen_xyz, gen_valid,
                                          cfg.local_map_voxel)
        gen_xyz = torch.where(full[..., None, None], f_xyz, gen_xyz)
        gen_valid = torch.where(full[..., None], f_valid, gen_valid)
    if cfg.mapping and state.received_xyz.shape[-2] > 0:
        gen_xyz = torch.cat([gen_xyz, state.received_xyz], dim=-2)
        gen_valid = torch.cat([gen_valid, state.received_valid], dim=-1)
    return gen_xyz, gen_valid


def _imu_override(pose: Pose, imu_ori: torch.Tensor,
                  t_laser_base: Pose) -> Pose:
    """Overwrite predicted roll/pitch with the IMU's, keeping yaw
    (laser_odometry.cc:152-183).  ``t_laser_base`` is the laser->base
    transform (getBaseToLaserTf)."""
    imu_rpy = se3.rpy_from_quat(imu_ori)
    odom_bl = se3.compose(pose, t_laser_base)
    rpy = se3.rpy_from_quat(odom_bl.q)
    q_new = se3.quat_from_rpy(torch.stack(
        [imu_rpy[..., 0], imu_rpy[..., 1], rpy[..., 2]], dim=-1))
    return se3.compose(Pose(q_new, odom_bl.t), se3.inverse(t_laser_base))


def odometry_step(state: OdomState, edges: EdgeCloud, cfg: LiodomConfig,
                  t_laser_base: Optional[Pose] = None
                  ) -> Tuple[OdomState, Pose]:
    """Process one feature frame; returns (new_state, pose).  The
    steady-state branch of LaserOdometer::operator() (laser_odometry.cc:
    138-267) with the solve loop of :196-228.  No host synchronisation: the
    accept/reject, window pointer and masks all stay tensors.  A batched
    state and edges (B, E, ...) step B independent sequences."""
    # front-compact the edges so the kNN kernel can skip all-padding query
    # tiles
    with span("features", device=True):
        exyz, evalid = local_map.compact(edges.xyz, edges.valid)

    with span("knn", device=True):
        map_xyz, map_valid = _matching_map(state, cfg)
        map_presorted = False
        if map_xyz.is_cuda:
            # spatially order the matching map once a frame: both solver
            # iterations query the same map, so the kNN wrapper skips its
            # own ref sort.  The global sort merges the frames' co-located
            # points into shared tiles, which is what makes the tile
            # pruning work.
            map_xyz, map_valid = spatial_sort_points(map_xyz, map_valid)
            map_presorted = True

    # constant-velocity prediction (laser_odometry.cc:148-150)
    pred = se3.compose(state.odom,
                       se3.compose(se3.inverse(state.prev_odom), state.odom))
    pose = pred
    if cfg.use_imu:
        tlb = t_laser_base if t_laser_base is not None else Pose.identity(
            state.odom.t.dtype, device=state.odom.t.device)
        pose = _imu_override(pose, state.imu_ori, tlb)

    # 2x outer re-association, each: transform -> kNN/line fit -> 4-iter LM
    for _ in range(cfg.outer_iters):
        with span("knn", device=True):
            edges_world = se3.transform(pose, exyz)
            corr = line_correspondences(
                edges_world, evalid, map_xyz, map_valid, k=cfg.knn_k,
                max_sq_dist=cfg.knn_max_sq_dist, eig_ratio=cfg.eig_ratio,
                min_line_sep=cfg.min_line_sep, map_presorted=map_presorted)
        with span("lm_solve", device=True):
            pose = lm_solve(pose, exyz, corr.lpa, corr.lpb, corr.valid,
                            min_range=cfg.min_range, max_range=cfg.max_range,
                            huber_delta=cfg.huber_delta,
                            iters=cfg.inner_iters)

    # add the frame's edges (at the final pose) to the window
    # (laser_odometry.cc:231-235)
    with span("window.push", device=True):
        edges_final = se3.transform(pose, exyz)
        window = local_map.push(
            state.window,
            torch.where(evalid[..., None], edges_final,
                        torch.zeros_like(exyz)),
            evalid)
    new_state = OdomState(window, pose, state.odom, state.received_xyz,
                          state.received_valid, state.imu_ori)
    return new_state, pose


def image_step(state: OdomState, img_xyz: torch.Tensor,
               img_count: torch.Tensor, cfg: LiodomConfig,
               t_laser_base: Optional[Pose] = None
               ) -> Tuple[OdomState, Pose, torch.Tensor]:
    """Ring image in, pose out — the production hot path.  Ring routing is
    the loader's job (ops.features.split_scan), so the step starts at the
    smoothness kernel.  Returns (state, pose, n_edges as a 0-d tensor).
    The image must lie on the state's device."""
    dev = state.odom.t.device
    if img_xyz.device != dev or img_count.device != dev:
        raise ValueError(f"image on {img_xyz.device}, state on {dev}")
    with span("step", device=True):
        img = RingImage(img_xyz, img_count)
        with span("features", device=True):
            edges = select_edges(img, smoothness(img, cfg), cfg)
        new_state, pose = odometry_step(state, edges, cfg, t_laser_base)
        return new_state, pose, edges.num_valid()


def full_step(state: OdomState, raw_xyz: torch.Tensor,
              raw_valid: torch.Tensor, cfg: LiodomConfig,
              t_laser_base: Optional[Pose] = None
              ) -> Tuple[OdomState, Pose, torch.Tensor]:
    """Scan in, pose out (``pipeline.py:179``): the ring split, K1, K2 and
    :func:`odometry_step` in one call, without a host synchronisation on
    CUDA.  ``cfg.lidar_type`` 0 takes a padded raw scan ``raw_xyz`` (N, 3)
    with its mask ``raw_valid`` (N,) (``RawScan.from_points``) and splits it
    by elevation; 1 takes a row-organised cloud ``raw_xyz`` (H, W0, 3)
    whose row is the ring (``raw_valid`` unused, as in JAX).  Returns
    (state, pose, n_edges as a 0-d tensor); the same as :func:`image_step`
    on the image :func:`~liodom_tpu_torch.ops.features.split_scan` makes."""
    dev = state.odom.t.device
    if raw_xyz.device != dev or raw_valid.device != dev:
        raise ValueError(f"scan on {raw_xyz.device}, state on {dev}")
    if cfg.lidar_type == 0:
        edges = extract_features(RawScan(raw_xyz, raw_valid), cfg)
    else:
        img = split_scan_ouster(raw_xyz, cfg)
        edges = select_edges(img, smoothness(img, cfg), cfg)
    new_state, pose = odometry_step(state, edges, cfg, t_laser_base)
    return new_state, pose, edges.num_valid()


def chained_image_step(state: OdomState, imgs_xyz: torch.Tensor,
                       imgs_count: torch.Tensor, cfg: LiodomConfig,
                       t_laser_base: Optional[Pose] = None,
                       imu_quats: Optional[torch.Tensor] = None
                       ) -> Tuple[OdomState, Pose, torch.Tensor]:
    """K frames per call (``pipeline.py:202-244``): :func:`image_step` on
    each of ``imgs_xyz`` (K, R, W, 3), ``imgs_count`` (K, R) in order, the
    offline-replay form.  JAX scans the frames on the device; here the loop
    is on the host and enqueues every frame without a synchronisation, so
    the poses equal the per-frame loop's.  With ``cfg.use_imu`` pass
    ``imu_quats`` (K, 4): each frame sees its own orientation (the per-frame
    loop's ``set_imu`` before each step).  Returns (state, poses (K, ...),
    n_edges (K,))."""
    if cfg.use_imu and imu_quats is None:
        raise ValueError("cfg.use_imu requires per-frame imu_quats (K, 4) "
                         "in the chained step")
    qs, ts, nes = [], [], []
    for i in range(imgs_xyz.shape[0]):
        if imu_quats is not None:
            state = set_imu(state, imu_quats[i])
        state, pose, ne = image_step(state, imgs_xyz[i], imgs_count[i], cfg,
                                     t_laser_base)
        qs.append(pose.q)
        ts.append(pose.t)
        nes.append(ne)
    return state, Pose(torch.stack(qs), torch.stack(ts)), torch.stack(nes)


def batch_image_step(states: OdomState, imgs_xyz: torch.Tensor,
                     imgs_count: torch.Tensor, cfg: LiodomConfig
                     ) -> Tuple[OdomState, Pose, torch.Tensor]:
    """:func:`image_step` over B independent sequences at once
    (``pipeline.py:248-269``, multi-sequence replay): ``states`` with a
    leading batch dimension (``parallel.sharded.init_batch_state``),
    ``imgs_xyz`` (B, R, W, 3), ``imgs_count`` (B, R).  K1 and K2 run once on
    the B*R folded rings, the kNN is K4 (one launch over the batch, each
    element with its own sort and pruning; K6 under ``pallas_lines``) and
    the solver solves the B poses together.  Returns (states, poses (B,
    ...), n_edges (B,))."""
    b = states.odom.t.shape[:-1]
    if (len(b) != 1 or imgs_xyz.ndim != 4 or imgs_xyz.shape[:1] != b
            or imgs_count.shape != imgs_xyz.shape[:2]):
        raise ValueError(f"batch_image_step: states of batch {tuple(b)}, "
                         f"images {tuple(imgs_xyz.shape)}, counts "
                         f"{tuple(imgs_count.shape)}")
    return image_step(states, imgs_xyz, imgs_count, cfg)
