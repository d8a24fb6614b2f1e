"""Mapping service and the odometry <-> mapping feedback loop (port of
``liodom_tpu/mapping/service.py``).

The reference runs mapping as a second process (liodom_mapping_node.cc) fed
over ROS topics: the odometer publishes edges and a pose, the mapper inserts
them into the hash-grid map and publishes back a local map, which the
odometer merges into its matching map when ``mapping:=true``
(laser_odometry.cc:310-314), "adaptive local mapping".  Two deployments:

* :func:`combined_step` (from a raw scan: the ring split, K1 and K2 on the
  device) and :func:`combined_image_step` (from a loader-split ring image):
  odometry, map update and local-map extraction in one step on the card,
  enqueued without a host synchronisation; the extracted local map feeds
  the next frame's matching map (the reference's one-message latency).
* :class:`MappingService`: a host-side service object with the two-process
  architecture's latched re-publish semantics.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import EdgeCloud, RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping.grid import (MapState, get_local_map, get_map,
                                           init_map, map_entropy, update_map)
from liodom_tpu_torch.odometry.pipeline import (OdomState, init_state,
                                                odometry_step)
from liodom_tpu_torch.ops.features import (extract_features, select_edges,
                                           smoothness)
from liodom_tpu_torch.runtime import tracer


def init_combined(cfg: LiodomConfig, mcfg: MapConfig, device=None
                  ) -> Tuple[OdomState, MapState]:
    if not cfg.mapping:
        raise ValueError("combined pipeline requires cfg.mapping=True")
    odom = init_state(cfg, received_capacity=mcfg.local_map_capacity,
                      device=device)
    return odom, init_map(mcfg.map_capacity, device=device)


def _refresh_local_map(odom_state: OdomState, map_state: MapState,
                       pose: Pose, mcfg: MapConfig, step: Optional[int],
                       every: int) -> OdomState:
    """Hand the freshly extracted local map to the odometer, every
    ``every``-th frame (``step`` is the host's frame counter).

    ``every > 1`` mirrors the reference deployment: the mapper publishes at
    its own cadence (latched topic, liodom_mapping_node.cc:92-106) and the
    odometer merges whatever map it received last (laser_odometry.cc:
    276-279)."""
    if every > 1 and step is not None and step % every != 0:
        return odom_state
    loc_xyz, loc_valid, n_hits = get_local_map(
        map_state, pose.t, mcfg, capacity=mcfg.local_map_capacity)
    if tracer.RECORDER.on:
        tracer.count("local_map.rows",
                     n_hits.clamp(max=mcfg.local_map_capacity))
    return odom_state._replace(received_xyz=loc_xyz,
                               received_valid=loc_valid)


def _check_devices(odom_state: OdomState, map_state: MapState,
                   *inputs: torch.Tensor) -> None:
    dev = odom_state.odom.t.device
    if any(t.device != dev for t in inputs) or map_state.xyz.device != dev:
        raise ValueError(f"input on {[str(t.device) for t in inputs]}, map "
                         f"on {map_state.xyz.device}, odometry on {dev}")


def _odom_only(state: OdomState, edges: EdgeCloud, cfg: LiodomConfig,
               t_laser_base: Optional[Pose] = None) -> Tuple[OdomState, Pose]:
    """The odometry half of a combined frame (``service.py:164``)."""
    return odometry_step(state, edges, cfg, t_laser_base)


def _combined(odom_state: OdomState, map_state: MapState, edges: EdgeCloud,
              cfg: LiodomConfig, mcfg: MapConfig, step: Optional[int],
              every: int, t_laser_base: Optional[Pose]
              ) -> Tuple[OdomState, MapState, Pose, torch.Tensor]:
    """A combined frame from its edges: odometry against the map received
    last frame, the edges inserted at the solved pose, the refreshed local
    map handed to the next frame."""
    new_odom, pose = _odom_only(odom_state, edges, cfg, t_laser_base)
    with tracer.span("map.update", device=True):
        map_state = update_map(map_state, edges.xyz, edges.valid, pose, mcfg)
    with tracer.span("map.local", device=True):
        new_odom = _refresh_local_map(new_odom, map_state, pose, mcfg, step,
                                      every)
    return new_odom, map_state, pose, edges.num_valid()


def combined_step(odom_state: OdomState, map_state: MapState,
                  raw_xyz: torch.Tensor, raw_valid: torch.Tensor,
                  cfg: LiodomConfig, mcfg: MapConfig,
                  step: Optional[int] = None, local_map_every: int = 1,
                  t_laser_base: Optional[Pose] = None
                  ) -> Tuple[OdomState, MapState, Pose, torch.Tensor]:
    """One frame of odometry + mapping from a raw scan (``service.py:74``):
    ``raw_xyz`` (N, 3) padded points and their mask ``raw_valid`` (N,)
    (``RawScan.from_points``), split by elevation on the device, then as
    :func:`combined_image_step`.  ``step`` (a host int) with
    ``local_map_every`` throttles the local-map extraction.  Returns (odom
    state, map state, pose, n_edges as a 0-d tensor)."""
    _check_devices(odom_state, map_state, raw_xyz, raw_valid)
    edges = extract_features(RawScan(raw_xyz, raw_valid), cfg)
    return _combined(odom_state, map_state, edges, cfg, mcfg, step,
                     local_map_every, t_laser_base)


def combined_image_step(odom_state: OdomState, map_state: MapState,
                        img_xyz: torch.Tensor, img_count: torch.Tensor,
                        cfg: LiodomConfig, mcfg: MapConfig,
                        step: Optional[int] = None, local_map_every: int = 1,
                        t_laser_base: Optional[Pose] = None
                        ) -> Tuple[OdomState, MapState, Pose, torch.Tensor]:
    """One frame of odometry + mapping from a loader-split ring image.

    The reference's dataflow: odometry solves against the map received
    last frame, the mapper inserts this frame's edges at the solved pose
    (liodom_mapping_node.cc:45-90) and the refreshed local map goes to the
    next frame.  ``step`` (a host int) with ``local_map_every`` throttles
    the extraction to the async mapper's cadence.  Returns (odom state, map
    state, pose, n_edges as a 0-d tensor); the input states are untouched."""
    _check_devices(odom_state, map_state, img_xyz, img_count)
    with tracer.span("step", device=True):
        img = RingImage(img_xyz, img_count)
        with tracer.span("features", device=True):
            edges = select_edges(img, smoothness(img, cfg), cfg)
        return _combined(odom_state, map_state, edges, cfg, mcfg, step,
                         local_map_every, t_laser_base)


def chained_combined_image_step(odom_state: OdomState, map_state: MapState,
                                imgs_xyz: torch.Tensor,
                                imgs_count: torch.Tensor,
                                cfg: LiodomConfig, mcfg: MapConfig,
                                step0: int = 0, local_map_every: int = 1,
                                t_laser_base: Optional[Pose] = None,
                                imu_quats: Optional[torch.Tensor] = None
                                ) -> Tuple[OdomState, MapState, Pose,
                                           torch.Tensor]:
    """K frames of :func:`combined_image_step`, frame i at step
    ``step0 + i`` (chunk k of a replay passes ``step0 = k * K`` and the
    refresh pattern equals the unchained loop's).  With ``cfg.use_imu`` pass
    per-frame ``imu_quats`` (K, 4).  Returns (odom state, map state, poses
    (K, ...), n_edges (K,))."""
    if cfg.use_imu and imu_quats is None:
        raise ValueError("cfg.use_imu requires per-frame imu_quats (K, 4) "
                         "in the chained step")
    qs, ts, nes = [], [], []
    for i in range(imgs_xyz.shape[0]):
        if imu_quats is not None:
            odom_state = odom_state._replace(
                imu_ori=imu_quats[i].to(odom_state.imu_ori.dtype))
        odom_state, map_state, pose, ne = combined_image_step(
            odom_state, map_state, imgs_xyz[i], imgs_count[i], cfg, mcfg,
            step=step0 + i, local_map_every=local_map_every,
            t_laser_base=t_laser_base)
        qs.append(pose.q)
        ts.append(pose.t)
        nes.append(ne)
    return (odom_state, map_state, Pose(torch.stack(qs), torch.stack(ts)),
            torch.stack(nes))


class MappingService:
    """Host-side mapper mirroring liodom_mapping_node.cc.

    The reference node consumes the edges and the TF pose, updates the map
    on every message, publishes the full map and, when anyone listens, the
    local map around the current pose, re-publishing latched copies every
    ``publish_period`` if stale (liodom_mapping_node.cc:92-106)."""

    def __init__(self, mcfg: MapConfig, publish_period: float = 3.0,
                 stale_after: float = 5.0, device=None):
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.state = init_map(mcfg.map_capacity, device=self.device)
        self.publish_period = publish_period
        self.stale_after = stale_after
        self._last_update_t = 0.0
        self._last_publish_t = 0.0
        self._latched_map: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def update(self, edges_xyz, edges_valid, pose: Pose,
               now: Optional[float] = None) -> None:
        """lidarClb (liodom_mapping_node.cc:45-90): insert edges at pose."""
        dtype = self.state.xyz.dtype
        self.state = update_map(
            self.state,
            torch.as_tensor(edges_xyz, dtype=dtype, device=self.device),
            torch.as_tensor(edges_valid, dtype=torch.bool,
                            device=self.device),
            Pose(torch.as_tensor(pose.q, dtype=dtype, device=self.device),
                 torch.as_tensor(pose.t, dtype=dtype, device=self.device)),
            self.mcfg)
        self._last_update_t = time.monotonic() if now is None else now

    def full_map(self, now: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        xyz, valid = get_map(self.state)
        out = (xyz.cpu().numpy(), valid.cpu().numpy())
        self._latched_map = out
        self._last_publish_t = time.monotonic() if now is None else now
        return out

    def local_map(self, position) -> Tuple[torch.Tensor, torch.Tensor]:
        xyz, valid, _ovf = self.local_map_with_overflow(position)
        return xyz, valid

    def local_map_with_overflow(self, position
                                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(xyz, valid, hits beyond capacity) from one extraction."""
        pos = torch.as_tensor(position, dtype=self.state.xyz.dtype,
                              device=self.device)
        xyz, valid, n_hits = get_local_map(
            self.state, pos, self.mcfg, capacity=self.mcfg.local_map_capacity)
        ovf = max(int(n_hits) - self.mcfg.local_map_capacity, 0)
        if ovf:
            logging.getLogger("liodom.mapping").warning(
                "local map truncated: %d hits > capacity %d "
                "(raise MapConfig.local_map_capacity)",
                int(n_hits), self.mcfg.local_map_capacity)
        return xyz, valid, ovf

    def local_map_overflow(self, position) -> int:
        """Hits beyond ``local_map_capacity`` at ``position`` (0 = lossless).
        The fused combined path clips silently on the card; apps poll this
        to honour the no-silent-caps contract."""
        return self.local_map_with_overflow(position)[2]

    def entropy(self) -> float:
        """Shannon entropy of hash-bucket occupancy (``Map::getMapEntropy``,
        map.cc:191-211), the reference's map-health diagnostic."""
        return map_entropy(self.state)

    def maybe_republish(self, now: Optional[float] = None):
        """timerClb (liodom_mapping_node.cc:92-106): the latched map if it
        has gone stale, else None."""
        now = time.monotonic() if now is None else now
        if (self._latched_map is not None
                and now - self._last_publish_t > self.stale_after):
            self._last_publish_t = now
            return self._latched_map
        return None
