"""Composed multi-card odometry + mapping: the adaptive-local-mapping loop
as one SPMD program (port of ``liodom_tpu/parallel/combined.py``).

The reference's flagship deployment is two processes wired over ROS topics
— the odometer solves against the local map it received last, the mapper
(liodom_mapping_node.cc:45-90) inserts the solved frame's edges into the
global hash-grid map and publishes back the neighbourhood around the pose,
which the odometer merges next frame (launch/liodom.launch:34-57,
laser_odometry.cc:310-314).  Here every rank of a (data x map) mesh runs
this loop for its data index's sequence, one sequence per rank:

* :func:`make_sharded_combined_step` — the odometry step of
  ``parallel/sharded.py`` (map-sharded kNN, residual-sharded LM), the
  shard-local map update of ``parallel/sharded_map.py`` and one
  ``all_gather`` of the shards' local-map hits as next frame's received
  map;
* :func:`make_sharded_combined_image_step` — every stage with O(points)
  work sharded over 'map': the features on this rank's ``scan_lines // n``
  rings (K1/K2) and one ``all_gather`` of the edge slots, ring-major; a
  matching map that is just the window slots this rank owns plus its own
  received shard (global slot s lives on rank s % n at row s // n); the
  sharded solve; the window write by the slot's owner; the shard-local map
  update and the shard-local K7 feedback, which stays on the rank that
  searches it next frame (no feedback gather).

Dataflow order matches ``mapping/service.py:combined_image_step``: solve
against last frame's received map, insert at the solved pose, refresh the
neighbourhood for the next frame.  Scalars (the global ring pointer and the
frame count) are device tensors and the owner's write is a select, so no
step synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping.grid import MapState, get_local_map
from liodom_tpu_torch.odometry.pipeline import OdomState, init_state
from liodom_tpu_torch.ops.features import select_edges, smoothness
from liodom_tpu_torch.parallel.mesh import axis
from liodom_tpu_torch.parallel.sharded import (_one_sequence_step,
                                               _sharded_solve, all_gather)
from liodom_tpu_torch.parallel.sharded_map import (_shard_local_map,
                                                   _shard_update,
                                                   init_sharded_map)


def _mesh_device(mesh, device) -> torch.device:
    """The device of an init function: CUDA unless ``device`` says
    otherwise, and the mesh's kind."""
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"state on {dev}, mesh on {mesh.device_type}")
    return dev


def init_combined_sharded(cfg: LiodomConfig, mcfg: MapConfig, mesh,
                          dtype=torch.float32, device=None
                          ) -> Tuple[OdomState, MapState]:
    """This rank's (odometry state, map shard) for
    :func:`make_sharded_combined_step` (``combined.py:47-65``): the received
    map holds ``(local_map_capacity // n) * n`` rows, which the gathered
    feedback fills exactly; the shard ``map_capacity // n``."""
    dev = _mesh_device(mesh, device)
    if not cfg.mapping:
        raise ValueError("composed sharded step requires cfg.mapping=True")
    _, n, _ = axis(mesh, "map")
    r = (mcfg.local_map_capacity // n) * n
    return (init_state(cfg, received_capacity=r, device=dev),
            init_sharded_map(mcfg, n, dtype, device=dev))


def make_sharded_combined_step(mesh, cfg: LiodomConfig, mcfg: MapConfig):
    """``step(ostate, mshard, exyz (E, 3), evalid (E,)) -> (ostate, mshard,
    pose)`` (``combined.py:68-100``): the map-sharded odometry step, the
    shard-local insert at the solved pose and the gathered neighbourhood as
    next frame's received map."""
    group, n, me = axis(mesh, "map")
    per_loc = mcfg.local_map_capacity // n

    def step(ostate: OdomState, mstate: MapState, exyz: torch.Tensor,
             evalid: torch.Tensor) -> Tuple[OdomState, MapState, Pose]:
        o2, pose = _one_sequence_step(ostate, exyz, evalid, cfg, group, n, me)
        m2 = _shard_update(mstate, exyz, evalid, pose, mcfg, me, n)
        lx, lv = _shard_local_map(m2, pose.t, mcfg, per_loc, group, n)
        o2 = o2._replace(received_xyz=lx.to(o2.received_xyz.dtype),
                         received_valid=lv)
        return o2, m2, pose

    return step


class ShardedCombinedState(NamedTuple):
    """One rank's state for the fully-sharded composed step
    (``combined.py:128-142``).  The poses and the two scalars are the same
    on every rank of a map group; ``win_*``/``recv_*`` are this rank's."""

    odom: Pose
    prev_odom: Pose
    win_xyz: torch.Tensor     # (Kl, E, 3) my window slots (world frame)
    win_valid: torch.Tensor   # (Kl, E)
    next_slot: torch.Tensor   # () int64 — global ring pointer
    nframes: torch.Tensor     # () int64 — global frames held
    recv_xyz: torch.Tensor    # (per_loc, 3) my received-map shard
    recv_valid: torch.Tensor  # (per_loc,)


def init_combined_image_sharded(cfg: LiodomConfig, mcfg: MapConfig, mesh,
                                dtype=torch.float32, device=None
                                ) -> Tuple[ShardedCombinedState, MapState]:
    """This rank's (state, map shard) for
    :func:`make_sharded_combined_image_step` (``combined.py:145-170``):
    ``ceil(local_map_size / n)`` window slots (a rank's unused tail slots
    stay invalid) and a received shard of ``local_map_capacity // n`` rows."""
    dev = _mesh_device(mesh, device)
    if not cfg.mapping:
        raise ValueError("composed sharded step requires cfg.mapping=True")
    if cfg.filter_local_map:
        raise ValueError("filter_local_map is a window-replicated transform "
                         "— unsupported on the fully-sharded path")
    _, n, _ = axis(mesh, "map")
    kl = -(-cfg.local_map_size // n)
    per_loc = mcfg.local_map_capacity // n
    e = cfg.max_edges
    st = ShardedCombinedState(
        Pose.identity(dtype, device=dev), Pose.identity(dtype, device=dev),
        torch.zeros((kl, e, 3), dtype=dtype, device=dev),
        torch.zeros((kl, e), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((per_loc, 3), dtype=dtype, device=dev),
        torch.zeros((per_loc,), dtype=torch.bool, device=dev))
    return st, init_sharded_map(mcfg, n, dtype, device=dev)


def matching_shard(s: ShardedCombinedState, n: int, me: int, k_global: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``me``'s matching-map shard (``combined.py:225-233``): the
    window slots it owns (global slot ``j * n + me`` is its row ``j``; a
    slot is live once that many frames were pushed), then its received
    shard."""
    kl = s.win_xyz.shape[0]
    slot_ids = torch.arange(kl, device=s.win_xyz.device) * n + me
    live = slot_ids < torch.clamp(s.nframes, max=k_global)
    return (torch.cat([s.win_xyz.reshape(-1, 3), s.recv_xyz]),
            torch.cat([(s.win_valid & live[:, None]).reshape(-1),
                       s.recv_valid]))


def make_sharded_combined_image_step(mesh, cfg: LiodomConfig,
                                     mcfg: MapConfig):
    """``step(state, mshard, img_xyz (R, W, 3), img_count (R,)) -> (state,
    mshard, pose, n_edges)`` (``combined.py:181-293``), every rank of a map
    group given its sequence's whole ring image; ``n_edges`` (a 0-d tensor)
    counts the frame's edges, as ``combined_image_step`` returns it.  The
    results match the single-card ``combined_image_step`` to float
    reassociation."""
    group, n, me = axis(mesh, "map")
    if cfg.scan_lines % n != 0:
        raise ValueError(f"scan_lines {cfg.scan_lines} must divide over "
                         f"map axis {n}")
    rpd = cfg.scan_lines // n
    per_loc = mcfg.local_map_capacity // n
    k_global = cfg.local_map_size

    def step(s: ShardedCombinedState, mstate: MapState, img_xyz: torch.Tensor,
             img_count: torch.Tensor
             ) -> Tuple[ShardedCombinedState, MapState, Pose, torch.Tensor]:
        # 1. features on my rings (the pick chain never crosses rings), the
        # edge slots gathered in ring-major order: slot-identical to the
        # full extractor
        my_img = RingImage(img_xyz[me * rpd:(me + 1) * rpd],
                           img_count[me * rpd:(me + 1) * rpd])
        ec = select_edges(my_img, smoothness(my_img, cfg), cfg)
        exyz = all_gather(ec.xyz, group, n).reshape(-1, 3)
        evalid = all_gather(ec.valid, group, n).reshape(-1)

        # 2. my matching-map shard: the window slots I own + my received
        # shard
        map_xyz, map_valid = matching_shard(s, n, me, k_global)

        # 3. predict + the sharded solve
        pred = se3.compose(
            s.odom, se3.compose(se3.inverse(s.prev_odom), s.odom))
        pose = _sharded_solve(pred, exyz, evalid, map_xyz, map_valid, cfg,
                              group, n, me)

        # 4. window push: only the owner of global slot next_slot writes
        frame_x = torch.where(evalid[:, None], se3.transform(pose, exyz),
                              torch.zeros_like(exyz))
        gslot = s.next_slot
        hit = ((torch.arange(s.win_xyz.shape[0], device=s.win_xyz.device)
                == gslot // n) & (gslot % n == me))
        win_xyz = torch.where(hit[:, None, None], frame_x[None], s.win_xyz)
        win_valid = torch.where(hit[:, None], evalid[None], s.win_valid)

        # 5. shard-local insert + shard-local feedback for the next frame
        m2 = _shard_update(mstate, exyz, evalid, pose, mcfg, me, n)
        lx, lv, _n_hits = get_local_map(m2, pose.t, mcfg, capacity=per_loc)
        out = ShardedCombinedState(
            pose, s.odom, win_xyz, win_valid, (gslot + 1) % k_global,
            torch.clamp(s.nframes + 1, max=k_global),
            lx.to(s.recv_xyz.dtype), lv)
        return out, m2, pose, evalid.sum()

    return step
