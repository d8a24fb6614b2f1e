"""SPMD global hash-grid map: leaves sharded across the 'map' mesh axis
(port of ``liodom_tpu/parallel/sharded_map.py``).

The reference's mapper owns one ``unordered_map`` of cells (map.cc).  Here
each rank of a map group owns a deterministic slice of the grid, at
RESOLUTION-LEAF granularity (0.4 m): a scan near the origin touches a
handful of 40 m cells but thousands of leaves, so hashing leaves balances
the shards.  This is exact because a leaf's centroid depends only on that
leaf's points, so shard-local updates build exactly the monolithic map's
point set with no traffic on update.  Only the local-map assembly
communicates: each shard extracts its hits of the neighbourhood (K7) and one
``all_gather`` assembles the matching map (the reference's mapper->odometer
topic, liodom_mapping_node.cc:81-87).

Each shard has ``map_capacity // n`` rows, so overflow is per shard and is
counted in its ``overflow`` as ``grid.update_map`` counts it.  A rank holds
its own shard: the JAX package's stacked ``(n_shards, ...)`` layout is what
``convert.sharded_map_state_from_numpy`` takes apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import MapConfig
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping.grid import (MapState, _div, get_local_map,
                                           init_map, update_map)
from liodom_tpu_torch.ops.probe_insert import mul32
from liodom_tpu_torch.parallel.mesh import axis
from liodom_tpu_torch.parallel.sharded import all_gather

_U32 = 0xFFFFFFFF


def cell_owner(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owning an integer grid key (..., 3): the reference's HashKey
    mix (map.h:74-83), avalanched by ``* 0x9E3779B1`` and ``h ^= h >> 16``,
    mod the shard count (``sharded_map.py:42-56``).  The JAX package's
    uint32 arithmetic, bit for bit, on int64 tensors: a negative key enters
    as its two's complement, the shifts and the product wrap mod 2^32."""
    k = key.to(torch.int64) & _U32
    h = (k[..., 0] ^ ((k[..., 1] << 1) & _U32)) ^ ((k[..., 2] << 2) & _U32)
    h = mul32(h, 0x9E3779B1)
    h = h ^ (h >> 16)
    return (h % n_shards).to(torch.int32)


def leaf_owner(world_xyz: torch.Tensor, res: float, n_shards: int
               ) -> torch.Tensor:
    """Shard owning each point, by its resolution leaf ``floor(p / res)``
    (``sharded_map.py:59-68``)."""
    leaf = torch.floor(_div(world_xyz, res)).to(torch.int32)
    return cell_owner(leaf, n_shards)


def init_sharded_map(mcfg: MapConfig, n_shards: int, dtype=torch.float32,
                     device=None) -> MapState:
    """This rank's empty shard, ``map_capacity // n_shards`` rows, on CUDA
    unless ``device`` says otherwise (``sharded_map.py:71-77``)."""
    return init_map(mcfg.map_capacity // n_shards, dtype, device=device)


def _shard_update(state: MapState, pts: torch.Tensor, valid: torch.Tensor,
                  pose: Pose, mcfg: MapConfig, me: int, n: int) -> MapState:
    """Insert the points whose leaf this rank (``me`` of ``n``) owns: the
    port's ``update_map`` (with the probe kernel on CUDA) on the owned
    subset (``sharded_map.py:80-87``)."""
    world = se3.transform(pose, pts)
    mine = valid & (leaf_owner(world, mcfg.resolution, n) == me)
    return update_map(state, pts, mine, pose, mcfg)


def _shard_local_map(state: MapState, position: torch.Tensor,
                     mcfg: MapConfig, per_shard_capacity: int, group, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's neighbourhood hits (K7 on CUDA) assembled over the map
    group by one ``all_gather``: (n * capacity, 3) rows and their mask,
    shard-major, identical on every rank (``sharded_map.py:90-98``)."""
    xyz, ok, _n_hits = get_local_map(state, position, mcfg,
                                     capacity=per_shard_capacity)
    return (all_gather(xyz, group, n).reshape(-1, 3),
            all_gather(ok, group, n).reshape(-1))


def make_sharded_map_fns(mesh, mcfg: MapConfig,
                         per_shard_local_capacity: Optional[int] = None):
    """(update_fn, local_map_fn) over the mesh's 'map' axis
    (``sharded_map.py:101-138``):

    update_fn(shard, pts, valid, pose) -> shard
        pts/valid/pose the same on every rank; each shard keeps its leaves.
    local_map_fn(shard, position) -> (xyz, valid)
        the assembled neighbourhood of ``position``, the same on every rank.
    """
    group, n, me = axis(mesh, "map")
    cap = (per_shard_local_capacity if per_shard_local_capacity is not None
           else max(mcfg.local_map_capacity // n, 1))

    def update_fn(state: MapState, pts: torch.Tensor, valid: torch.Tensor,
                  pose: Pose) -> MapState:
        return _shard_update(state, pts, valid, pose, mcfg, me, n)

    def local_map_fn(state: MapState, position: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _shard_local_map(state, position, mcfg, cap, group, n)

    return update_fn, local_map_fn
