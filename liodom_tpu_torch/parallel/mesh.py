"""Device mesh construction (port of ``liodom_tpu/parallel/mesh.py``).

The reference scales by OS processes + ROS topics (SURVEY.md §5); here each
process is one rank of a ``torch.distributed`` process group with one
device, and the ranks form a 2-D ``DeviceMesh``:

* ``data`` — independent odometry sequences (ranks of one data index never
  talk to another's);
* ``map``  — the matching map, the correspondence set and the hash-grid map
  sharded across ranks: kNN candidates merge with an ``all_gather``, the
  6x6 normal equations with an ``all_reduce``.

A CUDA mesh runs on NCCL and a CPU mesh on gloo; the process group
(``parallel.launch.initialize``) must have been created with the matching
backend, and nothing picks gloo on its own when CUDA was asked for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from liodom_tpu_torch.core.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(data: int = 1, map_: Optional[int] = None,
              device=None) -> DeviceMesh:
    """The (data, map) mesh over every rank of the initialised process
    group, rank r at coordinate (r // map_, r % map_); on CUDA unless
    ``device`` says otherwise.  ``map_`` defaults to world size // data;
    raises when data x map_ is not the world size (``mesh.py:28-29``)."""
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {dev}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "liodom_tpu_torch.parallel.launch.initialize first")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{BACKENDS[dev.type]} backend; the process group "
                         f"runs {backend}")
    n = dist.get_world_size()
    if map_ is None:
        map_ = n // data
    if data * map_ != n:
        raise ValueError(f"mesh {data}x{map_} != {n} devices")
    return init_device_mesh(dev.type, (data, map_),
                            mesh_dim_names=("data", "map"))


def axis(mesh: DeviceMesh, name: str) -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, size, this rank's index) of the mesh axis ``name``:
    what ``jax.lax.axis_size`` and ``axis_index`` give inside
    ``shard_map``."""
    return (mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name))
