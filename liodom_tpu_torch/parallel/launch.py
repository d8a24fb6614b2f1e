"""Multi-process launch: ``torch.distributed`` initialisation + mesh
construction (port of ``liodom_tpu/parallel/launch.py``).

The reference's "multi-node" story is two OS processes bridged by ROS
topics (SURVEY.md §5).  Here every process runs this same program as one
rank with one device, connects to a coordinator (rank 0's TCP store), and
the sharded steps run over the (data, map) mesh with NCCL collectives on
CUDA or gloo on the CPU.

Usage (one command per process)::

    python -m liodom_tpu_torch.parallel.launch \\
        --coordinator 10.0.0.1:29500 --num-processes 4 --process-id $I \\
        [--data D --map M] [--device cpu] smoke|combined-smoke
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.parallel.mesh import BACKENDS, axis, make_mesh


def initialize(coordinator: Optional[str], num_processes: Optional[int],
               process_id: Optional[int], device=None) -> None:
    """Join the process group of ``num_processes`` ranks whose coordinator
    (rank 0's store) listens at ``coordinator`` ("host:port"), as rank
    ``process_id``: NCCL on CUDA (the default), gloo on the CPU.  A CUDA
    rank takes device ``process_id % device_count``.

    An already initialised group is kept (the call is idempotent); every
    other case needs the coordinator, and a failure to reach it raises."""
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {dev}")
    if dist.is_initialized():
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, the number of "
                         "processes and this process's id")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[dev.type],
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_global_mesh(data: Optional[int] = None, map_: Optional[int] = None,
                     device=None):
    """(data, map) mesh over every rank (``launch.py:58-75``); by default
    one map group spans all ranks (``data`` = 1)."""
    if data is None:
        data = 1 if map_ is None else dist.get_world_size() // map_
    return make_mesh(data, map_, device)


def _data_sum(value: float, mesh) -> float:
    """``value`` summed over the mesh's data axis: the JAX checksums add
    the rows of the global batch."""
    group, _, _ = axis(mesh, "data")
    t = torch.tensor([value], dtype=torch.float64,
                     device=torch.device(mesh.device_type))
    dist.all_reduce(t, group=group)
    return float(t.item())


def smoke(mesh) -> float:
    """Two sharded odometry steps on synthetic data (``launch.py:78-116``);
    returns a checksum every rank agrees on.  The second frame is the
    first shifted by 0.2 m, so the solved pose must move (a zero checksum
    means a vacuous run).  Each rank steps one sequence."""
    from liodom_tpu_torch.core.config import LiodomConfig
    from liodom_tpu_torch.parallel.sharded import (init_batch_state,
                                                   make_sharded_step)

    dev = torch.device(mesh.device_type)
    cfg = LiodomConfig(max_points=4096, ring_width=128, local_map_size=2,
                       scan_lines=16, scan_regions=4, edges_per_region=4)
    state = init_batch_state(cfg, 1, device=dev)
    step = make_sharded_step(mesh, cfg)
    rng = np.random.default_rng(0)
    # edge points sampled on vertical lines (poles): point-to-LINE residuals
    # need collinear neighbourhoods
    n_poles = 32
    per = cfg.max_edges // n_poles
    base = rng.uniform(-15, 15, (n_poles, 1, 2))
    z = rng.uniform(-2, 2, (n_poles, per, 1))
    pts = np.concatenate(
        [np.broadcast_to(base, (n_poles, per, 2)), z],
        axis=-1).reshape(-1, 3) + rng.normal(scale=0.01,
                                            size=(n_poles * per, 3))
    pad = cfg.max_edges - len(pts)
    exyz = torch.from_numpy(np.pad(pts, ((0, pad), (0, 0))).astype(
        np.float32)).to(dev)[None]
    evalid = (torch.arange(cfg.max_edges, device=dev) < len(pts))[None]
    state, poses = step(state, exyz, evalid)             # seeds the window
    shift = torch.tensor([0.2, 0.0, 0.0], device=dev)
    state, poses = step(state, exyz - shift, evalid)     # solve: ~+0.2 m
    chk = _data_sum(float(poses.t.abs().sum()), mesh)
    if not np.isfinite(chk) or chk < 1e-3:
        raise RuntimeError(f"smoke solve did not move (checksum {chk})")
    return chk


def combined_smoke(mesh) -> float:
    """The flagship multi-card program — the fully-sharded composed
    odometry+mapping step (``parallel/combined.py``) — on this mesh, with
    every rank's pose held against the single-card ``combined_image_step``
    on the same frames (``launch.py:119-188``).  Returns a checksum every
    rank agrees on.  Every data index carries the same sequence."""
    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.core.frame import RawScan
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             yaw_matrix)
    from liodom_tpu_torch.mapping.service import (combined_image_step,
                                                  init_combined)
    from liodom_tpu_torch.ops.features import split_scan
    from liodom_tpu_torch.parallel import combined as CB

    dev = torch.device(mesh.device_type)
    _, n_map, _ = axis(mesh, "map")
    n_dev = mesh.size()
    cfg = LiodomConfig(max_points=16384, ring_width=256, local_map_size=3,
                       mapping=True)
    # sized so that no local map is truncated: under truncation the single
    # card keeps row-order hits while the shards keep their own, and the
    # matched point sets legitimately diverge
    mcfg = MapConfig(map_capacity=1024 * n_dev,
                     local_map_capacity=(2048 // n_map) * n_map)

    world = BoxWorld(seed=0)
    n_frames = 3
    pos, yaws = drive_trajectory(n_frames, speed=0.8, yaw_rate=0.02)
    frames = []
    for f in range(n_frames):
        scan = world.render(pos[f], yaw_matrix(yaws[f]), width=256,
                            noise=0.005, seed=f)
        frames.append(split_scan(RawScan.from_points(
            torch.from_numpy(scan), cfg.max_points, device=dev), cfg))

    step = CB.make_sharded_combined_image_step(mesh, cfg, mcfg)
    st, ms = CB.init_combined_image_sharded(cfg, mcfg, mesh, device=dev)
    for img in frames:
        st, ms, cpose, _ = step(st, ms, img.xyz, img.count)
    t_sharded = cpose.t.cpu().numpy()

    co, cm = init_combined(cfg, mcfg, device=dev)
    for img in frames:
        co, cm, p1, _ = combined_image_step(co, cm, img.xyz, img.count, cfg,
                                            mcfg)
    err = float(np.linalg.norm(t_sharded - p1.t.cpu().numpy()))
    if not np.isfinite(t_sharded).all():
        raise RuntimeError(f"composed pose not finite: {t_sharded}")
    if np.linalg.norm(t_sharded) < 0.3:
        raise RuntimeError(f"composed pose did not move: {t_sharded}")
    if err > 5e-3:
        raise RuntimeError(
            f"sharded combined diverged from single-card: {err} m")
    return float(np.sum(np.abs(t_sharded)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True,
                    help="host:port of rank 0's store")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data", type=int, default=None, help="mesh data axis")
    ap.add_argument("--map", dest="map_", type=int, default=None,
                    help="mesh map axis")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks; CUDA (NCCL) by default")
    ap.add_argument("cmd", nargs="?", default="smoke",
                    choices=["smoke", "combined-smoke"])
    args = ap.parse_args()

    initialize(args.coordinator, args.num_processes, args.process_id,
               args.device)
    try:
        mesh = make_global_mesh(args.data, args.map_, args.device)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"process {dist.get_rank()}/{dist.get_world_size()}: "
              f"mesh={shape} devices={mesh.size()}", flush=True)
        if args.cmd == "smoke":
            print(f"smoke step OK, checksum={smoke(mesh):.6f}", flush=True)
        else:
            print(f"combined smoke OK, checksum={combined_smoke(mesh):.6f}",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
