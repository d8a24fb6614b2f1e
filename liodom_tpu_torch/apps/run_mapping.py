"""Standalone mapping service — the ``liodom_mapping`` process equivalent
(port of ``apps/run_mapping.py``).

The reference's second executable (liodom_mapping_node.cc) consumes the edge
clouds published by the odometry node plus the TF pose it broadcast, inserts
them into the hash-grid map, and (re-)publishes the full map and the local
map around the pose.  Without ROS, the equivalent offline deployment is:
replay a KITTI sequence's edges at poses from a ``poses.txt`` (produced by
``run_kitti --results-dir``), build the map on the card, and export it.

Usage:
    python -m liodom_tpu_torch.apps.run_kitti --root $K --seq 00 \
        --results-dir out/
    python -m liodom_tpu_torch.apps.run_mapping --root $K --seq 00 \
        --poses out/poses.txt --out map_out/
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from liodom_tpu_torch.runtime.cache import enable_persistent_cache

enable_persistent_cache()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--poses", required=True,
                    help="KITTI-format poses.txt of the trajectory (laser "
                    "frame), e.g. from run_kitti --results-dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="export directory (PLY)")
    ap.add_argument("--ring-width", type=int, default=4096)
    # liodom_mapping.launch defaults: 20/25 m voxels (SURVEY.md §2)
    ap.add_argument("--voxel-xysize", type=float, default=20.0)
    ap.add_argument("--voxel-zsize", type=float, default=25.0)
    ap.add_argument("--resolution", type=float, default=0.4)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (cpu runs the "
                    "kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the app; returns its report (``rc`` is the exit code)."""
    args = parse_args(argv)

    import torch

    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.core.device import resolve_device
    from liodom_tpu_torch.core.frame import RingImage
    from liodom_tpu_torch.core.io import KittiSequence
    from liodom_tpu_torch.core.pose import Pose
    from liodom_tpu_torch.mapping.service import MappingService
    from liodom_tpu_torch.ops.features import select_edges, smoothness
    from liodom_tpu_torch.runtime.device_io import (Stager, device_name,
                                                    prepare_kernels,
                                                    prepare_loader)
    from liodom_tpu_torch.runtime.stats import load_kitti_poses

    dev = resolve_device(args.device)
    cfg = LiodomConfig(ring_width=args.ring_width)
    mcfg = MapConfig(voxel_xysize=args.voxel_xysize,
                     voxel_zsize=args.voxel_zsize,
                     resolution=args.resolution)
    seq = KittiSequence(args.root, args.seq)
    traj = load_kitti_poses(args.poses)
    n = min(len(seq), len(traj))
    if args.frames is not None:
        n = min(n, args.frames)
    print(f"mapping sequence {args.seq}: {n} frames, "
          f"device={device_name(dev)}")
    report = {"app": "run_mapping", "rc": 0, "device": device_name(dev),
              "frames": n, **prepare_loader()}
    # K1 and K2 extract the edges, the probe kernel inserts them and the
    # fold kernel folds them in, K7 extracts the exported local map
    report.update(prepare_kernels(("smoothness", "select", "probe_insert",
                                   "map_fold", "local_map_compact"), dev))

    # the trajectory goes to the card once; each frame takes its row
    quats = torch.as_tensor(np.stack([_quat_from_matrix(m[:3, :3])
                                      for m in traj[:n]]),
                            dtype=torch.float32, device=dev)
    trans = torch.as_tensor(traj[:n, :3, 3], dtype=torch.float32, device=dev)
    svc = MappingService(mcfg, device=dev)
    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev)
    t0 = time.perf_counter()
    ring_dropped = 0
    for i, (img, counts, n_drop) in enumerate(seq.iter_images(
            cfg.scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range)):
        if i >= n:
            break
        ring_dropped += n_drop
        # the mapper consumes EDGES (remapped /liodom/edges,
        # liodom_mapping_node.cc:139) — extract them like the odometer did
        rimg = RingImage(*stager.put(img, counts))
        edges = select_edges(rimg, smoothness(rimg, cfg), cfg)
        svc.update(edges.xyz, edges.valid, Pose(quats[i], trans[i]))
    occupied = int(svc.state.valid.sum())    # waits for the last update
    wall = time.perf_counter() - t0
    print(f"{n} updates in {wall:.1f} s = {n / max(wall, 1e-9):.1f} scans/s")
    print(f"map entropy: {svc.entropy():.3f}")
    if ring_dropped:
        print(f"WARNING: {ring_dropped} points dropped by the "
              f"ring_width={cfg.ring_width} clamp (raise --ring-width)")
    overflow = int(svc.state.overflow)
    if overflow:
        print(f"WARNING: {overflow} map points dropped at "
              f"map_capacity={mcfg.map_capacity}")

    xyz, valid = svc.full_map()
    print(f"map points: {int(valid.sum())}")
    if args.out:
        from liodom_tpu_torch.runtime.viz import save_ply
        os.makedirs(args.out, exist_ok=True)
        save_ply(os.path.join(args.out, "map.ply"), xyz, valid)
        lx, lv = svc.local_map(traj[n - 1][:3, 3])
        save_ply(os.path.join(args.out, "map_local.ply"),
                 lx.cpu().numpy(), lv.cpu().numpy(), color=(40, 200, 40))
        print(f"exported to {args.out}")
    report.update(occupied_slots=occupied, map_overflow=overflow,
                  ring_dropped=int(ring_dropped),
                  scans_per_s=n / max(wall, 1e-9))
    return report


def _quat_from_matrix(R):
    """wxyz quaternion from a 3x3 rotation matrix (numerically safe)."""
    R = np.asarray(R, float)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
