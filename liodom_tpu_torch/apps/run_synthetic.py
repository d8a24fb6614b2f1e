"""End-to-end odometry demo on a synthetic world with exact ground truth
(port of ``apps/run_synthetic.py``).

The equivalent of replaying a rosbag through liodom_node
(launch/liodom.launch): feeds simulated HDL-64 scans through the port's
step on the card, prints per-frame poses, and scores ATE against ground
truth.

Profiles:
* ``planar`` — the original gentle yaw-only course.
* ``6dof``   — rotation-rich: sinusoidal roll/pitch, z undulation, sharper
  turns; the scenario that scores roll/pitch drift and the IMU override.

``--imu`` feeds a simulated IMU (ground-truth base orientation + noise)
through SharedData::setLastIMUOri parity (pipeline.set_imu) with
``use_imu`` on — the reference's roll/pitch override path
(laser_odometry.cc:152-183).  ``--t-base-laser "x,y,z,yaw,pitch,roll"``
plumbs a static base->laser transform like the launch-file
static_transform_publisher (launch/liodom.launch:64-68) through the solver
(IMU re-expression) and the publisher (pose re-expression).

Usage:
    python -m liodom_tpu_torch.apps.run_synthetic [--mapping] [--raw-path]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--profile", choices=["planar", "6dof"], default="planar")
    ap.add_argument("--speed", type=float, default=1.2, help="m/frame")
    ap.add_argument("--yaw-rate", type=float, default=None,
                    help="rad/frame (default 0.01 planar, 0.03 6dof)")
    ap.add_argument("--noise", type=float, default=0.0, help="sensor sigma, m")
    ap.add_argument("--width", type=int, default=1800, help="azimuth samples")
    ap.add_argument("--ring-width", type=int, default=4096,
                    help="padded points per ring; the elevation formulas can "
                    "merge two laser rows into one ring, so this should be "
                    "~2x the azimuth width to avoid (counted) truncation")
    ap.add_argument("--local-map-size", type=int, default=5)
    ap.add_argument("--local-map-capacity", type=int, default=65536,
                    help="received-local-map buffer rows (fixed-shape "
                    "deployment sizing; rows beyond the neighbourhood's "
                    "n_hits are padding that still costs sort/kNN time — "
                    "truncation is counted and warned)")
    ap.add_argument("--map-capacity", type=int, default=524288,
                    help="hash-grid table rows; right-size to the course. "
                    "Overflow is counted and warned")
    ap.add_argument("--local-map-every", type=int, default=1,
                    help="refresh the received local map every Nth frame — "
                    "the reference's async-mapper cadence (second process, "
                    "latched topic; liodom_mapping_node.cc:92-106)")
    ap.add_argument("--mapping", action="store_true",
                    help="fused odometry + hash-grid mapping with the "
                    "adaptive local-map feedback loop")
    ap.add_argument("--filter-local-map", action="store_true",
                    help="0.4 m voxel filter of the window "
                    "(laser_odometry.cc:286-295)")
    ap.add_argument("--imu", action="store_true",
                    help="simulated IMU roll/pitch override (use_imu)")
    ap.add_argument("--imu-noise", type=float, default=0.005,
                    help="IMU orientation noise, rad per axis")
    ap.add_argument("--t-base-laser", default=None,
                    help='static base->laser TF "x,y,z,yaw,pitch,roll" '
                    "(launch/liodom.launch:64-68 convention)")
    ap.add_argument("--save-results-dir", default=None,
                    help="dump KITTI poses.txt + timing files here")
    ap.add_argument("--diag-lines", action="store_true",
                    help="report accepted-correspondence line-direction "
                    "stats on the final frame (z-observability diagnostic)")
    ap.add_argument("--raw-path", action="store_true",
                    help="feed RAW scans and split on the device (full_step "
                    "/ combined_step) instead of the production "
                    "loader-split image path")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (cpu runs the "
                    "kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the app; returns its report (``rc`` is the exit code)."""
    args = parse_args(argv)

    import torch

    from liodom_tpu_torch.core import pose as se3
    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.core.device import resolve_device
    from liodom_tpu_torch.core.frame import RawScan
    from liodom_tpu_torch.core.pose import Pose
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             drive_trajectory_6dof,
                                             quat_from_matrix_np, rpy_matrix,
                                             yaw_matrix)
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.ops.features import extract_features, split_overflow
    from liodom_tpu_torch.runtime import native
    from liodom_tpu_torch.runtime.device_io import (SyncAudit, device_name,
                                                    fetch_poses, path_kernels,
                                                    prepare_kernels)
    from liodom_tpu_torch.runtime.publisher import OdomPublisher

    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    cfg = LiodomConfig(local_map_size=args.local_map_size,
                       ring_width=args.ring_width,
                       mapping=args.mapping,
                       filter_local_map=args.filter_local_map,
                       use_imu=args.imu,
                       save_results=args.save_results_dir is not None)
    report = {"app": "run_synthetic", "rc": 0, "device": device_name(dev),
              "mapping": args.mapping, "raw_path": args.raw_path,
              "frames": args.frames}
    report.update(prepare_kernels(path_kernels(args.mapping), dev))

    world = BoxWorld(seed=0)
    if args.profile == "6dof":
        yaw_rate = 0.03 if args.yaw_rate is None else args.yaw_rate
        pos, rots, quats = drive_trajectory_6dof(
            args.frames, speed=args.speed, yaw_rate=yaw_rate)
    else:
        yaw_rate = 0.01 if args.yaw_rate is None else args.yaw_rate
        pos, yaws = drive_trajectory(args.frames, speed=args.speed,
                                     yaw_rate=yaw_rate)
        rots = np.stack([yaw_matrix(y) for y in yaws])
        quats = np.stack([quat_from_matrix_np(r) for r in rots])

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # static base<->laser TF (identity when unset, like the launch files)
    t_base_laser = None   # base -> laser (publisher side)
    t_laser_base = None   # laser -> base (solver/IMU side)
    if args.t_base_laser:
        x, y, z, yw, pt, rl = (float(v) for v in args.t_base_laser.split(","))
        r_bl = rpy_matrix(rl, pt, yw)
        q_bl = quat_from_matrix_np(r_bl)
        t_base_laser = Pose(on_dev(q_bl), on_dev([x, y, z]))
        t_laser_base = se3.inverse(t_base_laser)

    state = P.init_state(cfg, device=dev)
    pub = OdomPublisher(
        fixed_frame=cfg.fixed_frame, base_frame=cfg.base_frame,
        publish_tf=cfg.publish_tf,
        t_base_laser=(None if t_base_laser is None
                      else t_base_laser.matrix().cpu().numpy()))

    stats = None
    if args.save_results_dir:
        from liodom_tpu_torch.runtime.stats import Stats
        stats = Stats()

    # Pre-render the scans (sensor-side work, in threads) and put them on
    # the card; the engine loop below then measures the device pipeline
    # with the poses fetched once, at the end.
    def render(i):
        return world.render(pos[i], rots[i], width=args.width,
                            noise=args.noise, seed=100 + i)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        renders = list(ex.map(render, range(args.frames)))
    scans = [RawScan.from_points(torch.from_numpy(r), cfg.max_points,
                                 device=dev) for r in renders]
    # Production input path: ring routing is the LOADER's job (native C++
    # split, exactly like run_kitti); --raw-path splits on the device
    # (full_step / combined_step) instead.
    if not args.raw_path:
        images = [native.split_velodyne(
            np.asarray(r, np.float32), cfg.scan_lines, cfg.ring_width,
            cfg.min_range, cfg.max_range) for r in renders]
        images = [(on_dev(im), on_dev(ct, torch.int32))
                  for im, ct, _ in images]

    # simulated IMU stream: ground-truth BASE orientation + noise
    imu_quats = None
    if args.imu:
        rng = np.random.default_rng(42)
        tlb = t_laser_base if t_laser_base is not None else Pose.identity(
            device=dev)
        imu = []
        for i in range(args.frames):
            gt_laser = Pose(on_dev(quats[i]), on_dev(pos[i]))
            q_base = se3.compose(gt_laser, tlb).q.cpu().double()
            dq = quat_from_matrix_np(rpy_matrix(
                *(rng.normal(scale=args.imu_noise, size=3))))
            q_noisy = se3.quat_mul(torch.as_tensor(dq, dtype=torch.float32),
                                   q_base.float())
            imu.append(q_noisy.numpy())
        imu_quats = on_dev(np.stack(imu))   # (F, 4) on the device

    mstate = mcfg = None
    if args.mapping:
        from liodom_tpu_torch.mapping.service import (combined_image_step,
                                                      combined_step,
                                                      init_combined)
        mcfg = MapConfig(local_map_capacity=args.local_map_capacity,
                         map_capacity=args.map_capacity)
        state, mstate = init_combined(cfg, mcfg, device=dev)

        if args.raw_path:
            def step(st, i):
                nonlocal mstate
                st, mstate, pose, ne = combined_step(
                    st, mstate, scans[i].xyz, scans[i].valid, cfg, mcfg,
                    step=i, local_map_every=args.local_map_every,
                    t_laser_base=t_laser_base)
                return st, pose, ne
        else:
            def step(st, i):
                nonlocal mstate
                st, mstate, pose, ne = combined_image_step(
                    st, mstate, images[i][0], images[i][1], cfg, mcfg,
                    step=i, local_map_every=args.local_map_every,
                    t_laser_base=t_laser_base)
                return st, pose, ne
    else:
        if args.raw_path:
            def step(st, i):
                return P.full_step(st, scans[i].xyz, scans[i].valid, cfg,
                                   t_laser_base=t_laser_base)
        else:
            def step(st, i):
                return P.image_step(st, images[i][0], images[i][1], cfg,
                                    t_laser_base=t_laser_base)

    def feed(st, i):
        if imu_quats is not None:
            st = P.set_imu(st, imu_quats[i])
        return step(st, i)

    audit = SyncAudit(dev)
    t0 = time.perf_counter()
    state, pose, n_edges = feed(state, 0)
    pose.t.cpu()
    t_compile = time.perf_counter() - t0

    pending = [(pose.q, pose.t, n_edges)]
    t0 = time.perf_counter()
    with audit:
        for i in range(1, args.frames):
            state, pose, n_edges = feed(state, i)
            pending.append((pose.q, pose.t, n_edges))
    mats, nes = fetch_poses(pending)   # the only barrier here
    wall = time.perf_counter() - t0
    mean_ms = wall / max(args.frames - 1, 1) * 1e3
    est_q = torch.cat([p[0].reshape(-1, 4) for p in pending]).cpu()

    feat_ms = None
    if stats is not None:
        # Real per-frame device time of the feature-extraction stage
        # (split + smoothness + selection), measured after the fact: in the
        # fused step it has no separable host timestamp, so re-dispatch the
        # extraction alone over the same scans (stats.py five-file notes).
        ec = extract_features(scans[0], cfg)
        ec.valid[0].cpu()
        tf0 = time.perf_counter()
        for s in scans:
            ec = extract_features(s, cfg)
        ec.valid[0].cpu()
        feat_ms = (time.perf_counter() - tf0) * 1e3 / len(scans)

    # No silent caps: report points lost to the ring_width clamp on-device.
    ring_dropped = int(torch.stack([split_overflow(s, cfg)
                                    for s in scans]).sum())
    if ring_dropped:
        print(f"WARNING: {ring_dropped} points dropped by the "
              f"ring_width={cfg.ring_width} clamp across the run")
    if args.mapping:
        map_ovf = int(mstate.overflow)
        if map_ovf:
            print(f"WARNING: {map_ovf} map points dropped at "
                  f"map_capacity={mcfg.map_capacity}")
        # Local-map truncation check (the help text promises counted-and-
        # warned truncation): n_hits at the final pose vs the buffer rows.
        from liodom_tpu_torch.mapping.grid import get_local_map
        _, _, n_hits = get_local_map(mstate, pending[-1][1], mcfg,
                                     capacity=mcfg.local_map_capacity)
        loc_ovf = max(int(n_hits) - mcfg.local_map_capacity, 0)
        if loc_ovf:
            print(f"WARNING: local map truncated by {loc_ovf} points at the "
                  f"final pose (raise --local-map-capacity)")
        report.update(map_overflow=map_ovf, local_map_truncated=loc_ovf)

    errs, rp_errs, axis_errs, est_ts = [], [], [], []
    est_rpy = se3.rpy_from_quat(est_q).numpy()
    gt_rpy = se3.rpy_from_quat(torch.as_tensor(quats,
                                               dtype=torch.float32)).numpy()
    for i, (mat, ne) in enumerate(zip(mats, nes)):
        t = mat[:3, 3]
        est_ts.append(t)
        axis_errs.append(t - pos[i])
        err = np.linalg.norm(t - pos[i])
        errs.append(err)
        # roll/pitch error vs ground truth (the axes the IMU pins)
        rp = np.linalg.norm((est_rpy[i] - gt_rpy[i])[:2])
        rp_errs.append(rp)
        pub.publish(mat, stamp=i * 0.1)
        if stats is not None:
            stats.add_pose(mat)
            # run-level steady-state mean stamped on every row, not a
            # per-frame sample -> carried (column 2 = 0)
            stats.add_laser_odometry_time(mean_ms, measured=False)
            stats.add_feature_extraction_time(feat_ms)
            stats.add_num_feats(int(ne))
            stats.add_frame_time(mean_ms)
        print(f"frame {i:3d}: edges={int(ne):5d}  "
              f"t=({t[0]:7.2f} {t[1]:7.2f} {t[2]:6.2f})  "
              f"gt=({pos[i][0]:7.2f} {pos[i][1]:7.2f} {pos[i][2]:6.2f})  "
              f"err={err:6.3f} m")

    ate = float(np.sqrt(np.mean(np.square(errs))))
    rp_rmse = float(np.sqrt(np.mean(np.square(rp_errs))))
    print(f"\nATE (rmse): {ate:.4f} m over {args.frames} frames "
          f"[profile={args.profile}, mapping={args.mapping}, "
          f"imu={args.imu}, filter={args.filter_local_map}]")
    print(f"roll/pitch RMSE: {np.degrees(rp_rmse):.4f} deg")

    # Per-axis drift attribution: which axis carries the translation
    # error?  ATE split by axis, plus windowed relative drift — translation
    # error accumulated over a w-frame window divided by ground-truth
    # distance traveled in it (the RPE% convention).
    ax = np.asarray(axis_errs)                           # (F, 3)
    ax_rmse = np.sqrt(np.mean(np.square(ax), axis=0))
    est = np.asarray(est_ts)
    w = min(10, args.frames - 1)
    if w >= 2:
        rel = (est[w:] - est[:-w]) - (pos[w:] - pos[:-w])  # (F-w, 3)
        dist = np.maximum(np.linalg.norm(pos[w:] - pos[:-w], axis=1), 1e-9)
        rpe_pct = 100.0 * np.mean(np.abs(rel) / dist[:, None], axis=0)
        rpe_tot = 100.0 * float(np.mean(
            np.linalg.norm(rel, axis=1) / dist))
    else:
        rpe_pct, rpe_tot = np.zeros(3), 0.0
    print("per-axis drift:  ATE_x/y/z = "
          f"{ax_rmse[0]:.3f}/{ax_rmse[1]:.3f}/{ax_rmse[2]:.3f} m;  "
          f"RPE@{w}f x/y/z = {rpe_pct[0]:.2f}/{rpe_pct[1]:.2f}/"
          f"{rpe_pct[2]:.2f} % (total {rpe_tot:.2f} %)")

    if args.diag_lines:
        # Geometry of the accepted lines on the final frame: a point-to-line
        # residual has zero gradient ALONG the line, so if accepted lines are
        # mostly vertical, z sits in the null space and z drift is a feature
        # -geometry limit, not a solver bug (laser_odometry.cc:325-357 has
        # the same structure).
        from liodom_tpu_torch.ops.neighbors import line_correspondences
        ec = extract_features(scans[-1], cfg)
        mx, mv = P._matching_map(state, cfg)
        ewl = se3.transform(Pose(pending[-1][0], pending[-1][1]), ec.xyz)
        corr = line_correspondences(
            ewl, ec.valid, mx, mv, k=cfg.knn_k,
            max_sq_dist=cfg.knn_max_sq_dist, eig_ratio=cfg.eig_ratio,
            min_line_sep=cfg.min_line_sep)
        v = corr.valid.cpu().numpy()
        d = (corr.lpb - corr.lpa).cpu().numpy()[v]
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        az = np.abs(d[:, 2])
        print(f"line diagnostic (final frame): {v.sum()} accepted; "
              f"|dir_z| mean {az.mean():.3f}, "
              f">0.9 (near-vertical) {100.0 * (az > 0.9).mean():.1f} %, "
              f"<0.3 (z-constraining) {100.0 * (az < 0.3).mean():.1f} %")
    print(f"first frame: {t_compile:.3f} s")
    print(f"steady-state: {mean_ms:.2f} ms/frame = {1e3/mean_ms:.1f} scans/s "
          f"(sensor rate 10 Hz)")
    print(f"host syncs between due points: {audit.count}"
          + (f" (first: {audit.first})" if audit.first else ""))
    if stats is not None:
        stats.write_results(args.save_results_dir)
        print(f"results written to {args.save_results_dir}")
    report.update(rc=0 if ate < 0.5 else 1, ate_m=ate,
                  first_frame_s=t_compile, scans_per_s=1e3 / mean_ms,
                  host_syncs=audit.count, ring_dropped=ring_dropped)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
