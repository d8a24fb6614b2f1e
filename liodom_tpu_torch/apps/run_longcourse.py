"""Long-trajectory full-stack run on the unbounded streaming world (port of
``apps/run_longcourse.py``).

The reference's evaluation protocol is long sequences: KITTI 00 is 4,541
frames of map growth and capacity pressure (stats.cc:75-95 scores them).
The procedurally tiled :class:`StreamWorld` carries the load here: the
geometry is generated around the vehicle as it drives, the course never
leaves the scene, and the ground truth is exact.

Full stack per frame, the deployed configuration: a 15-frame window, the
fused odometry + hash-grid map step (``combined_image_step``: K1, K2, K3
twice, the probe kernel; K7 at the local-map cadence) on the card, an
optional simulated IMU, or ``--chunk`` frames a call
(``chained_combined_image_step``) with the remainder on the per-frame
step.  Renders run in a thread pool (the sensor's job) and are split by
the native loader; the engine stages each frame onto the card from pinned
buffers and fetches poses in blocks.

Reports ATE, RPE@1, RPE@100 and drift %, scans/s (end to end and for the
engine alone), the map's leaves and cells, and every loss counter (ring
clamp, map overflow, local-map truncation); exits 1 on a map overflow or
a truncated local map.

Usage:
    python -m liodom_tpu_torch.apps.run_longcourse --frames 1000
    python -m liodom_tpu_torch.apps.run_longcourse --frames 1000 --chunk 10
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from liodom_tpu_torch.runtime.cache import enable_persistent_cache

enable_persistent_cache()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--world", choices=["stream", "box"], default="stream",
                    help="box = the finite arena (debug control; exits the "
                    "scene past ~115 frames)")
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--speed", type=float, default=1.2, help="m/frame")
    ap.add_argument("--yaw-rate", type=float, default=0.004)
    ap.add_argument("--ring-width", type=int, default=4096)
    ap.add_argument("--local-map-size", type=int, default=15,
                    help="deployed window (launch/liodom.launch:23)")
    ap.add_argument("--map-capacity", type=int, default=1 << 20,
                    help="hash table rows; sized for ~1k-frame courses "
                    "(leaf growth reported; overflow counted+warned)")
    ap.add_argument("--local-map-capacity", type=int, default=32768)
    ap.add_argument("--local-map-every", type=int, default=4)
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--imu-noise", type=float, default=0.005)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames a call (chained_combined_image_step); "
                    "the remainder takes the per-frame step")
    ap.add_argument("--render-workers", type=int, default=2)
    ap.add_argument("--sample-every", type=int, default=100,
                    help="frames between map-growth / truncation samples")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save a resumable checkpoint (odom + map state + "
                    "trajectory) every --checkpoint-every frames; resumes "
                    "automatically when one exists")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--json", action="store_true",
                    help="accepted for the JAX app's flags: the report is "
                    "always the last line")
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
    from liodom_tpu_torch.core.synth import (BoxWorld, StreamWorld,
                                             drive_trajectory,
                                             quat_from_matrix_np, rpy_matrix,
                                             yaw_matrix)
    from liodom_tpu_torch.mapping import grid as G
    from liodom_tpu_torch.mapping.service import (chained_combined_image_step,
                                                  combined_image_step,
                                                  init_combined)
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import checkpoint as CK
    from liodom_tpu_torch.runtime import native
    from liodom_tpu_torch.runtime.device_io import (Stager, SyncAudit,
                                                    device_name, fetch_poses,
                                                    path_kernels,
                                                    prepare_kernels)
    from liodom_tpu_torch.runtime.stats import Stats, rpe

    dev = resolve_device(args.device)
    n = args.frames
    chunk = max(args.chunk, 1)
    cfg = LiodomConfig(local_map_size=args.local_map_size,
                       ring_width=args.ring_width, mapping=True,
                       use_imu=args.imu)
    mcfg = MapConfig(map_capacity=args.map_capacity,
                     local_map_capacity=args.local_map_capacity)
    pos, yaws = drive_trajectory(n, speed=args.speed, yaw_rate=args.yaw_rate)
    if args.world == "box":
        world = BoxWorld(seed=0)
    else:
        world = StreamWorld(seed=0)
        # objects keep clear of the course (see-through-wall frames when
        # the vehicle transits a building are physically inconsistent)
        world.set_keepout(pos[:, :2])
    rots = [yaw_matrix(y) for y in yaws]
    quats = np.stack([quat_from_matrix_np(r) for r in rots])

    imu_dev = None
    if args.imu:
        # the noisy orientations in float32, as the JAX app's quat_mul
        # computes them, put on the card once (a per-frame copy from
        # pageable memory would synchronise)
        rng = np.random.default_rng(42)
        dq = np.stack([quat_from_matrix_np(rpy_matrix(
            *(rng.normal(scale=args.imu_noise, size=3)))) for _ in range(n)])
        imu = se3.quat_mul(torch.from_numpy(dq.astype(np.float32)),
                           torch.from_numpy(quats.astype(np.float32)))
        imu_dev = imu.to(dev)

    def make_frame(i):
        r = world.render(pos[i], rots[i], width=args.width,
                         noise=args.noise, seed=100 + i)
        return native.split_velodyne_np(r, cfg.scan_lines, cfg.ring_width,
                                        cfg.min_range, cfg.max_range)

    state, mstate = init_combined(cfg, mcfg, device=dev)
    report = {"app": "run_longcourse", "rc": 0, "device": device_name(dev),
              "chunk": chunk, "imu": args.imu,
              "map_capacity": mcfg.map_capacity}
    report.update(prepare_kernels(path_kernels(True), dev))

    start_frame = 0
    poses = []
    if args.checkpoint_dir and CK.latest_step(args.checkpoint_dir) is not None:
        step_no, ck = CK.restore(
            args.checkpoint_dir,
            template={"odom_state": state, "map_state": mstate})
        state, mstate, start_frame = (ck.odom_state, ck.map_state,
                                      ck.frame_index)
        for m in ck.trajectory:
            m44 = np.eye(4)
            m44[:3, :4] = m
            poses.append(m44)
        print(f"resumed from checkpoint step {step_no} "
              f"(frame {start_frame})")
        report["start_frame"] = start_frame
        if start_frame >= n:
            print(f"checkpoint already covers frame {start_frame} >= "
                  f"--frames {n}; nothing to do (pass a larger --frames "
                  "to extend the course)")
            report["frames"] = 0
            return report

    pool = ThreadPoolExecutor(max_workers=args.render_workers)
    depth = max(args.render_workers * 2, chunk + 2)
    futures = {i: pool.submit(make_frame, i)
               for i in range(start_frame, min(start_frame + depth, n))}

    def get_frame(i):
        out = futures.pop(i).result()
        j = i + depth
        if j < n:
            futures[j] = pool.submit(make_frame, j)
        return out

    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev,
                    slots=2 * chunk + 2)
    audit = SyncAudit(dev)
    ring_dropped = 0
    growth = []          # (frame, valid_slots, distinct_cells, loc_hits)
    engine_s = 0.0
    next_ck = start_frame + args.checkpoint_every
    cbuf, pending = [], []
    every = args.local_map_every

    def flush_poses():
        """The pending poses in one copy (a due point)."""
        if pending:
            mats, _ = fetch_poses(pending)
            poses.extend(mats)
            pending.clear()

    def step_frame(s, m, x, c, i):
        if imu_dev is not None:
            s = P.set_imu(s, imu_dev[i])
        s, m, pose, ne = combined_image_step(s, m, x, c, cfg, mcfg, step=i,
                                             local_map_every=every)
        pending.append((pose.q, pose.t, ne))
        return s, m

    t_start = time.perf_counter()
    t_compile = None
    try:
        with audit:
            for i in range(start_frame, n):
                img, counts, n_drop = get_frame(i)
                ring_dropped += int(n_drop)
                t0 = time.perf_counter()
                x, c = stager.put(img, counts)
                if chunk > 1:
                    cbuf.append((x, c, i))
                    if len(cbuf) == chunk:
                        i0 = cbuf[0][2]
                        # per-frame IMU orientations ride the scans (each
                        # frame must see its own, not the chunk's last)
                        qs = (imu_dev[i0:i0 + chunk] if imu_dev is not None
                              else None)
                        state, mstate, cps, cnes = \
                            chained_combined_image_step(
                                state, mstate,
                                torch.stack([b[0] for b in cbuf]),
                                torch.stack([b[1] for b in cbuf]), cfg,
                                mcfg, step0=i0, local_map_every=every,
                                imu_quats=qs)
                        pending.append((cps.q, cps.t, cnes))
                        cbuf.clear()
                        with audit.allowed():
                            flush_poses()
                    elif i == n - 1:
                        # the remainder: the per-frame step
                        for bx, bc, bi in cbuf:
                            state, mstate = step_frame(state, mstate, bx, bc,
                                                       bi)
                        cbuf.clear()
                        with audit.allowed():
                            flush_poses()
                else:
                    state, mstate = step_frame(state, mstate, x, c, i)
                    if (i + 1) % 50 == 0 or i == n - 1 or i == start_frame:
                        with audit.allowed():
                            flush_poses()
                dt0 = time.perf_counter() - t0
                if t_compile is None and len(poses) > start_frame:
                    t_compile = time.perf_counter() - t_start
                else:
                    engine_s += dt0  # engine time without the first dispatch
                if (args.checkpoint_dir is not None and not cbuf
                        and (i + 1) >= next_ck):
                    with audit.allowed():
                        flush_poses()
                        CK.save(args.checkpoint_dir, i + 1,
                                CK.EngineCheckpoint(
                                    state, mstate,
                                    np.stack(poses)[:, :3, :4], i + 1))
                    next_ck = i + 1 + args.checkpoint_every
                if (i + 1) % args.sample_every == 0 or i == n - 1:
                    with audit.allowed():
                        flush_poses()
                        p_t = (torch.tensor(poses[-1][:3, 3],
                                            dtype=torch.float32, device=dev)
                               if poses else torch.zeros(3, device=dev))
                        _, _, n_hits = G.get_local_map(
                            mstate, p_t, mcfg,
                            capacity=mcfg.local_map_capacity)
                        growth.append((i + 1, int(mstate.valid.sum()),
                                       G.count_cells(mstate), int(n_hits)))
                        overflow_now = int(mstate.overflow)
                    print(f"frame {i + 1:5d}: map leaves {growth[-1][1]:8d} "
                          f"({100.0 * growth[-1][1] / mcfg.map_capacity:4.1f}"
                          f"% load), cells {growth[-1][2]:4d}, local-map "
                          f"hits {growth[-1][3]:6d}, overflow {overflow_now}",
                          flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    wall = time.perf_counter() - t_start

    est = np.stack(poses)                        # (n, 4, 4)
    gt = np.stack([np.block([[rots[i], pos[i][:, None]],
                             [np.zeros((1, 3)), np.ones((1, 1))]])
                   for i in range(n)])
    errs = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(errs ** 2)))
    t1, r1 = rpe(est[:, :3, :4], gt[:, :3, :4], delta=1)
    drift_pct = None
    if n > 100:
        t100, r100 = rpe(est[:, :3, :4], gt[:, :3, :4], delta=100)
        dist100 = np.linalg.norm(gt[100:, :3, 3] - gt[:-100, :3, 3], axis=1)
        rel = np.linalg.norm((est[100:, :3, 3] - est[:-100, :3, 3])
                             - (gt[100:, :3, 3] - gt[:-100, :3, 3]), axis=1)
        drift_pct = float(100.0 * np.mean(rel / np.maximum(dist100, 1e-9)))

    map_overflow = int(mstate.overflow)
    # truncation gate over every sample, not just the last: a mid-course
    # density peak must not pass silently
    loc_trunc = max((max(g[3] - mcfg.local_map_capacity, 0)
                     for g in growth), default=0)
    course_m = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                           axis=1)))
    done = n - start_frame
    print(f"\nlong course: {n} frames ({done} this run), {course_m:.0f} m, "
          f"wall {wall:.0f} s = {done / wall:.1f} scans/s end-to-end "
          f"({done / max(engine_s, 1e-9):.1f} scans/s engine-only; "
          f"first dispatch {t_compile or 0:.1f} s)")
    print(f"ATE {ate:.3f} m; RPE@1 {t1:.4f} m / {np.degrees(r1):.4f} deg"
          + (f"; RPE@100 {t100:.2f} m, drift {drift_pct:.2f} %"
             if drift_pct is not None else ""))
    print(f"map: {growth[-1][1]} leaves "
          f"({100.0 * growth[-1][1] / mcfg.map_capacity:.1f}% load), "
          f"{growth[-1][2]} cells; overflow {map_overflow}; ring drops "
          f"{ring_dropped}; local-map truncation {loc_trunc}")
    syncs = audit.count + stager.waits
    print(f"host syncs between due points: {syncs}"
          + (f" (first: {audit.first})" if audit.first else ""))
    if args.results_dir:
        st = Stats()
        for m in est:
            st.add_pose(m)
        st.write_results(args.results_dir)
    # the gate: no uncounted loss
    ok = map_overflow == 0 and loc_trunc == 0
    report.update(
        rc=0 if ok else 1, frames=n, start_frame=start_frame,
        course_m=round(course_m, 1), ate_m=round(ate, 4),
        rpe1_m=round(float(t1), 5), rpe1_deg=float(np.degrees(r1)),
        drift_pct=None if drift_pct is None else round(drift_pct, 3),
        scans_per_s=round(done / wall, 2),
        engine_scans_per_s=round(done / max(engine_s, 1e-9), 2),
        first_dispatch_s=t_compile,
        map_leaves=growth[-1][1], map_cells=growth[-1][2],
        map_load_pct=round(100.0 * growth[-1][1] / mcfg.map_capacity, 2),
        map_overflow=map_overflow, ring_dropped=ring_dropped,
        local_map_truncation=loc_trunc, growth=growth, host_syncs=syncs,
        stager_waits=stager.waits)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
