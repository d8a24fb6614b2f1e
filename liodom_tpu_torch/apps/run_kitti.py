"""Run the engine on a KITTI odometry sequence (port of ``apps/run_kitti.py``).

The equivalent of ``roslaunch liodom liodom.launch`` + a KITTI rosbag
(launch/liodom.launch:11-36): streams ``.bin`` scans through the port's
step (the native prefetcher splits the rings in its threads, the frames
are staged onto the card from pinned buffers), writes the reference's five
results files (stats.cc:73-132), and — when ground truth is present —
scores ATE/RPE in the velodyne frame.

Usage:
    python -m liodom_tpu_torch.apps.run_kitti --root /data/kitti --seq 00
    python -m liodom_tpu_torch.apps.run_kitti --root ... --seq 08 --mapping \
        --frames 500 --chunk 12
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
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--local-map-size", type=int, default=15,
                    help="prev_frames (launch/liodom.launch:23 uses 15)")
    ap.add_argument("--mapping", action="store_true",
                    help="adaptive local mapping feedback loop")
    ap.add_argument("--local-map-every", type=int, default=1,
                    help="refresh the received local map every Nth frame "
                    "(the reference mapper is an async second process; the "
                    "odometer consumes the LAST received map, "
                    "laser_odometry.cc:276-279)")
    ap.add_argument("--filter-local-map", action="store_true")
    ap.add_argument("--local-map-capacity", type=int, default=65536,
                    help="received-local-map buffer rows (fixed-shape "
                    "deployment sizing; truncation is counted and warned)")
    ap.add_argument("--scan-lines", type=int, default=64)
    ap.add_argument("--ring-width", type=int, default=0,
                    help="padded points per ring; 0 (default) auto-sizes "
                    "from the first scan so no routed point is ever dropped "
                    "(the reference's ring vectors are unbounded, "
                    "feature_extractor.cc:153-156)")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per dispatch (chained_image_step; pose "
                    "latency = one chunk). Remainder frames take the "
                    "per-frame step")
    ap.add_argument("--sync-every", type=int, default=50,
                    help="host sync cadence (frames); poses are fetched in "
                    "blocks to amortize device round-trips")
    ap.add_argument("--time-every", type=int, default=25,
                    help="sample true per-frame device latency every Nth "
                    "frame with a blocking pose fetch; laser_odom_times.txt "
                    "rows carry the last sample (see runtime/stats.py)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write a resumable checkpoint every "
                    "--checkpoint-every frames; resumes automatically when "
                    "one exists")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--export-viz", default=None,
                    help="directory for PLY exports (trajectory; per-frame "
                    "debug dumps every --viz-every frames)")
    ap.add_argument("--viz-every", type=int, default=0)
    ap.add_argument("--aot", action="store_true",
                    help="warm start: build the kernels and capture the "
                    "step as a CUDA graph before frame 0, one graph a "
                    "local-map refresh pattern (runtime/aot.py); the chunk "
                    "mode's remainder frames take the eager step")
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (cpu runs the "
                    "kernels' plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record the program's spans and counters "
                    "(runtime/tracer) and write them to FILE at exit as a "
                    "Chrome trace")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the app; returns its report (``rc`` is the exit code).  With
    ``--trace-out`` the span recorder is armed for the whole run and its
    record written at the end (``trace_out`` in the report)."""
    args = parse_args(argv)
    if not args.trace_out:
        return _run(args)
    from liodom_tpu_torch.runtime import tracer
    with tracer.exported(args.trace_out, args.device):
        report = _run(args)
    report["trace_out"] = args.trace_out
    return report


def _run(args: argparse.Namespace) -> dict:
    import torch

    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.core.device import resolve_device
    from liodom_tpu_torch.core.io import KittiSequence
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import checkpoint as CK
    from liodom_tpu_torch.runtime import native
    from liodom_tpu_torch.runtime.channels import FrequencyMonitor
    from liodom_tpu_torch.runtime.device_io import (Stager, SyncAudit,
                                                    staging_slots,
                                                    device_name, fetch_poses,
                                                    path_kernels,
                                                    prepare_kernels,
                                                    prepare_loader)
    from liodom_tpu_torch.runtime.publisher import OdomPublisher
    from liodom_tpu_torch.runtime.stats import Stats, ate_rmse, rpe

    dev = resolve_device(args.device)
    seq = KittiSequence(args.root, args.seq)
    loader = prepare_loader()
    ring_width = args.ring_width
    if ring_width <= 0:
        # auto-size from the first scan: max points routed to any ring,
        # rounded up to a lane multiple — zero drops by construction (and
        # re-checked per frame below, since later scans can be denser)
        probe = np.ascontiguousarray(seq.scan(0).astype(np.float32))
        _, counts0, _ = native.split_velodyne_np(
            probe, args.scan_lines, 16384, 3.0, 75.0)
        ring_width = max(512, int(-(-int(counts0.max()) * 1.25 // 256)) * 256)
        print(f"ring_width auto-sized to {ring_width} "
              f"(first scan max ring occupancy {int(counts0.max())})")
    cfg = LiodomConfig(local_map_size=args.local_map_size,
                       scan_lines=args.scan_lines,
                       ring_width=ring_width,
                       filter_local_map=args.filter_local_map,
                       mapping=args.mapping)
    n = len(seq) if args.frames is None else min(args.frames, len(seq))
    print(f"sequence {args.seq}: {n} scans, mapping={args.mapping}, "
          f"device={device_name(dev)}")

    chunk = max(args.chunk, 1)
    mstate = mcfg = None
    if args.mapping:
        from liodom_tpu_torch.mapping.service import (
            chained_combined_image_step, combined_image_step, init_combined)
        mcfg = MapConfig(voxel_xysize=40.0, voxel_zsize=50.0, resolution=0.4,
                         cells_xy=3, cells_z=2,  # launch/liodom.launch:46-52
                         local_map_capacity=args.local_map_capacity)
        state, mstate = init_combined(cfg, mcfg, device=dev)
    else:
        state = P.init_state(cfg, device=dev)

    def step_frame(s, m, x, c, i):
        # the frame index is a host int: the refresh cadence branches on it
        if args.mapping:
            return combined_image_step(s, m, x, c, cfg, mcfg, step=i,
                                       local_map_every=args.local_map_every)
        s, pose, ne = P.image_step(s, x, c, cfg)
        return s, m, pose, ne

    def step_chunk(s, m, xs, cs, i0):
        if args.mapping:
            return chained_combined_image_step(
                s, m, xs, cs, cfg, mcfg, step0=i0,
                local_map_every=args.local_map_every)
        s, poses_, nes = P.chained_image_step(s, xs, cs, cfg)
        return s, m, poses_, nes

    report = {"app": "run_kitti", "rc": 0, "device": device_name(dev),
              "mapping": args.mapping, "chunk": chunk,
              "ring_width": cfg.ring_width, **loader}
    report.update(prepare_kernels(path_kernels(args.mapping), dev))

    stats = Stats()
    freq = FrequencyMonitor()
    pub = OdomPublisher(fixed_frame=cfg.fixed_frame,
                        base_frame=cfg.base_frame,
                        publish_tf=cfg.publish_tf)
    poses, pending = [], []
    sensor_dt = 0.1 if seq.times is None else float(np.median(
        np.diff(seq.times))) if len(seq) > 1 else 0.1

    # resume from the latest checkpoint if one exists
    start_frame = 0
    if args.checkpoint_dir and CK.latest_step(args.checkpoint_dir) is not None:
        step, ck = CK.restore(args.checkpoint_dir,
                              template={"odom_state": state,
                                        "map_state": mstate})
        state, start_frame = ck.odom_state, ck.frame_index
        if args.mapping and ck.map_state is not None:
            mstate = ck.map_state
        for m in ck.trajectory:
            m44 = np.eye(4)
            m44[:3, :4] = m
            poses.append(m44)
            stats.add_pose(m44)
        print(f"resumed from checkpoint step {step} (frame {start_frame})")
        report["start_frame"] = start_frame
        if start_frame >= n:
            print(f"checkpoint already covers frame {start_frame} >= "
                  f"--frames {n}; nothing to do (pass a larger --frames "
                  "to extend the run)")
            report["frames"] = 0
            return report

    if args.aot:
        step_frame, step_chunk, captured = _captured_steps(
            args, cfg, mcfg, state, mstate, dev, chunk, start_frame, n,
            step_frame, step_chunk)
        report.update(captured)

    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev,
                    slots=staging_slots(
                        chunk, (args.time_every, args.sync_every), args.aot))
    audit = SyncAudit(dev)
    ring_dropped = 0          # points lost to the ring_width clamp (loader)
    last_odom_ms = float("nan")   # latest sampled device latency
    last_t = None             # the latest dispatched pose's translation
    t_compile = None          # the first dispatch (frame or chunk) ...
    n_first = 1               # ... and its frames, out of the throughput
    cbuf = []                 # staged frames awaiting a chained dispatch
    next_ck = start_frame + args.checkpoint_every
    next_timed = start_frame  # chunk-mode latency-sample schedule (chunk
    # boundaries rarely align with (i % time_every == 0), so sample on the
    # first flush AT/after each due point instead)
    scan_iter = seq.iter_images(cfg.scan_lines, cfg.ring_width,
                                cfg.min_range, cfg.max_range)
    t_start = time.perf_counter()
    with audit:
        for i, (img, counts, n_drop) in enumerate(scan_iter):
            if i < start_frame:
                continue
            if i >= n:
                break
            if n_drop and not ring_dropped:
                print(f"WARNING: frame {i}: {n_drop} points dropped by the "
                      f"ring_width={cfg.ring_width} clamp — raise "
                      "--ring-width (the reference never drops; counting "
                      "continues)")
            ring_dropped += n_drop
            freq.tick_input(t=i * sensor_dt)
            t0 = time.perf_counter()
            # End-to-end frame latency pairing (stats.cc:55-71): start at
            # ingest, stop when the pose is fetched back to the host.
            stats.start_frame(t0)
            x, c = stager.put(img, counts)
            # Feature prep as seen by the consumer: loader dequeue + staging
            # onto the card.  The split itself runs in native prefetch
            # threads and K1/K2 inside the step (runtime/stats.py notes).
            stats.add_feature_extraction_time(
                (time.perf_counter() - t0) * 1e3)
            if chunk == 1:
                timed = args.time_every > 0 and \
                    (i - start_frame) % args.time_every == 0
                state, mstate, pose, ne = step_frame(state, mstate, x, c, i)
                pending.append((pose.q, pose.t, ne))
                last_t = pose.t
                flushed = True
                t_c, n_flush = t0, 1
                if args.time_every <= 0:
                    last_odom_ms = (time.perf_counter() - t0) * 1e3  # enqueue
            else:
                # chained mode: accumulate K frames, one chained call per
                # chunk; the remainder tail takes the per-frame step
                cbuf.append((x, c, i))
                flushed = len(cbuf) == chunk or i == n - 1
                timed = args.time_every > 0 and flushed and i >= next_timed
                if flushed:
                    t_c, n_flush = time.perf_counter(), len(cbuf)
                    if len(cbuf) == chunk:
                        state, mstate, cposes, cnes = step_chunk(
                            state, mstate, torch.stack([b[0] for b in cbuf]),
                            torch.stack([b[1] for b in cbuf]), cbuf[0][2])
                        pending.append((cposes.q, cposes.t, cnes))
                        last_t = cposes.t[-1]
                    else:
                        for bx, bc, bi in cbuf:
                            state, mstate, p_, ne_ = step_frame(
                                state, mstate, bx, bc, bi)
                            pending.append((p_.q, p_.t, ne_))
                            last_t = p_.t
                    cbuf.clear()
                # chained mode blocks at every flush without a sampling
                # cadence, as the JAX app does
                timed = timed or (flushed and args.time_every <= 0)
            ck_due = (args.checkpoint_dir is not None and flushed
                      and (i + 1) >= next_ck)
            if (timed or (i + 1) % args.sync_every == 0 or i == n - 1
                    or ck_due or (flushed and t_compile is None)):
                with audit.allowed():
                    # one copy for the whole block; a timed frame's pose is
                    # in it, so the copy blocks on that frame (the TRUE
                    # ingest->pose latency; all earlier dispatches have
                    # completed — in-order execution)
                    mats, nes = (fetch_poses(pending) if pending
                                 else (np.zeros((0, 4, 4)), []))
                    if timed:
                        last_odom_ms = ((time.perf_counter() - t_c) * 1e3
                                        / n_flush)
                        next_timed = i + args.time_every
                    for mat, ne_i in zip(mats, nes):
                        stats.add_pose(mat)
                        stats.add_num_feats(int(ne_i))
                        poses.append(mat)
                        pub.publish(mat, stamp=len(poses) * sensor_dt)
                        stats.stop_frame(time.perf_counter())
                    pending.clear()
                    dt = time.perf_counter() - t0
                    if t_compile is None and flushed:
                        t_compile, n_first = dt, n_flush
                    if ck_due:
                        CK.save(args.checkpoint_dir, i + 1,
                                CK.EngineCheckpoint(
                                    state, mstate, np.stack(poses)[:, :3, :4],
                                    i + 1))
                        next_ck = i + 1 + args.checkpoint_every
                    if (args.export_viz and args.viz_every
                            and (i + 1) % args.viz_every == 0):
                        from liodom_tpu_torch.runtime.viz import \
                            export_frame_debug
                        export_frame_debug(args.export_viz, i)
            stats.add_laser_odometry_time(
                last_odom_ms, measured=timed or args.time_every <= 0)
            freq.tick_output(t=i * sensor_dt
                             + (time.perf_counter() - t_start))

    wall = time.perf_counter() - t_start - (t_compile or 0.0)
    # throughput over the frames THIS run processed (a resumed run only
    # executes n - start_frame of them) after the first dispatch: the first
    # launches load the kernels and fill the allocator's cache
    done = max(n - start_frame - n_first, 1)
    rate = done / max(wall, 1e-9)
    print(f"first {'chunk' if n_first > 1 else 'frame'}: "
          f"{t_compile or 0.0:.3f} s; {done} frames in {wall:.2f} s = "
          f"{rate:.1f} scans/s (sensor rate {1.0 / sensor_dt:.0f} Hz)")
    syncs = audit.count + stager.waits
    print(f"host syncs between due points: {syncs}"
          + (f" (first: {audit.first})" if audit.first else ""))
    report.update(frames=n - start_frame, start_frame=start_frame,
                  first_frame_s=t_compile, first_dispatch_frames=n_first,
                  scans_per_s=rate,
                  host_syncs=syncs, stager_waits=stager.waits,
                  ring_dropped=int(ring_dropped))

    # No silent caps: every lossy truncation in the run gets reported.
    if ring_dropped:
        print(f"WARNING: {ring_dropped} points total dropped by the "
              f"ring_width={cfg.ring_width} clamp (raise --ring-width)")
    if args.mapping:
        from liodom_tpu_torch.mapping.grid import get_local_map
        map_ovf = int(mstate.overflow)
        if map_ovf:
            print(f"WARNING: {map_ovf} map points dropped at "
                  f"map_capacity={mcfg.map_capacity} (raise it)")
        _, _, n_hits = get_local_map(mstate, last_t, mcfg,
                                     capacity=mcfg.local_map_capacity)
        loc_ovf = max(int(n_hits) - mcfg.local_map_capacity, 0)
        if loc_ovf:
            print(f"WARNING: local map truncated by {loc_ovf} points at the "
                  f"final pose (raise MapConfig.local_map_capacity)")
        report.update(map_overflow=map_ovf, local_map_hits=int(n_hits),
                      local_map_truncated=loc_ovf,
                      occupied_slots=int(mstate.valid.sum()))

    est = np.stack(poses)[:, :3, :4]
    if args.results_dir:
        stats.write_results(args.results_dir)
        print(f"results in {args.results_dir}")
    if args.export_viz:
        from liodom_tpu_torch.runtime.viz import save_trajectory_ply
        save_trajectory_ply(
            os.path.join(args.export_viz, "trajectory.ply"), est)
        print(f"viz in {args.export_viz}")

    gt = seq.gt_velo()
    if gt is not None:
        gt = gt[:n, :3, :4]
        ate = ate_rmse(est, gt)
        print(f"ATE (rmse, unaligned): {ate:.3f} m")
        t_err, r_err = rpe(est, gt, delta=1)
        print(f"RPE @1 frame: {t_err:.4f} m, {np.degrees(r_err):.4f} deg")
        if len(est) > 100:
            t_err, r_err = rpe(est, gt, delta=100)
            print(f"RPE @100 frames: {t_err:.3f} m, "
                  f"{np.degrees(r_err):.3f} deg")
        report["ate_m"] = ate
    return report


def _captured_steps(args, cfg, mcfg, state, mstate, dev, chunk: int,
                    start_frame: int, n: int, step_frame, step_chunk):
    """``--aot``: the step captured before frame 0 (``runtime/aot.py``),
    one graph for each local-map refresh pattern the run meets — the
    per-frame step's refresh or not, each full chunk's pattern from its
    first frame's index modulo the cadence; the remainder frames of the
    chunk mode keep the eager ``step_frame``, as the JAX app's do.
    Returns (step_frame, step_chunk, {"aot_capture_s", "graphs"})."""
    import torch

    from liodom_tpu_torch.mapping.service import (
        chained_combined_image_step, combined_image_step)
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import aot

    t0 = time.perf_counter()
    every = max(args.local_map_every, 1)
    img = torch.zeros((cfg.scan_lines, cfg.ring_width, 3),
                      dtype=torch.float32, device=dev)
    cnt = torch.zeros((cfg.scan_lines,), dtype=torch.int32, device=dev)
    head = (state, mstate) if args.mapping else (state,)
    graphs = {}
    if chunk == 1:
        for refresh in ((True, False) if args.mapping and every > 1
                        else (True,)):
            if args.mapping:
                def fn(s, m, x, c, i=0 if refresh else 1):
                    return combined_image_step(s, m, x, c, cfg, mcfg, step=i,
                                               local_map_every=every)
            else:
                def fn(s, x, c):
                    return P.image_step(s, x, c, cfg)
            graphs[refresh] = aot.get_or_compile(
                "kitti_combined" if args.mapping else "kitti_image_step", fn,
                head + (img, cnt), extra=f"{cfg}|{mcfg}|every={every}"
                f"|refresh={refresh}")

        def captured_frame(s, m, x, c, i):
            g = graphs[every == 1 or i % every == 0]
            if args.mapping:
                return g(s, m, x, c)
            s, pose, ne = g(s, x, c)
            return s, m, pose, ne
        step_frame = captured_frame
    else:
        imgs = torch.stack([img] * chunk)
        cnts = torch.stack([cnt] * chunk)
        phases = ({i0 % every for i0 in range(start_frame, n - chunk + 1,
                                               chunk)}
                  if args.mapping else {0})
        for phase in sorted(phases):
            if args.mapping:
                def fn(s, m, xs, cs, i0=phase):
                    return chained_combined_image_step(
                        s, m, xs, cs, cfg, mcfg, step0=i0,
                        local_map_every=every)
            else:
                def fn(s, xs, cs):
                    return P.chained_image_step(s, xs, cs, cfg)
            graphs[phase] = aot.get_or_compile(
                "kitti_combined_chunk" if args.mapping
                else "kitti_image_chunk", fn, head + (imgs, cnts),
                extra=f"{cfg}|{mcfg}|every={every}|chunk={chunk}"
                f"|phase={phase}")

        def captured_chunk(s, m, xs, cs, i0):
            g = graphs[i0 % every if args.mapping else 0]
            if args.mapping:
                return g(s, m, xs, cs)
            s, poses, nes = g(s, xs, cs)
            return s, m, poses, nes
        step_chunk = captured_chunk
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"aot_capture_s": time.perf_counter() - t0, "graphs": len(graphs)}
    print(f"aot: {len(graphs)} step(s) captured in {out['aot_capture_s']:.2f}"
          f" s")
    return step_frame, step_chunk, out


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
