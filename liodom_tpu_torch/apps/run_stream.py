"""Paced live-stream deployment, the reference's runtime shape (port of
``apps/run_stream.py``).

The reference is a long-lived node fed by an asynchronous sensor callback
through queues: the ROS spinner enqueues scans (liodom_node.cc:40-55,
subscriber queue size 1 at :98-103: late frames are dropped, the newest
kept), worker threads drain them (feature_extractor.cc:42-82,
laser_odometry.cc:100-272), a second mapper process feeds back a local map
on a latched topic (liodom_mapping_node.cc:81-87 -> liodom_node.cc:57-64),
and a watchdog warns when output falls below 0.8x the input rate
(laser_odometry.cc:253-256).  The app runs that shape on the host runtime
(``runtime/channels.py``):

* a SENSOR thread replays pre-rendered (in threads), pre-split scans at
  wall-clock ``--rate`` Hz into a bounded :class:`Channel` with
  ``offer_latest``
  drop-oldest semantics (``--queue-size`` defaults to the reference's 1);
* the ENGINE (main thread) drains the channel, stages each frame onto the
  card from pinned buffers, runs ``image_step``, fetches the pose (the live
  pose-out, a due point each frame), publishes it through
  :class:`OdomPublisher` and ticks the :class:`FrequencyMonitor` watchdog;
* with ``--mapping``, a MAPPER thread mirrors the second process: it takes
  solved (edges, pose) frames from a second channel, folds them into the
  hash-grid map (``MappingService``: the probe kernel) and publishes the
  local map around the latest pose (K7) into a :class:`LatestValue` slot
  that the engine merges before its next solve (laser_odometry.cc:310-314).
  Both threads launch on the default stream, so K7 never runs on two
  streams at once; the mapper's read of its truncation count is a due
  point of the mapper, counted apart from the engine's synchronisations.

Every lossy event is counted: channel drops, mapper-channel drops, map
overflow, local-map truncation.  The step is warmed (kernels built, loaded
and launched once) before the sensor thread starts.

Usage:
    python -m liodom_tpu_torch.apps.run_stream --frames 100 --rate 10
    python -m liodom_tpu_torch.apps.run_stream --frames 60 --rate 200 \
        --mapping                                   # overload
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from liodom_tpu_torch.runtime.cache import enable_persistent_cache

enable_persistent_cache()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--root", default=None,
                    help="KITTI odometry root: replay a real sequence "
                    "instead of the synthetic world (the reference's "
                    "rosbag-replay deployment, launch/liodom.launch:7)")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="sensor rate, Hz (KITTI Velodyne is 10)")
    ap.add_argument("--queue-size", type=int, default=1,
                    help="sensor channel capacity (liodom_node.cc:98 uses "
                    "1: drop-oldest under lag)")
    ap.add_argument("--world", choices=["box", "stream"], default="stream")
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--speed", type=float, default=1.2, help="m/frame")
    ap.add_argument("--yaw-rate", type=float, default=0.004)
    ap.add_argument("--ring-width", type=int, default=4096)
    ap.add_argument("--local-map-size", type=int, default=5)
    ap.add_argument("--mapping", action="store_true",
                    help="run the mapper thread + adaptive local-map "
                    "feedback (the reference's second process)")
    ap.add_argument("--local-map-every", type=int, default=4,
                    help="mapper publish cadence in processed frames")
    ap.add_argument("--map-capacity", type=int, default=524288)
    ap.add_argument("--local-map-capacity", type=int, default=32768)
    ap.add_argument("--engine-delay", type=float, default=0.0,
                    help="artificial per-frame engine delay, s (test "
                    "hook: induces lag so drops/watchdog can be exercised "
                    "deterministically)")
    ap.add_argument("--json", action="store_true",
                    help="accepted for the JAX app's flags: the report is "
                    "always the last line")
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
    from liodom_tpu_torch.core.pose import Pose
    from liodom_tpu_torch.core.synth import (BoxWorld, StreamWorld,
                                             drive_trajectory, yaw_matrix)
    from liodom_tpu_torch.mapping.service import MappingService
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import native
    from liodom_tpu_torch.runtime.channels import (Channel, Closed,
                                                   FrequencyMonitor,
                                                   LatestValue)
    from liodom_tpu_torch.runtime.device_io import (Stager, SyncAudit,
                                                    device_name,
                                                    path_kernels,
                                                    prepare_kernels)
    from liodom_tpu_torch.runtime import tracer
    from liodom_tpu_torch.runtime.publisher import OdomPublisher

    dev = resolve_device(args.device)
    cfg = LiodomConfig(local_map_size=args.local_map_size,
                       ring_width=args.ring_width, mapping=args.mapping)
    mcfg = MapConfig(local_map_capacity=args.local_map_capacity,
                     map_capacity=args.map_capacity)

    # Pre-render/pre-load + pre-split so the sensor thread's pacing is
    # honest wall clock (rendering/disk is the simulator's cost, not the
    # sensor's).
    scans = []
    gt_pos = None
    if args.root:
        from liodom_tpu_torch.core.io import KittiSequence
        seq = KittiSequence(args.root, args.seq)
        for i, item in enumerate(seq.iter_images(
                cfg.scan_lines, cfg.ring_width, cfg.min_range,
                cfg.max_range)):
            if i >= args.frames:
                break
            scans.append(item)
        args.frames = len(scans)
        gt = seq.gt_velo()
        if gt is not None:
            gt_pos = gt[:args.frames, :3, 3]
    else:
        pos, yaws = drive_trajectory(args.frames, speed=args.speed,
                                     yaw_rate=args.yaw_rate)
        if args.world == "stream":
            world = StreamWorld(seed=0)
            world.set_keepout(pos[:, :2])
        else:
            world = BoxWorld(seed=0)
        gt_pos = pos

        def make_frame(i):
            r = world.render(pos[i], yaw_matrix(yaws[i]), width=args.width,
                             noise=args.noise, seed=100 + i)
            return native.split_velodyne_np(
                r.astype(np.float32), cfg.scan_lines, cfg.ring_width,
                cfg.min_range, cfg.max_range)

        # the renders in threads (the world is shared, its tile cache
        # locked); the frames are the same, in order
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as pool:
            scans = list(pool.map(make_frame, range(args.frames)))
    ring_dropped = sum(int(s[2]) for s in scans)

    report = {"app": "run_stream", "rc": 0, "device": device_name(dev),
              "mapping": args.mapping, "rate_hz": args.rate,
              "queue_size": args.queue_size}
    report.update(prepare_kernels(path_kernels(args.mapping), dev))

    sensor_ch: Channel = Channel(maxsize=args.queue_size)
    mapper_ch: Channel = Channel(maxsize=8)
    local_map_slot: LatestValue = LatestValue()
    freq = FrequencyMonitor()
    audit = SyncAudit(dev)
    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev,
                    slots=args.queue_size + 3)
    warn_count = 0

    def sensor():
        """The ROS spinner: fixed-rate ingest, drop-oldest when full."""
        period = 1.0 / args.rate
        t_next = time.monotonic()
        for i in range(args.frames):
            t_next += period
            dt = t_next - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            freq.tick_input()
            sensor_ch.offer_latest((i, scans[i][0], scans[i][1]))
        sensor_ch.close()

    mapper_state = {"overflow": 0, "processed": 0, "loc_trunc": 0}

    def mapper():
        """The second process (liodom_mapping_node.cc:45-90): consume
        solved frames, update the map, publish back the local map."""
        svc = MappingService(mcfg, device=dev)
        identity = Pose.identity(svc.state.xyz.dtype, device=dev)
        k = 0
        while True:
            try:
                wxyz, wvalid, p_t = mapper_ch.pop(timeout=2.0)
            except Closed:
                break            # engine closed the channel and it drained
            except TimeoutError:
                continue         # idle gap (slow sensor) — keep serving
            svc.update(wxyz, wvalid, identity)   # edges pre-transformed
            k += 1
            mapper_state["processed"] = k
            if k % max(args.local_map_every, 1) == 0:
                with audit.allowed():    # the truncation count, read back
                    lx, lv, ovf = svc.local_map_with_overflow(p_t)
                mapper_state["loc_trunc"] += ovf
                local_map_slot.set((lx, lv))
        with audit.allowed():
            mapper_state["overflow"] = int(svc.state.overflow)

    state = P.init_state(
        cfg, received_capacity=mcfg.local_map_capacity if args.mapping
        else 0, device=dev)
    pub = OdomPublisher(fixed_frame=cfg.fixed_frame,
                        base_frame=cfg.base_frame,
                        publish_tf=cfg.publish_tf)

    # warm the step (its kernels launched once, the allocator filled) and
    # the pose fetch before the clock starts; the node also subscribes only
    # once construction finished.  The state is left as it was.
    t0 = time.perf_counter()
    _, p0, _ = P.image_step(state, *stager.put(scans[0][0], scans[0][1]),
                            cfg)
    p0.matrix().cpu()
    report["warm_s"] = time.perf_counter() - t0

    threads = [threading.Thread(target=sensor, name="sensor", daemon=True)]
    if args.mapping:
        threads.append(threading.Thread(target=mapper, name="mapper",
                                        daemon=True))
    processed, poses, frame_ids, step_ms = 0, [], [], []
    k_win = cfg.local_map_size
    with audit:
        for t in threads:
            t.start()
        t_start = time.monotonic()
        while True:
            try:
                i, img, counts = sensor_ch.pop(timeout=2.0 + 2.0 / args.rate)
            except (Closed, TimeoutError):
                break
            t_f = time.monotonic()
            if args.mapping:
                fresh = local_map_slot.take()
                if fresh is not None:
                    state = P.set_received_map(state, fresh[0], fresh[1])
            state, pose, _ = P.image_step(state, *stager.put(img, counts),
                                          cfg)
            with audit.allowed(), tracer.span("fetch"):
                # blocking: the live pose-out
                with tracer.span("fetch.copy", device=True):
                    mat = pose.matrix().cpu().numpy().astype(np.float64)
                tracer.anchor()
            if args.engine_delay:
                time.sleep(args.engine_delay)
            if args.mapping:
                # the frame just pushed, picked on the card (no host read
                # of the window pointer)
                slot = ((state.window.next_slot - 1) % k_win).reshape(1)
                mapper_ch.offer_latest((
                    state.window.xyz.index_select(0, slot)[0],
                    state.window.valid.index_select(0, slot)[0], pose.t))
            pub.publish(mat, stamp=time.monotonic() - t_start)
            if freq.tick_output() is not None:
                warn_count += 1
            poses.append(mat)
            frame_ids.append(i)
            step_ms.append((time.monotonic() - t_f) * 1e3)
            processed += 1
        wall = time.monotonic() - t_start
        if args.mapping:
            mapper_ch.close()
            threads[1].join(timeout=30.0)
            if threads[1].is_alive():
                raise RuntimeError("the mapper thread did not finish")

    # --- accounting: every frame is processed, queued or counted dropped
    drops = sensor_ch.dropped
    leftover = len(sensor_ch)
    if gt_pos is not None and processed:
        errs = [np.linalg.norm(poses[k][:3, 3] - gt_pos[frame_ids[k]])
                for k in range(processed)]
        ate = float(np.sqrt(np.mean(np.square(errs))))
    else:
        ate = float("nan")
    print(f"stream: {args.frames} frames at {args.rate:.0f} Hz -> "
          f"{processed} processed, {drops} dropped (queue={args.queue_size},"
          f" drop-oldest), {leftover} left; wall {wall:.1f} s")
    print(f"watchdog warnings: {warn_count} "
          f"(in {freq.input_hz():.1f} Hz, out {freq.output_hz():.1f} Hz)")
    if step_ms:
        print(f"engine step ms: median {np.median(step_ms):.0f}, "
              f"max {max(step_ms):.0f}")
    print(f"ATE over processed frames: {ate:.3f} m")
    if ring_dropped:
        print(f"WARNING: {ring_dropped} points dropped by the "
              f"ring_width={cfg.ring_width} clamp")
    if args.mapping:
        print(f"mapper: {mapper_state['processed']} frames folded, "
              f"{mapper_ch.dropped} frames dropped at the mapper channel, "
              f"map overflow {mapper_state['overflow']}, local-map "
              f"truncation {mapper_state['loc_trunc']}")
    syncs = audit.count + stager.waits
    print(f"host syncs between due points: {syncs}"
          + (f" (first: {audit.first})" if audit.first else ""))
    accounted = processed + drops + leftover
    report.update(
        frames=args.frames, processed=processed, dropped=drops,
        leftover=leftover, accounted=accounted, warn_count=warn_count,
        input_hz=round(freq.input_hz(), 2),
        output_hz=round(freq.output_hz(), 2),
        ate_m=None if np.isnan(ate) else round(ate, 4),
        mapper_processed=mapper_state["processed"],
        mapper_dropped=mapper_ch.dropped,
        map_overflow=mapper_state["overflow"],
        local_map_truncation=mapper_state["loc_trunc"],
        step_ms_median=float(np.median(step_ms)) if step_ms else None,
        step_ms_max=float(max(step_ms)) if step_ms else None,
        wall_s=wall, ring_dropped=ring_dropped, host_syncs=syncs,
        host_syncs_by_thread=audit.by_thread, due_point_syncs=audit.due,
        stager_waits=stager.waits,
        rc=0 if accounted == args.frames else 1)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
