"""Run the engine on Ouster-style row-organized clouds (port of
``apps/run_ouster.py``).

The equivalent of ``roslaunch liodom liodom_ouster.launch``
(launch/liodom_ouster.launch:19-33: ``lidar_type=1``, clouds from
``/os_cloud_node/points`` whose row index IS the ring,
feature_extractor.cc:158-175), with the production surface of run_kitti:
loader-split ingest in prefetch threads (the row split is the loader's job,
runtime.native.split_ouster_np, held bit for bit to the device's
split_scan_ouster), ``--chunk`` chained dispatch, checkpoint/resume,
``--time-every`` sampled true latency, and counted ring-clamp drops.

Input: a directory of ``.npy`` files, each an (rings, width, 3) float32
organized cloud (NaN rows for missing returns), or ``--synthetic`` to
generate the JAX app's scene: the HDL-64 spin of ``BoxWorld`` at 1 cm
sensor noise, reshaped to its 64 rows.

Usage:
    python -m liodom_tpu_torch.apps.run_ouster --dir /data/ouster_npy
    python -m liodom_tpu_torch.apps.run_ouster --synthetic --frames 30 \
        --chunk 10
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from liodom_tpu_torch.runtime.cache import enable_persistent_cache

enable_persistent_cache()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help="directory of (rings, width, 3) .npy organized "
                    "clouds")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=1024,
                    help="columns per ring for --synthetic renders")
    ap.add_argument("--ring-width", type=int, default=0,
                    help="padded points per ring; 0 auto-sizes from the "
                    "organized width (rows never exceed it)")
    ap.add_argument("--local-map-size", type=int, default=15)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per dispatch (chained_image_step; "
                    "remainder takes the per-frame step)")
    ap.add_argument("--time-every", type=int, default=25,
                    help="sample true per-frame device latency every Nth "
                    "frame with a blocking pose fetch")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--aot", action="store_true",
                    help="warm start: build the kernels and capture the "
                    "step as a CUDA graph before frame 0 "
                    "(runtime/aot.py); the chunk mode's remainder frames "
                    "take the eager step")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="load+split worker threads")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless given (cpu runs the "
                    "kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the app; returns its report (``rc`` is the exit code)."""
    args = parse_args(argv)

    import torch

    from liodom_tpu_torch.core.device import resolve_device
    from liodom_tpu_torch.core.presets import ouster_preset
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import checkpoint as CK
    from liodom_tpu_torch.runtime.channels import FrequencyMonitor
    from liodom_tpu_torch.runtime.device_io import (Stager, SyncAudit,
                                                    staging_slots,
                                                    device_name, fetch_poses,
                                                    path_kernels,
                                                    prepare_kernels)
    from liodom_tpu_torch.runtime.native import split_ouster_np
    from liodom_tpu_torch.runtime.publisher import OdomPublisher
    from liodom_tpu_torch.runtime.stats import Stats

    dev = resolve_device(args.device)
    report = {"app": "run_ouster", "rc": 1, "device": device_name(dev)}
    if args.dir:
        files = sorted(glob.glob(os.path.join(args.dir, "*.npy")))
        if not files:
            print(f"no .npy files in {args.dir}", file=sys.stderr)
            return report
        files = files[:args.frames]
        probe = np.load(files[0]).astype(np.float32)
        rings, width = probe.shape[:2]
        n = len(files)

        def load_organized(i):
            return np.load(files[i]).astype(np.float32)
    elif args.synthetic:
        from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                                 yaw_matrix)
        world = BoxWorld(seed=0)
        n = args.frames
        pos, yaws = drive_trajectory(n, speed=1.0, yaw_rate=0.01)
        rings, width = 64, args.width

        def load_organized(i):
            # BoxWorld renders ring-major (hdl64_directions meshgrid 'ij'),
            # so a reshape IS the row-organized cloud an Ouster driver emits
            return world.render(pos[i], yaw_matrix(yaws[i]),
                                width=args.width, noise=0.01,
                                seed=i).reshape(rings, args.width, 3)
    else:
        print("need --dir or --synthetic", file=sys.stderr)
        return report

    ring_width = args.ring_width
    if ring_width <= 0:
        # rows are rings: occupancy can never exceed the organized width
        ring_width = max(128, int(-(-width // 128)) * 128)
    # launch/liodom_ouster.launch: lidar_type 1, the empty laser_frame
    # taken from the message header (laser_odometry.cc:111-113)
    cfg = ouster_preset(rings)[0].replace(
        ring_width=ring_width, local_map_size=args.local_map_size)
    chunk = max(args.chunk, 1)
    report.update(rc=0, rings=rings, ring_width=ring_width, chunk=chunk)

    # loader-split ingest in prefetch threads (the production input path:
    # the step starts at the smoothness kernel, like run_kitti)
    def make_frame(i):
        img, counts, n_drop = split_ouster_np(
            load_organized(i), cfg.ring_width, cfg.min_range, cfg.max_range)
        return img, counts, n_drop

    state = P.init_state(cfg, device=dev)
    report.update(prepare_kernels(path_kernels(mapping=False), dev))

    pub = OdomPublisher(fixed_frame=cfg.fixed_frame,
                        base_frame=cfg.base_frame)
    stats = Stats()
    freq = FrequencyMonitor()

    start_frame = 0
    poses = []
    if args.checkpoint_dir and CK.latest_step(args.checkpoint_dir) is not None:
        step_no, ck = CK.restore(args.checkpoint_dir,
                                 template={"odom_state": state})
        state, start_frame = ck.odom_state, ck.frame_index
        for m in ck.trajectory:
            m44 = np.eye(4)
            m44[:3, :4] = m
            poses.append(m44)
            stats.add_pose(m44)
        print(f"resumed from checkpoint step {step_no} "
              f"(frame {start_frame})")
        report["start_frame"] = start_frame
        if start_frame >= n:
            print(f"checkpoint already covers frame {start_frame} >= "
                  f"--frames {n}; nothing to do (pass a larger --frames "
                  "to extend the run)")
            report["frames"] = 0
            return report

    def step_image(s, x, c):
        return P.image_step(s, x, c, cfg)

    def step_chunk(s, xs, cs):
        return P.chained_image_step(s, xs, cs, cfg)

    if args.aot:
        from liodom_tpu_torch.runtime import aot
        t_aot = time.perf_counter()
        ex_img = torch.zeros((cfg.scan_lines, cfg.ring_width, 3),
                             dtype=torch.float32, device=dev)
        ex_cnt = torch.zeros((cfg.scan_lines,), dtype=torch.int32,
                             device=dev)
        if chunk > 1:
            step_chunk = aot.get_or_compile(
                "ouster_image_chunk", step_chunk,
                (state, torch.stack([ex_img] * chunk),
                 torch.stack([ex_cnt] * chunk)),
                extra=f"{cfg}|chunk={chunk}")
        else:
            step_image = aot.get_or_compile(
                "ouster_image_step", step_image, (state, ex_img, ex_cnt),
                extra=str(cfg))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report.update(aot_capture_s=time.perf_counter() - t_aot, graphs=1)
        print(f"aot: 1 step captured in {report['aot_capture_s']:.2f} s")

    pool = ThreadPoolExecutor(max_workers=args.prefetch)
    depth = max(args.prefetch * 2, chunk + 2)
    futures = {i: pool.submit(make_frame, i)
               for i in range(start_frame, min(start_frame + depth, n))}

    def get_frame(i):
        out = futures.pop(i).result()
        j = i + depth
        if j < n:
            futures[j] = pool.submit(make_frame, j)
        return out

    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev,
                    slots=staging_slots(chunk, (args.time_every, 50),
                                        args.aot))
    audit = SyncAudit(dev)
    n_dropped = 0
    cbuf, pending = [], []
    last_odom_ms = float("nan")
    t_compile = None
    next_timed = start_frame   # chunk-mode sampling: first flush at/after
    n_flushed = 1              # each due point (boundaries rarely align)
    n_first = 1                # frames of the first dispatch
    # checkpoint at the first flush AT/AFTER each due point — a modulo test
    # never fires when checkpoint_every is not a multiple of the chunk size
    next_ck = start_frame + args.checkpoint_every
    t_start = time.perf_counter()
    try:
        with audit:
            for i in range(start_frame, n):
                img, counts, nd = get_frame(i)
                n_dropped += nd
                freq.tick_input(t=i * 0.1)
                t0 = time.perf_counter()
                x, c = stager.put(img, counts)
                if chunk == 1:
                    state, pose, n_edges = step_image(state, x, c)
                    pending.append((pose.q, pose.t, n_edges))
                    flushed = True
                else:
                    cbuf.append((x, c))
                    flushed = len(cbuf) == chunk or i == n - 1
                    if flushed:
                        if len(cbuf) == chunk:
                            state, cposes, cnes = step_chunk(
                                state, torch.stack([b[0] for b in cbuf]),
                                torch.stack([b[1] for b in cbuf]))
                            pending.append((cposes.q, cposes.t, cnes))
                        else:
                            for bx, bc in cbuf:
                                state, p_, ne_ = P.image_step(state, bx, bc,
                                                              cfg)
                                pending.append((p_.q, p_.t, ne_))
                        n_flushed = len(cbuf)
                        cbuf.clear()
                timed = args.time_every > 0 and flushed and i >= next_timed
                ck_due = (args.checkpoint_dir is not None and flushed
                          and (i + 1) >= next_ck)
                if flushed and (timed or t_compile is None
                                or (i + 1) % 50 == 0 or i == n - 1
                                or ck_due):
                    with audit.allowed():
                        # one copy for the block; it blocks on this flush's
                        # last pose
                        mats, nes = fetch_poses(pending)
                        dt = (time.perf_counter() - t0) * 1e3
                        if t_compile is None:
                            # the first dispatch — recorded as such, NOT as
                            # a latency sample
                            t_compile, n_first = dt / 1e3, n_flushed
                        elif timed:
                            last_odom_ms = dt / n_flushed if chunk > 1 else dt
                            next_timed = i + args.time_every
                        for mat, ne_i in zip(mats, nes):
                            stats.add_pose(mat)
                            stats.add_num_feats(int(ne_i))
                            stats.add_laser_odometry_time(
                                last_odom_ms,
                                measured=timed
                                and bool(np.isfinite(last_odom_ms)))
                            poses.append(mat)
                            pub.publish(mat, stamp=len(poses) * 0.1)
                        pending.clear()
                        if ck_due:
                            CK.save(args.checkpoint_dir, i + 1,
                                    CK.EngineCheckpoint(
                                        state, None,
                                        np.stack(poses)[:, :3, :4], i + 1))
                            next_ck = i + 1 + args.checkpoint_every
                freq.tick_output(t=i * 0.1 + (time.perf_counter() - t_start))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    wall = time.perf_counter() - t_start - (t_compile or 0.0)
    done = n - start_frame
    timed_frames = max(done - n_first, 1)
    rate = timed_frames / max(wall, 1e-9)
    print(f"first {'chunk' if n_first > 1 else 'frame'}: "
          f"{t_compile or 0:.3f} s; {timed_frames} frames in "
          f"{wall:.2f} s = {rate:.1f} scans/s")
    syncs = audit.count + stager.waits
    print(f"host syncs between due points: {syncs}"
          + (f" (first: {audit.first})" if audit.first else ""))
    if n_dropped:
        print(f"WARNING: {n_dropped} points dropped by the "
              f"ring_width={cfg.ring_width} clamp across the run")
    if poses:
        print(f"final position: {poses[-1][:3, 3]}")
    if args.results_dir:
        stats.write_results(args.results_dir)
        print(f"results in {args.results_dir}")
    report.update(frames=done, start_frame=start_frame,
                  first_frame_s=t_compile, first_dispatch_frames=n_first,
                  scans_per_s=rate,
                  host_syncs=syncs, stager_waits=stager.waits,
                  ring_dropped=int(n_dropped))
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    report = run(argv)
    print(json.dumps(report), flush=True)
    return report["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
