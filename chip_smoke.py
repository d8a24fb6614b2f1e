#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (liodom_tpu_torch) on one NVIDIA card.

Run from the root of the repository:

    python3 chip_smoke.py    # build, check, drive, time, profile

Phases, each printing one JSON line:

1. device — the card's name and power limit, then the build of every kernel
   of the main path from ``liodom_tpu_torch/csrc`` (one nvcc per source, in
   parallel).
2. main_path — 36 frames of ``image_step`` on the card at the bench
   configuration (64 rings x 4096 columns, 5-frame window) over the
   noise-free BoxWorld drive of ``apps/run_synthetic.py`` (1.2 m/frame,
   0.01 rad/frame), with every launch counter set to 0 just before and read
   just after: K1 and K2 must launch once a frame and K3 twice.  Every pose
   must be finite, every frame must yield > 100 edges, the ATE over the
   first 20 frames must stay below 0.1 m (past frame 20 the algorithm
   drifts, the JAX engine alike: tests/drift_vs_jax.py), and no step may
   synchronise with the host (torch's sync debug mode).
3. cpu_parity — the first 6 frames again through the port's CPU path (the
   kernels' plain versions): poses within 1 cm and 1e-3 rad of the card's.
4. combined_path — 36 frames of ``combined_image_step`` (odometry + the
   hash-grid map + local-map extraction, ``bench.py``'s map configuration:
   524,288 slots, a 16,384-row local map) on the same drive, the local map
   refreshed every frame, counters set to 0 just before and read just
   after: K1, K2, K7 and the probe kernel once a frame, K3 twice.  Every
   pose finite, ATE over the first 20 frames below 0.1 m, no point dropped
   by the map (overflow 0), no local map truncated (hits <= 16,384 at every
   pose, checked after the loop) and no host synchronisation.
5. combined_cpu_parity — its first 6 frames through the CPU path: poses
   within 1 cm and 1e-3 rad, equal edge counts, occupied map slots within
   0.1 % (the float pose transform may round a point that lies exactly on
   a leaf boundary of the noise-free world into a different leaf on each
   device).
6. batch_path — 36 frames of ``batch_image_step`` at B = 4 over 4 distinct
   noise-free drives (lane s: ``BoxWorld(seed=s)``, 0.01 (s + 1)
   rad/frame; lane 0 is the drive above), counters set to 0 just before and
   read just after: K1 and K2 once a frame on the folded rings, K4 twice,
   K3 never.  Each lane's ATE over the first 20 frames below 0.1 m, each
   lane within 1 cm and 1e-3 rad of solo ``image_step`` on the card over
   the same drive's first 20 frames with equal edge counts (the features
   and K4 are bit-identical to solo, but the batched solve sums in another
   order, and an LM step whose cost change sits at float32 noise can be
   taken by one and not the other: the lanes part by up to 5e-4 m on frame
   1; every frame's gap is printed, and the largest over the first 3
   frames, ``tests/test_batch.py``'s horizon), no host synchronisation;
   then
   ``batch_cpu_parity``: lanes 0-1, 3 frames through the CPU path, within
   1 cm and 1e-3 rad with equal edge counts.
7. chained_path — the drive of phase 2 through ``chained_image_step`` in
   chunks of 12 frames (``bench.py:147``), and again with ``use_imu=True``
   and the drive's per-frame orientation as IMU quaternions: poses within
   1e-6 m of the per-frame loop's (phase 2's poses, and a ``set_imu`` then
   ``image_step`` loop), launches 36/36/72, no host synchronisation.
8. lines_path — phases 2 and 4 again under ``LIODOM_KNN_IMPL=pallas_lines``:
   K6 twice a frame and K3 never, ATE over 20 frames below 0.1 m, poses
   within 1 cm and 1e-3 rad of the ``pallas_coords`` runs over those 20
   frames (every frame's gap printed), no host synchronisation.
9. sharded_path — the parallel layer on a one-rank NCCL mesh (data 1 x
   map 1; a process group on a free local port, its communicators created
   before any drive): 36 frames of ``make_sharded_combined_image_step`` at
   the combined configuration, counters set to 0 just before and read just
   after: K1, K2, K7 and the probe kernel once a frame, K5 twice, K3, K4
   and K6 never; ATE over 20 frames below 0.1 m, within 1 cm and 1e-3 rad
   of phase 4's ``combined_image_step`` over those 20 frames (every
   frame's gap printed), equal edge counts, overflow 0, no host
   synchronisation.  Then ``make_sharded_step`` on phase 6's 4 lanes as one
   local batch, fed ``select_edges``' edges (taken before the counters
   are reset): K5 twice a frame and nothing else, each lane within 1 cm and
   1e-3 rad of its solo ``image_step`` over 20 frames; then
   ``make_sharded_combined_step`` on lane 0's edges for 20 frames against
   ``combined_image_step`` on the same bar; then ``launch.smoke`` and
   ``launch.combined_smoke`` on the same mesh.
10. sharded_cpu_parity — the flagship's first 6 frames on the CPU in a
   one-rank gloo group (a subprocess: ``--sharded-cpu``): within 1 cm and
   1e-3 rad of the card, equal edge counts.
11. timing — the bench drive of ``bench.py`` (the same course with 1 cm
   sensor noise): steady-state ms/frame and scans/s by CUDA events after 6
   warm-up frames, for ``image_step``, for ``combined_image_step`` at the
   bench's two cadences (every frame, and every 4th frame), for
   ``batch_image_step`` at B = 4 and 8 (``bench.py:401``; lanes as in phase
   6, with noise: ms a batched frame and aggregate scans/s), for
   ``chained_image_step`` (chunks of 12) and for the sharded flagship at
   mesh 1 x 1, each drive twice in turns; every run at most 125 ms a frame
   for each lane (0.8 x the 10 Hz sensor rate).
12. kernels — each kernel against its plain PyTorch version on the card, on
   the bench drive's last frame, window, map and pose: K1 bit-exact, K2
   bit-exact edges for the same smoothness plane (also at 8 x 21 = 168
   slots a ring, above the JAX kernel's 128, with the kernel's cluster,
   list length and shared memory and the walk's dependent steps, a
   latency bound beside the byte bound), K3 d2 within 1e-5
   relative where d2 < 1 and identical coordinates where the 5th-NN gate
   passes, K4 at B = 4 (the bench lanes) bit-identical to K3 launched on
   each lane and held to K3's checks, K6 endpoints identical where both it
   and its plain version accept and any flip of the gate where the plain
   eigenvalues sit at the ratio (|e_max - 3 e_mid| <= 1e-4 e_max); the
   shared walk of K3, K4 and K6 bit for bit on every slot (d2,
   coordinates, endpoints; K6's gate as above) against the keyed (d2,
   index) selection ``knn_launch_plain`` on K3's and K4's inputs and on
   tie-heavy scenes (a 5 cm lattice with duplicate refs, one pair and 4 as
   a batch), with the flagged tiles a query tile and the walk's cluster
   blocks and thread groups in the K3, K4 and K6 rows beside their ptxas
   usage; K7
   bit-exact rows, validity and hit count (at the bench capacity and at
   one that truncates), the probe kernel bit-exact table, slots and flags,
   K5 on the sharded flagship's last frame and matching map, without a
   radius (the path's call) and with 1 m: indices identical wherever the
   plain d2 is finite (within the radius), d2 within 1e-5 relative where
   d2 < 1; the path's call and the tie scenes without a radius bit for bit
   on every row against ``knn_index_launch_plain``, one kernel a call
   under the profiler, its cluster blocks and thread groups beside its
   ptxas usage; K3, K4, K5 and K6 at k = 3 and 8 (the walk built for
   every 1 <= k <= 16) bit for bit against ``knn_launch_plain`` /
   ``knn_index_launch_plain`` / ``knn_lines_launch_plain`` on the bench
   inputs (K6's gate as above), with ptxas registers and spills at k = 5
   and 8; then each kernel's time beside its plain version's and its
   bound.
13. profile — torch.profiler over 5 frames of the bench drive, for
   ``image_step``, ``combined_image_step``, ``batch_image_step`` at B = 4
   and 8 and the sharded flagship: device busy time and share, device
   kernels a frame, the largest kernels by time, and the host's operators
   by their own time.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line and, as the last
line, ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that last line; no exception is caught.  Exits non-zero at once when
no CUDA device is available.  The process group is destroyed before the
last lines; the CPU subprocess ends within its phase.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import liodom_tpu_torch
from liodom_tpu_torch import kernels
from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                         tie_scene, yaw_matrix)
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S
from liodom_tpu_torch.odometry import local_map
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import compact_pallas as K7
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import knn_pallas as KNN
from liodom_tpu_torch.ops import neighbors as NB
from liodom_tpu_torch.ops import probe_insert as PI
from liodom_tpu_torch.ops import select_pallas as SEL
from liodom_tpu_torch.ops import smoothness_pallas as SM
from liodom_tpu_torch.parallel import combined as CB
from liodom_tpu_torch.parallel import launch as LA
from liodom_tpu_torch.parallel.mesh import make_mesh
from liodom_tpu_torch.parallel.sharded import (all_gather, init_batch_state,
                                               make_sharded_step)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores

N_FRAMES = 36
N_CPU_FRAMES = 6
N_WARM = 6
N_ATE = 20
FRAME_BUDGET_MS = 125.0     # 0.8 x the 10 Hz sensor rate
LANES = 4                   # batch_path's sequences
TIMED_BATCHES = (4, 8)      # bench.py:401
N_BATCH_CPU = 3             # frames of the batch path's CPU parity
N_LOCKSTEP = 3              # tests/test_batch.py's horizon, reported
CHUNK = 12                  # chained_image_step frames a call (bench.py:147)
K6_OPS_PER_QUERY = 160      # csrc/knn_lines.cu's epilogue, counted by hand
OTHER_K = (3, 8)            # the kNN kernels at k other than 5
# one dependent step of K2's walk: a shared-memory load and a warp vote,
# ~30 cycles at the H100's 1.98 GHz boost clock (published latency)
WALK_STEP_S = 30 / 1.98e9
# bench.py's combined configuration (bench.py:91)
MCFG = MapConfig(map_capacity=524288, local_map_capacity=16384)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs, by CUDA events
    around the whole batch after ``warm`` unmeasured runs.

    The batch is queued behind a device-side sleep longer than one batch
    takes the host to enqueue, so the events time the device's work and not
    the host's launch rate (a few-microsecond kernel is enqueued slower than
    it runs)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # 2x the batch's host time at 2 GHz (the H100's SM clock is at most
    # 1.98 GHz, so the sleep lasts at least that long)
    torch.cuda._sleep(int(2.0 * host_s * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the HBM time and the FP32 time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_COUNTED = {"smoothness": SM.smoothness_cuda,
            "select_edges": SEL.select_edges_cuda,
            "knn_coords": KNN.knn_launch,
            "knn_coords_batched": KNN.knn_launch_batched,
            "knn_lines": KNN.knn_lines_launch,
            "knn_index": KNN.knn_index_launch,
            "local_map_compact": K7.compact_hits_cuda,
            "probe_insert": PI.probe_insert_cuda}


def reset_counters() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def launches(**nonzero) -> dict:
    """The counters a drive must leave: the named ones, every other 0."""
    return {name: nonzero.get(name, 0) for name in _COUNTED}


def sync_free(run):
    """``run()`` under torch's sync debug mode; returns (its result, the
    host synchronisations it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        out = run()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def ptxas_usage(log: str) -> dict:
    """{entry function: registers, static shared memory, stack and spill
    bytes} from a build log of ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                out[name].update(stack_bytes=int(m.group(1)),
                                 spill_store_bytes=int(m.group(2)),
                                 spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                smem = re.search(r"(\d+) bytes smem", ln)
                out[name].update(registers=int(m.group(1)),
                                 static_smem_bytes=int(smem.group(1))
                                 if smem else 0)
    return out


def usage_at_k(usage: dict, kernel: str, k: int) -> dict:
    """ptxas usage of the instantiation of template ``kernel`` at ``k``
    (its mangled name holds ``<kernel>ILi<k>E``)."""
    for name, u in (usage or {}).items():
        if re.search(rf"{kernel}ILi{k}E", name):
            return u
    return {}


def walk_vs_oracle(prep, gates) -> dict:
    """K3 (K4 for a batch) and K6 on the same prepared tensors against
    ``knn_launch_plain`` and ``knn_lines_launch_plain``, the keyed (d2,
    index) selection: d2, coordinates and endpoints bit for bit on every
    slot; K6's gate may flip only where the plain eigenvalues sit at the
    ratio (acosf / cosf ulps)."""
    batched = prep[2].ndim == 3
    launch = KNN.knn_launch_batched if batched else KNN.knn_launch
    d_k, c_k = launch(*prep)
    d_o, c_o = KNN.knn_launch_plain(*prep)
    prep_l = prep if batched else tuple(x[None] for x in prep)
    lpa, lpb, ok = KNN.knn_lines_launch(*prep_l, *gates)
    lpa_o, lpb_o, ok_o = KNN.knn_lines_launch_plain(*prep_l, *gates)
    near = c_o if batched else c_o[None]
    zm = near - near.mean(dim=-2, keepdim=True)
    eigs = NB.sym3_eigenvalues(torch.einsum("...ki,...kj->...ij", zm, zm))
    at_ratio = ((eigs[..., 2] - gates[1] * eigs[..., 1]).abs()
                <= 1e-4 * eigs[..., 2].abs())
    flips = ok != ok_o
    real = d_o < 1.0
    tied = (real[..., 1:] & (d_o.diff(dim=-1) == 0)).any(-1)
    flags = prep[2]
    per_tile = flags.sum(-1).float()
    return {"rows": int(d_o[..., 0].numel()),
            "rows_with_a_tie_within_1m": int(tied.sum()),
            "flagged_pairs": int(flags.sum()),
            "flagged_tiles_per_query_tile_max": int(per_tile.max()),
            "flagged_tiles_per_query_tile_mean": float(per_tile.mean()),
            "d2_equal": torch.equal(d_k, d_o),
            "coords_equal": torch.equal(c_k, c_o),
            "k6_endpoints_equal": (torch.equal(lpa, lpa_o)
                                   and torch.equal(lpb, lpb_o)),
            "k6_gate_flips": int(flips.sum()),
            "k6_gate_flips_off_ratio_boundary": int((flips & ~at_ratio)
                                                    .sum())}


def walk_row(tie: dict, source: str, n_m: int) -> dict:
    """The kernels-line keys of the shared walk: its inputs' flagged tiles
    a query tile, and, as the built library of ``source`` reports them, the
    cluster's blocks it deals them over, the thread groups that split each
    staged tile and the dynamic shared memory a block takes
    (``csrc/knn_search.cuh``)."""
    return {"flagged_tiles_per_query_tile_max":
                tie["flagged_tiles_per_query_tile_max"],
            "flagged_tiles_per_query_tile_mean":
                tie["flagged_tiles_per_query_tile_mean"],
            **KNN.knn_walk_shape(source, n_m)}


def quat_angle(qa: np.ndarray, qb: np.ndarray) -> float:
    """Rotation angle between two wxyz quaternions, from the vector part of
    conj(qa) * qb: accurate near 0, where 2 acos(|qa . qb|) of float32
    quaternions floors at ~5e-4 rad (|qa . qb| = 1 - 3e-8)."""
    aw, av = float(qa[0]), qa[1:].astype(np.float64)
    bw, bv = float(qb[0]), qb[1:].astype(np.float64)
    w = aw * bw + float(av @ bv)
    v = aw * bv - bw * av - np.cross(av, bv)
    return 2.0 * math.atan2(float(np.linalg.norm(v)), abs(w))


def render_lanes(cfg: LiodomConfig, dev: torch.device, lanes, noise: float):
    """Ring images of the lanes' drives: lane s is ``BoxWorld(seed=s)``
    driven at 1.2 m/frame and 0.01 (s + 1) rad/frame yaw (lane 0 is the
    drive of ``apps/run_synthetic.py`` and ``bench.py``), an 1800-column
    HDL-64 spin rendered in threads (noise seed 1000 s + frame) and split on
    the card by the port's loader stage; no point may be dropped by the
    ring width.  Returns {lane: (images, positions, yaws)}."""
    drives = {s: drive_trajectory(N_FRAMES, speed=1.2,
                                  yaw_rate=0.01 * (s + 1)) for s in lanes}
    worlds = {s: BoxWorld(seed=s) for s in lanes}
    jobs = [(s, i) for s in lanes for i in range(N_FRAMES)]

    def render(job):
        s, i = job
        pos, yaws = drives[s]
        return worlds[s].render(pos[i], yaw_matrix(yaws[i]), width=1800,
                                noise=noise, seed=1000 * s + i)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(render, jobs))
    imgs = {s: [] for s in lanes}
    for (s, i), scan in zip(jobs, scans):
        raw = RawScan.from_points(torch.from_numpy(scan), cfg.max_points,
                                  device=dev)
        dropped = int(F.split_overflow(raw, cfg))
        if dropped:
            raise SystemExit(f"lane {s} frame {i}: ring width "
                             f"{cfg.ring_width} dropped {dropped} points")
        imgs[s].append(F.split_scan(raw, cfg))
    return {s: (imgs[s],) + drives[s] for s in lanes}


def stack_lanes(per_lane):
    """Frame-by-frame batched images (B, R, W, 3) from per-lane lists."""
    return [RingImage(torch.stack([lane[i].xyz for lane in per_lane]),
                      torch.stack([lane[i].count for lane in per_lane]))
            for i in range(len(per_lane[0]))]


def run_course(state, imgs, cfg, keep: bool = True, quats=None,
               step=P.image_step):
    """Drive ``image_step`` (or ``step``: ``batch_image_step`` over batched
    images) over the images, with ``quats`` calling ``set_imu`` before each
    frame; returns the state after each frame (the step leaves its input
    state untouched; with ``keep=False`` the last state only), the poses and
    the per-frame edge counts, all still on the device."""
    states, poses, n_edges = [], [], []
    for i, img in enumerate(imgs):
        if quats is not None:
            state = P.set_imu(state, quats[i])
        state, pose, ne = step(state, img.xyz, img.count, cfg)
        states = (states if keep else []) + [state]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def run_combined(odom, m, imgs, cfg, every_frame: bool = True,
                 first: int = 0, keep: bool = True):
    """Drive ``combined_image_step`` over the images (frames ``first``,
    ``first + 1``, ...) at the bench's map configuration.  ``every_frame``:
    refresh the local map each frame (``step=0``), else every 4th frame
    (``step=i``), the two cadences of ``bench.py``'s combined rows.
    Returns the (odometry, map) state after each frame (``keep=False``: the
    last one only), the poses and the edge counts, all on the device."""
    states, poses, n_edges = [], [], []
    for i, img in enumerate(imgs, start=first):
        odom, m, pose, ne = S.combined_image_step(
            odom, m, img.xyz, img.count, cfg, MCFG,
            step=0 if every_frame else i, local_map_every=4)
        states = (states if keep else []) + [(odom, m)]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def run_chained(state, imgs, cfg, keep: bool = True, quats=None):
    """Drive ``chained_image_step`` in chunks of CHUNK frames (the last
    chunk may be shorter); as :func:`run_course`, with one state a chunk
    and the per-frame poses and edge counts."""
    states, poses, n_edges = [], [], []
    for c0 in range(0, len(imgs), CHUNK):
        chunk = imgs[c0:c0 + CHUNK]
        state, ps, nes = P.chained_image_step(
            state, torch.stack([im.xyz for im in chunk]),
            torch.stack([im.count for im in chunk]), cfg,
            imu_quats=None if quats is None else quats[c0:c0 + CHUNK])
        states = (states if keep else []) + [state]
        poses += [se3.Pose(ps.q[j], ps.t[j]) for j in range(len(chunk))]
        n_edges += list(nes)
    return states, poses, n_edges


def run_sharded(state, mstate, imgs, step, keep: bool = True):
    """Drive ``make_sharded_combined_image_step``'s ``step`` over the
    images; as :func:`run_combined`, one (state, map shard) a frame."""
    states, poses, n_edges = [], [], []
    for img in imgs:
        state, mstate, pose, ne = step(state, mstate, img.xyz, img.count)
        states = (states if keep else []) + [(state, mstate)]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_cpu_run(workdir: Path) -> int:
    """The flagship on the CPU in a one-rank gloo group (a subprocess of
    the sharded_cpu_parity phase): ring images from ``workdir/imgs.npz``
    in, poses and edge counts to ``workdir/poses.npz``."""
    cfg = LiodomConfig(local_map_size=5, mapping=True)
    data = np.load(workdir / "imgs.npz")
    LA.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(1, 1, device="cpu")
        step = CB.make_sharded_combined_image_step(mesh, cfg, MCFG)
        imgs = [RingImage(torch.from_numpy(x), torch.from_numpy(c))
                for x, c in zip(data["xyz"], data["count"])]
        _, poses, n_edges = run_sharded(
            *CB.init_combined_image_sharded(cfg, MCFG, mesh, device="cpu"),
            imgs, step, keep=False)
        np.savez(workdir / "poses.npz",
                 q=torch.stack([p.q for p in poses]).numpy(),
                 t=torch.stack([p.t for p in poses]).numpy(),
                 n_edges=torch.stack(n_edges).numpy())
    finally:
        dist.destroy_process_group()
    return 0


def drive_error(poses, gt_pos):
    """(t (F, ...), q (F, ...), error to ground truth per frame, ATE over
    the first N_ATE frames) of a drive's poses, the lane axis last but
    one when batched."""
    q = torch.stack([p.q for p in poses]).cpu().numpy()
    t = torch.stack([p.t for p in poses]).cpu().numpy()
    err = np.linalg.norm(t - gt_pos, axis=-1)
    return t, q, err, float(np.sqrt(np.mean(err[:N_ATE] ** 2)))


def pose_gaps(t_a, q_a, t_b, q_b):
    """Translation (m) and rotation (rad) gaps between two pose sequences
    (F, ..., 3) / (F, ..., 4), per frame (and lane)."""
    dr = [quat_angle(a, b) for a, b in zip(q_a.reshape(-1, 4),
                                            q_b.reshape(-1, 4))]
    return (np.linalg.norm(t_a - t_b, axis=-1),
            np.reshape(dr, q_a.shape[:-1]))


def pose_gap(t_a, q_a, t_b, q_b):
    """Largest translation (m) and rotation (rad) gap between two pose
    sequences (..., 3) / (..., 4)."""
    dt, dr = pose_gaps(t_a, q_a, t_b, q_b)
    return float(dt.max()), float(dr.max())


def timed_drive(drive, init, imgs):
    """Steady-state time a frame of ``drive(state, images, first frame)``:
    N_WARM frames unmeasured, then the rest between two CUDA events and on
    the host clock.  The drive keeps only its last state, as a user's loop
    does (a map state is 17 MB at the bench capacity).  Returns (ms/frame,
    host ms/frame, poses and edge counts of all frames)."""
    wstates, wposes, wedges = drive(init, imgs[:N_WARM], 0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    states, poses, edges = drive(wstates[-1], imgs[N_WARM:], N_WARM)
    stop.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0
    n_timed = len(imgs) - N_WARM
    return (start.elapsed_time(stop) / n_timed, host_s / n_timed * 1e3,
            wposes + poses, wedges + edges)


def profile_frames(step, state, imgs, smi) -> dict:
    """torch.profiler over ``state = step(state, img)`` for the images:
    device busy time and share, kernels a frame, the largest kernels."""
    n = len(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for im in imgs:
            state = step(state, im)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    # device kernels (one stream, so their sum is the busy time), and the
    # host's operators by their own time
    by_name, host = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, acc = ev.time_range.elapsed_us(), by_name
        else:
            us, acc = ev.self_cpu_time_total, host
        tot, cnt = acc.get(ev.name, (0.0, 0))
        acc[ev.name] = (tot + us, cnt + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:15]
    return {"frames": n, "nvidia_smi": smi,
            "host_ops_per_frame": sum(c for _, c in host.values()) / n,
            "top_host_ops_self_us_per_frame": [
                [name[:50], cnt / n, tot / n]
                for name, (tot, cnt) in top_host],
            "wall_ms_per_frame": wall_ms / n,
            "device_busy_ms_per_frame": busy_ms / n,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_launches_per_frame":
                sum(c for _, c in by_name.values()) / n,
            "top_kernels_us_per_frame": [
                [name[:70], cnt / n, tot / n]
                for name, (tot, cnt) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the sharded_cpu_parity phase's subprocess
    ap.add_argument("--sharded-cpu", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_cpu is not None:
        return sharded_cpu_run(args.sharded_cpu)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if Path(liodom_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: liodom_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 2
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    # every path runs the coords kernels unless lines_path says otherwise
    os.environ["LIODOM_KNN_IMPL"] = "pallas_coords"

    # ---- 1. device + build ------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    usage = {name: ptxas_usage(log) for name, log in logs.items()}
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": usage})

    # ---- 2. main path: the accuracy drive -------------------------------
    cfg = LiodomConfig(local_map_size=5)
    t0 = time.perf_counter()
    acc = render_lanes(cfg, dev, range(LANES), noise=0.0)
    bench = render_lanes(cfg, dev, range(max(TIMED_BATCHES)), noise=0.01)
    render_s = time.perf_counter() - t0
    imgs, gt_pos, gt_yaw = acc[0]

    state = P.init_state(cfg)
    torch.cuda.synchronize()
    reset_counters()
    (states, poses, n_edges), syncs = sync_free(
        lambda: run_course(state, imgs, cfg))
    counts = read_counters()
    t, q, err, ate_gate = drive_error(poses, gt_pos)
    ne = torch.stack(n_edges).cpu().numpy()
    ate_all = float(np.sqrt(np.mean(err ** 2)))
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES)
    check(counts == want, f"launch counts {counts} != {want}")
    check(bool(np.isfinite(q).all() and np.isfinite(t).all()),
          "non-finite pose")
    check(int(ne.min()) > 100, f"a frame had only {int(ne.min())} edges")
    check(ate_gate < 0.1, f"ATE over {N_ATE} frames {ate_gate:.4f} m >= 0.1")
    check(not syncs, f"{len(syncs)} host synchronisations in the main path: "
          f"{syncs[:1]}")
    emit({"phase": "main_path", "frames": N_FRAMES, "noise_m": 0.0,
          "render_s": render_s, "launches": counts,
          f"ate_m_first_{N_ATE}": ate_gate, "ate_m_all": ate_all,
          "err_m_per_frame": err.tolist(),
          "n_edges_min": int(ne.min()), "n_edges_max": int(ne.max()),
          "final_t": t[-1].tolist(), "gt_final_t": gt_pos[-1].tolist(),
          "host_syncs": len(syncs)})

    # ---- 3. the port's CPU path on the first frames -----------------------
    t0 = time.perf_counter()
    cstate = P.init_state(cfg, device="cpu")
    cpu_imgs = [RingImage(im.xyz.cpu(), im.count.cpu())
                for im in imgs[:N_CPU_FRAMES]]
    _, cposes, cedges = run_course(cstate, cpu_imgs, cfg)
    dt = [float(np.linalg.norm(cp.t.numpy() - t[i]))
          for i, cp in enumerate(cposes)]
    dr = [quat_angle(cp.q.numpy(), q[i]) for i, cp in enumerate(cposes)]
    same_edges = [int(c) for c in cedges] == [int(x) for x in
                                              ne[:N_CPU_FRAMES]]
    check(max(dt) < 0.01, f"card vs CPU path: {max(dt):.2e} m")
    check(max(dr) < 1e-3, f"card vs CPU path: {max(dr):.2e} rad")
    check(same_edges, "card and CPU path picked different edge counts")
    emit({"phase": "cpu_parity", "frames": N_CPU_FRAMES,
          "max_dt_m": max(dt), "max_drot_rad": max(dr),
          "same_n_edges": same_edges, "seconds": time.perf_counter() - t0})

    # ---- 4. the combined path: odometry + mapping, accuracy drive ---------
    ccfg = cfg.replace(mapping=True)
    codom, cmap = S.init_combined(ccfg, MCFG)
    torch.cuda.synchronize()
    reset_counters()
    (cstates, cposes_k, cedges_k), csyncs = sync_free(
        lambda: run_combined(codom, cmap, imgs, ccfg))
    ccounts = read_counters()
    ct, cq, cerr, cate_gate = drive_error(cposes_k, gt_pos)
    cne = torch.stack(cedges_k).cpu().numpy()
    final_map = cstates[-1][1]
    overflow = int(final_map.overflow)
    # the neighbourhood at every pose, in the map that frame left
    hits = [int(G.get_local_map(m, p.t, MCFG,
                                capacity=MCFG.local_map_capacity)[2])
            for (_, m), p in zip(cstates, cposes_k)]
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES, local_map_compact=N_FRAMES,
                    probe_insert=N_FRAMES)
    check(ccounts == want, f"combined launch counts {ccounts} != {want}")
    check(bool(np.isfinite(cq).all() and np.isfinite(ct).all()),
          "combined: non-finite pose")
    check(cate_gate < 0.1,
          f"combined ATE over {N_ATE} frames {cate_gate:.4f} m >= 0.1")
    check(overflow == 0, f"combined: {overflow} points dropped by the map")
    check(max(hits) <= MCFG.local_map_capacity,
          f"combined: local map truncated ({max(hits)} hits)")
    check(not csyncs, f"{len(csyncs)} host synchronisations in the combined "
          f"path: {csyncs[:1]}")
    emit({"phase": "combined_path", "frames": N_FRAMES, "noise_m": 0.0,
          "map_capacity": MCFG.map_capacity,
          "local_map_capacity": MCFG.local_map_capacity,
          "launches": ccounts, f"ate_m_first_{N_ATE}": cate_gate,
          "ate_m_all": float(np.sqrt(np.mean(cerr ** 2))),
          "err_m_per_frame": cerr.tolist(),
          "n_edges_min": int(cne.min()), "n_edges_max": int(cne.max()),
          "overflow": overflow, "occupied_slots": int(final_map.valid.sum()),
          "cells": G.count_cells(final_map),
          "n_hits_min": min(hits), "n_hits_max": max(hits),
          "host_syncs": len(csyncs)})

    # ---- 5. the combined path's CPU route on the first frames -------------
    t0 = time.perf_counter()
    c_states, c_poses, c_edges = run_combined(
        *S.init_combined(ccfg, MCFG, device="cpu"), cpu_imgs, ccfg)
    cdt = [float(np.linalg.norm(p.t.numpy() - ct[i]))
           for i, p in enumerate(c_poses)]
    cdr = [quat_angle(p.q.numpy(), cq[i]) for i, p in enumerate(c_poses)]
    c_same_edges = [int(c) for c in c_edges] == [int(x) for x in
                                                 cne[:N_CPU_FRAMES]]
    slots_card = [int(m.valid.sum()) for _, m in cstates[:N_CPU_FRAMES]]
    slots_cpu = [int(m.valid.sum()) for _, m in c_states]
    slot_rel = max(abs(a - b) / b for a, b in zip(slots_card, slots_cpu))
    check(max(cdt) < 0.01, f"combined card vs CPU path: {max(cdt):.2e} m")
    check(max(cdr) < 1e-3, f"combined card vs CPU path: {max(cdr):.2e} rad")
    check(c_same_edges, "combined: card and CPU path picked different edge "
          "counts")
    check(slot_rel <= 1e-3, f"combined: occupied slots differ by "
          f"{slot_rel:.2e} (card {slots_card}, CPU {slots_cpu})")
    emit({"phase": "combined_cpu_parity", "frames": N_CPU_FRAMES,
          "max_dt_m": max(cdt), "max_drot_rad": max(cdr),
          "same_n_edges": c_same_edges, "occupied_slots_card": slots_card,
          "occupied_slots_cpu": slots_cpu, "max_slot_rel_diff": slot_rel,
          "seconds": time.perf_counter() - t0})
    del c_states

    # ---- 6. batch_image_step over distinct drives -------------------------
    lane_imgs = stack_lanes([acc[s][0] for s in range(LANES)])
    lane_gt = np.stack([acc[s][1] for s in range(LANES)], axis=1)  # (F, B, 3)
    bst0 = init_batch_state(cfg, LANES)
    torch.cuda.synchronize()
    reset_counters()
    (_, lposes, ledges), lsyncs = sync_free(
        lambda: run_course(bst0, lane_imgs, cfg, keep=False,
                           step=P.batch_image_step))
    lcounts = read_counters()
    lt, lq, lerr, _ = drive_error(lposes, lane_gt)
    lne = torch.stack(ledges).cpu().numpy()                        # (F, B)
    lane_ate = np.sqrt(np.mean(lerr[:N_ATE] ** 2, axis=0))
    # each lane alone through image_step on the card (lane 0 is phase 2)
    solo = {0: (t, q, ne)}
    for s in range(1, LANES):
        _, sp, sn = run_course(P.init_state(cfg), acc[s][0], cfg, keep=False)
        st_, sq_, _, _ = drive_error(sp, acc[s][1])
        solo[s] = (st_, sq_, torch.stack(sn).cpu().numpy())
    # (F, B): each lane against its solo drive, per frame.  Two float
    # reassociations of one solve can take different LM accept decisions,
    # after which the lanes part by more than rounding: the port's 1 cm
    # parity bar over N_ATE frames, as the ATE gate
    lane_dt, lane_dr = (np.stack(g, axis=1) for g in zip(*(
        pose_gaps(lt[:, s], lq[:, s], solo[s][0], solo[s][1])
        for s in range(LANES))))
    lockstep = (float(lane_dt[:N_LOCKSTEP].max()),
                float(lane_dr[:N_LOCKSTEP].max()))
    lane_gap = (float(lane_dt[:N_ATE].max()), float(lane_dr[:N_ATE].max()))
    lane_same_edges = all(np.array_equal(lne[:, s], solo[s][2])
                          for s in range(LANES))
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords_batched=2 * N_FRAMES)
    check(lcounts == want, f"batch launch counts {lcounts} != {want}")
    check(bool(np.isfinite(lq).all() and np.isfinite(lt).all()),
          "batch: non-finite pose")
    check(float(lane_ate.max()) < 0.1, f"batch: a lane's ATE over {N_ATE} "
          f"frames {lane_ate.tolist()} m >= 0.1")
    check(lane_gap[0] < 0.01 and lane_gap[1] < 1e-3, f"batch vs solo "
          f"image_step on the card over {N_ATE} frames: {lane_gap}")
    check(lane_same_edges, "batch vs solo: different edge counts")
    check(not lsyncs, f"{len(lsyncs)} host synchronisations in the batch "
          f"path: {lsyncs[:1]}")
    emit({"phase": "batch_path", "frames": N_FRAMES, "batch": LANES,
          "noise_m": 0.0, "launches": lcounts,
          f"ate_m_first_{N_ATE}_per_lane": lane_ate.tolist(),
          "ate_m_all_per_lane": np.sqrt(np.mean(lerr ** 2, axis=0)).tolist(),
          f"vs_solo_max_dt_m_drot_rad_first_{N_LOCKSTEP}": lockstep,
          f"vs_solo_max_dt_m_drot_rad_first_{N_ATE}": lane_gap,
          "vs_solo_dt_m_per_frame_max_over_lanes":
              lane_dt.max(axis=1).tolist(),
          "vs_solo_drot_rad_per_frame_max_over_lanes":
              lane_dr.max(axis=1).tolist(),
          "same_n_edges_as_solo": lane_same_edges,
          "n_edges_min": int(lne.min()), "n_edges_max": int(lne.max()),
          "host_syncs": len(lsyncs)})

    t0 = time.perf_counter()
    n_cpu_lanes = 2
    cpu_lanes = [RingImage(im.xyz[:n_cpu_lanes].cpu(),
                           im.count[:n_cpu_lanes].cpu())
                 for im in lane_imgs[:N_BATCH_CPU]]
    _, bcp, bce = run_course(init_batch_state(cfg, n_cpu_lanes, device="cpu"),
                             cpu_lanes, cfg, step=P.batch_image_step)
    bct = torch.stack([p.t for p in bcp]).numpy()
    bcq = torch.stack([p.q for p in bcp]).numpy()
    bgap = pose_gap(bct, bcq, lt[:N_BATCH_CPU, :n_cpu_lanes],
                    lq[:N_BATCH_CPU, :n_cpu_lanes])
    b_same = np.array_equal(torch.stack(bce).numpy(),
                            lne[:N_BATCH_CPU, :n_cpu_lanes])
    check(bgap[0] < 0.01 and bgap[1] < 1e-3,
          f"batch card vs CPU path: {bgap}")
    check(b_same, "batch: card and CPU path picked different edge counts")
    emit({"phase": "batch_cpu_parity", "frames": N_BATCH_CPU,
          "batch": n_cpu_lanes, "max_dt_m": bgap[0], "max_drot_rad": bgap[1],
          "same_n_edges": b_same, "seconds": time.perf_counter() - t0})

    # ---- 7. chained_image_step, with and without the IMU ------------------
    chained = {}
    cfg_imu = cfg.replace(use_imu=True)
    half = torch.tensor(gt_yaw / 2.0, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(half)
    quats = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], -1)
    for name, ccfg_, qs in (("plain", cfg, None), ("imu", cfg_imu, quats)):
        if qs is None:
            loop_t, loop_q = t, q                   # phase 2's loop
        else:
            _, lp, _ = run_course(P.init_state(cfg_imu), imgs, cfg_imu,
                                  keep=False, quats=qs)
            loop_t, loop_q, _, _ = drive_error(lp, gt_pos)
        torch.cuda.synchronize()
        reset_counters()
        (_, chp, _), chs = sync_free(
            lambda: run_chained(P.init_state(ccfg_), imgs, ccfg_, keep=False,
                                quats=qs))
        chc = read_counters()
        cht, chq, cherr, chate = drive_error(chp, gt_pos)
        gap = pose_gap(cht, chq, loop_t, loop_q)
        want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                        knn_coords=2 * N_FRAMES)
        check(chc == want, f"chained ({name}) launch counts {chc} != {want}")
        check(gap[0] <= 1e-6, f"chained ({name}) vs the per-frame loop: "
              f"{gap[0]:.2e} m")
        check(not chs, f"{len(chs)} host synchronisations in the chained "
              f"path ({name}): {chs[:1]}")
        chained[name] = {"launches": chc, "vs_loop_max_dt_m": gap[0],
                         "vs_loop_max_drot_rad": gap[1],
                         f"ate_m_first_{N_ATE}": chate, "host_syncs": len(chs)}
    emit({"phase": "chained_path", "frames": N_FRAMES, "chunk": CHUNK,
          **chained})

    # ---- 8. the lines-kNN configuration (K6) ------------------------------
    os.environ["LIODOM_KNN_IMPL"] = "pallas_lines"
    lines = {}
    for name, run, ref_t, ref_q in (
            ("image_step", lambda: run_course(P.init_state(cfg), imgs, cfg,
                                              keep=False), t, q),
            ("combined_image_step", lambda: run_combined(
                *S.init_combined(ccfg, MCFG), imgs, ccfg, keep=False),
             ct, cq)):
        torch.cuda.synchronize()
        reset_counters()
        (_, lnp, _), lns = sync_free(run)
        lnc = read_counters()
        lnt, lnq, lnerr, lnate = drive_error(lnp, gt_pos)
        ln_dt, ln_dr = pose_gaps(lnt, lnq, ref_t, ref_q)
        # over the first N_ATE frames, as the batch path's bar
        gap = (float(ln_dt[:N_ATE].max()), float(ln_dr[:N_ATE].max()))
        mapped = name == "combined_image_step"
        want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                        knn_lines=2 * N_FRAMES,
                        local_map_compact=N_FRAMES if mapped else 0,
                        probe_insert=N_FRAMES if mapped else 0)
        check(lnc == want, f"lines ({name}) launch counts {lnc} != {want}")
        check(lnate < 0.1, f"lines ({name}) ATE over {N_ATE} frames "
              f"{lnate:.4f} m >= 0.1")
        check(gap[0] < 0.01 and gap[1] < 1e-3,
              f"lines ({name}) vs pallas_coords over {N_ATE} frames: {gap}")
        check(not lns, f"{len(lns)} host synchronisations in the lines path "
              f"({name}): {lns[:1]}")
        lines[name] = {"launches": lnc, f"ate_m_first_{N_ATE}": lnate,
                       "ate_m_all": float(np.sqrt(np.mean(lnerr ** 2))),
                       f"vs_coords_max_dt_m_first_{N_ATE}": gap[0],
                       f"vs_coords_max_drot_rad_first_{N_ATE}": gap[1],
                       "vs_coords_dt_m_per_frame": ln_dt.tolist(),
                       "vs_coords_drot_rad_per_frame": ln_dr.tolist(),
                       "host_syncs": len(lns)}
    os.environ["LIODOM_KNN_IMPL"] = "pallas_coords"
    emit({"phase": "lines_path", "frames": N_FRAMES, **lines})

    # ---- 9. the parallel layer on a one-rank NCCL mesh ---------------------
    LA.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    mesh = make_mesh(1, 1)
    # the first collective of each group creates its communicator, which
    # synchronises; do that before any drive
    probe = torch.ones(1, device=dev)
    for group in mesh.get_all_groups():
        all_gather(probe, group, 1)
        dist.all_reduce(probe, group=group)
    torch.cuda.synchronize()
    sstep = CB.make_sharded_combined_image_step(mesh, ccfg, MCFG)
    reset_counters()
    (s_states, sposes, sedges), ssyncs = sync_free(
        lambda: run_sharded(*CB.init_combined_image_sharded(ccfg, MCFG, mesh),
                            imgs, sstep, keep=True))
    scounts = read_counters()
    st_, sq_, serr, sate = drive_error(sposes, gt_pos)
    sne = torch.stack(sedges).cpu().numpy()
    s_dt, s_dr = pose_gaps(st_, sq_, ct, cq)
    s_gap = (float(s_dt[:N_ATE].max()), float(s_dr[:N_ATE].max()))
    s_overflow = int(s_states[-1][1].overflow)
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_index=2 * N_FRAMES, local_map_compact=N_FRAMES,
                    probe_insert=N_FRAMES)
    check(scounts == want, f"sharded launch counts {scounts} != {want}")
    check(bool(np.isfinite(sq_).all() and np.isfinite(st_).all()),
          "sharded: non-finite pose")
    check(sate < 0.1, f"sharded ATE over {N_ATE} frames {sate:.4f} m >= 0.1")
    check(s_gap[0] < 0.01 and s_gap[1] < 1e-3, f"sharded vs "
          f"combined_image_step over {N_ATE} frames: {s_gap}")
    check(np.array_equal(sne, cne), "sharded vs combined_image_step: "
          "different edge counts")
    check(s_overflow == 0, f"sharded: {s_overflow} points dropped by the map")
    check(not ssyncs, f"{len(ssyncs)} host synchronisations in the sharded "
          f"path: {ssyncs[:1]}")
    sharded = {"launches": scounts, f"ate_m_first_{N_ATE}": sate,
               "ate_m_all": float(np.sqrt(np.mean(serr ** 2))),
               f"vs_combined_max_dt_m_drot_rad_first_{N_ATE}": s_gap,
               "vs_combined_dt_m_per_frame": s_dt.tolist(),
               "vs_combined_drot_rad_per_frame": s_dr.tolist(),
               "same_n_edges": bool(np.array_equal(sne, cne)),
               "overflow": s_overflow,
               "occupied_slots": int(s_states[-1][1].valid.sum()),
               "host_syncs": len(ssyncs)}

    # make_sharded_step: the 4 lanes as one local batch, fed the edges of
    # select_edges (taken before the counters are set to 0)
    lane_edges = [F.select_edges(im, F.smoothness(im, cfg), cfg)
                  for im in lane_imgs]
    kstep = make_sharded_step(mesh, cfg)
    torch.cuda.synchronize()
    reset_counters()

    def run_lanes():
        st, poses = init_batch_state(cfg, LANES), []
        for ec in lane_edges:
            st, pose = kstep(st, ec.xyz, ec.valid)
            poses.append(pose)
        return poses

    kposes, ksyncs = sync_free(run_lanes)
    kcounts = read_counters()
    kt, kq, _, _ = drive_error(kposes, lane_gt)
    k_dt, k_dr = (np.stack(g, axis=1) for g in zip(*(
        pose_gaps(kt[:, s], kq[:, s], solo[s][0], solo[s][1])
        for s in range(LANES))))
    k_gap = (float(k_dt[:N_ATE].max()), float(k_dr[:N_ATE].max()))
    want = launches(knn_index=2 * N_FRAMES)
    check(kcounts == want, f"sharded step launch counts {kcounts} != {want}")
    check(k_gap[0] < 0.01 and k_gap[1] < 1e-3, f"sharded step vs solo "
          f"image_step over {N_ATE} frames: {k_gap}")
    check(not ksyncs, f"{len(ksyncs)} host synchronisations in the sharded "
          f"step: {ksyncs[:1]}")
    sharded["make_sharded_step"] = {
        "batch": LANES, "launches": kcounts,
        f"vs_solo_max_dt_m_drot_rad_first_{N_ATE}": k_gap,
        "vs_solo_dt_m_per_frame_max_over_lanes": k_dt.max(axis=1).tolist(),
        "host_syncs": len(ksyncs)}

    # make_sharded_combined_step: lane 0's edges, N_ATE frames
    cstep = CB.make_sharded_combined_step(mesh, ccfg, MCFG)
    edges0 = [(ec.xyz[0], ec.valid[0]) for ec in lane_edges[:N_ATE]]
    torch.cuda.synchronize()
    reset_counters()

    def run_composed():
        o, m, poses = *CB.init_combined_sharded(ccfg, MCFG, mesh), []
        for x, v in edges0:
            o, m, pose = cstep(o, m, x, v)
            poses.append(pose)
        return m, poses

    (c_map, c_poses), c_syncs = sync_free(run_composed)
    c_counts = read_counters()
    c_t = torch.stack([p.t for p in c_poses]).cpu().numpy()
    c_q = torch.stack([p.q for p in c_poses]).cpu().numpy()
    c_gap = pose_gap(c_t, c_q, ct[:N_ATE], cq[:N_ATE])
    want = launches(knn_index=2 * N_ATE, local_map_compact=N_ATE,
                    probe_insert=N_ATE)
    check(c_counts == want, f"sharded combined step launch counts "
          f"{c_counts} != {want}")
    check(c_gap[0] < 0.01 and c_gap[1] < 1e-3, f"sharded combined step vs "
          f"combined_image_step over {N_ATE} frames: {c_gap}")
    check(int(c_map.overflow) == 0, "sharded combined step: map overflow")
    check(not c_syncs, f"{len(c_syncs)} host synchronisations in the "
          f"sharded combined step: {c_syncs[:1]}")
    sharded["make_sharded_combined_step"] = {
        "frames": N_ATE, "launches": c_counts,
        "vs_combined_max_dt_m_drot_rad": c_gap, "host_syncs": len(c_syncs)}
    sharded["launch_smoke_checksum"] = LA.smoke(mesh)
    sharded["launch_combined_smoke_checksum"] = LA.combined_smoke(mesh)
    emit({"phase": "sharded_path", "frames": N_FRAMES, "mesh": [1, 1],
          "backend": dist.get_backend(), **sharded})

    # ---- 10. the flagship's CPU route, a one-rank gloo group -------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "imgs.npz",
                 xyz=np.stack([im.xyz.numpy() for im in cpu_imgs]),
                 count=np.stack([im.count.numpy() for im in cpu_imgs]))
        subprocess.run([sys.executable, str(here / "chip_smoke.py"),
                        "--sharded-cpu", tmp], check=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        got = np.load(Path(tmp) / "poses.npz")
        sc_gap = pose_gap(got["t"], got["q"], st_[:N_CPU_FRAMES],
                          sq_[:N_CPU_FRAMES])
        sc_same = bool(np.array_equal(got["n_edges"], sne[:N_CPU_FRAMES]))
    check(sc_gap[0] < 0.01 and sc_gap[1] < 1e-3,
          f"sharded card vs CPU path: {sc_gap}")
    check(sc_same, "sharded: card and CPU path picked different edge counts")
    emit({"phase": "sharded_cpu_parity", "frames": N_CPU_FRAMES,
          "backend": "gloo", "max_dt_m": sc_gap[0], "max_drot_rad": sc_gap[1],
          "same_n_edges": sc_same, "seconds": time.perf_counter() - t0})

    # ---- 11. the bench drive: steady-state time a frame -------------------
    bimgs = bench[0][0]
    bench_b = {b: stack_lanes([bench[s][0] for s in range(b)])
               for b in TIMED_BATCHES}
    # the drives twice, in turns (A B ... B A): the host sets the frame
    # time, and its speed drifts within a call
    drives = {
        "image_step": (
            lambda st, ims, _first: run_course(st, ims, cfg, keep=False),
            lambda: P.init_state(cfg), bimgs),
        "every_frame": (
            lambda st, ims, first: run_combined(*st, ims, ccfg, True, first,
                                                keep=False),
            lambda: S.init_combined(ccfg, MCFG), bimgs),
        "every_4th": (
            lambda st, ims, first: run_combined(*st, ims, ccfg, False, first,
                                                keep=False),
            lambda: S.init_combined(ccfg, MCFG), bimgs),
        "chained": (
            lambda st, ims, _first: run_chained(st, ims, cfg, keep=False),
            lambda: P.init_state(cfg), bimgs),
        "sharded": (
            lambda st, ims, _first: run_sharded(*st, ims, sstep, keep=False),
            lambda: CB.init_combined_image_sharded(ccfg, MCFG, mesh), bimgs),
    }
    for b in TIMED_BATCHES:
        drives[f"batch_{b}"] = (
            lambda st, ims, _first: run_course(st, ims, cfg, keep=False,
                                               step=P.batch_image_step),
            lambda b=b: init_batch_state(cfg, b), bench_b[b])
    runs = {name: [] for name in drives}
    for name in list(drives) + list(drives)[::-1]:
        drive, init, frames = drives[name]
        t_ms, t_host, poses, edges = timed_drive(drive, init(), frames)
        runs[name].append([t_ms, t_host])
        if name == "image_step":
            bposes, bedges = poses, edges
    for name, r in runs.items():
        # a batched frame gives every lane its pose: the budget is per lane
        worst = max(ms for ms, _ in r)
        check(worst <= FRAME_BUDGET_MS, f"{name}: {worst:.1f} ms/frame > "
              f"{FRAME_BUDGET_MS}")
    mean = {name: [float(np.mean([x[k] for x in r])) for k in (0, 1)]
            for name, r in runs.items()}
    ms_frame, host_ms = mean["image_step"]
    combined_timing = {c: {"ms_per_frame": mean[c][0],
                           "host_ms_per_frame": mean[c][1],
                           "scans_per_s": 1e3 / mean[c][0]}
                       for c in ("every_frame", "every_4th")}
    chained_timing = {"ms_per_frame": mean["chained"][0],
                      "host_ms_per_frame": mean["chained"][1],
                      "scans_per_s": 1e3 / mean["chained"][0]}
    sharded_timing = {"mesh": [1, 1], "ms_per_frame": mean["sharded"][0],
                      "host_ms_per_frame": mean["sharded"][1],
                      "scans_per_s": 1e3 / mean["sharded"][0],
                      "minus_combined_every_frame_ms":
                          mean["sharded"][0] - mean["every_frame"][0]}
    batch_timing = {}
    for b in TIMED_BATCHES:
        b_ms, b_host = mean[f"batch_{b}"]
        batch_timing[b] = {"ms_per_batched_frame": b_ms,
                           "host_ms_per_batched_frame": b_host,
                           "aggregate_scans_per_s": b * 1e3 / b_ms,
                           "vs_solo_scans_per_s": b * ms_frame / b_ms}
    bne = torch.stack(bedges).cpu().numpy()
    bt = torch.stack([p.t for p in bposes]).cpu().numpy()
    berr = np.linalg.norm(bt - gt_pos, axis=1)
    n_timed = N_FRAMES - N_WARM
    emit({"phase": "timing", "nvidia_smi": smi, "noise_m": 0.01,
          f"ate_m_first_{N_ATE}": float(np.sqrt(np.mean(berr[:N_ATE] ** 2))),
          "ate_m_all": float(np.sqrt(np.mean(berr ** 2))),
          "err_m_per_frame": berr.tolist(),
          "frames_timed": n_timed, "ms_per_frame": ms_frame,
          "scans_per_s": 1e3 / ms_frame,
          "host_ms_per_frame": host_ms,
          "realtime_factor_vs_10hz": (1e3 / ms_frame) / 10.0,
          "n_edges_min": int(bne.min()), "n_edges_max": int(bne.max()),
          "combined": combined_timing, "chained": chained_timing,
          "batch": batch_timing, "sharded_combined_image_step": sharded_timing,
          "runs_ms_and_host_ms_in_turns": runs})
    # the states every frame of the bench drive left, for the kernel checks
    # and the profile (untimed)
    bstates, _, _ = run_course(P.init_state(cfg), bimgs, cfg)
    bc_states, bc_poses, _ = run_combined(*S.init_combined(ccfg, MCFG), bimgs,
                                          ccfg)
    bb_states, bb_poses, _ = run_course(init_batch_state(cfg, LANES),
                                        bench_b[LANES], cfg,
                                        step=P.batch_image_step)
    bs_states, bs_poses, _ = run_sharded(
        *CB.init_combined_image_sharded(ccfg, MCFG, mesh), bimgs, sstep)
    b8_state = run_course(init_batch_state(cfg, max(TIMED_BATCHES)),
                          bench_b[max(TIMED_BATCHES)][:N_FRAMES - 5], cfg,
                          keep=False, step=P.batch_image_step)[0][-1]

    # ---- 12. each kernel against its plain version, bench shapes ---------
    img = bimgs[N_FRAMES - 1]
    sm_k = SM.smoothness_cuda(img.xyz, img.count)
    sm_p = SM.smoothness_plain(img.xyz, img.count)
    k1_err = float((sm_k - sm_p).abs().max())
    check(torch.equal(sm_k, sm_p), f"K1 not bit-exact (max err {k1_err})")

    ec_k = SEL.select_edges_cuda(img, sm_k, cfg)
    ec_p = SEL.select_edges_plain(img, sm_k, cfg)
    k2_same = (torch.equal(ec_k.valid, ec_p.valid)
               and torch.equal(ec_k.xyz, ec_p.xyz))
    k2_err = float((ec_k.xyz - ec_p.xyz).abs().max()) + float(
        (ec_k.valid != ec_p.valid).sum())
    check(k2_same, "K2 edges not bit-exact")
    # K2 above the JAX kernel's 128 slots a ring: 8 x 21 = 168
    cfg168 = cfg.replace(edges_per_region=20)
    ec168_k = SEL.select_edges_cuda(img, sm_k, cfg168)
    ec168_p = SEL.select_edges_plain(img, sm_k, cfg168)
    k2_168 = (torch.equal(ec168_k.valid, ec168_p.valid)
              and torch.equal(ec168_k.xyz, ec168_p.xyz))
    check(k2_168, "K2 at 168 slots a ring not bit-exact")
    # the walk's dependent steps a ring on this frame (its model)
    _, w_val, w_stats = SEL.select_walk(
        sm_k.cpu(), SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq).cpu(),
        img.count.cpu(), cfg)
    check(torch.equal(w_val.reshape(-1), ec_p.valid.cpu()),
          "K2's walk model differs from the plain pick chain")
    check(w_stats["overflow"] == 0, "K2's walk ran out of a region's list")

    # K3 on the matching map the last frame met (the window of the 5
    # frames before it) and on the last frame's edges at its pose
    map_xyz, map_valid = local_map.flatten(bstates[-2].window)
    map_xyz, map_valid = KNN.spatial_sort_points(map_xyz, map_valid)
    qxyz, qvalid = local_map.compact(ec_k.xyz, ec_k.valid)
    query = se3.transform(bposes[-1], qxyz)
    radius = cfg.knn_max_sq_dist ** 0.5
    prep = KNN.knn_prepare(query, qvalid, map_xyz, map_valid, radius,
                           ref_presorted=True)
    d_k, c_k = KNN.knn_launch(*prep)
    d_p, c_p = KNN.knn_coords_plain(query, qvalid, map_xyz, map_valid)
    near = d_p < cfg.knn_max_sq_dist
    rel = ((d_k - d_p).abs() / torch.clamp(d_p.abs(), min=1e-12))[near]
    k3_rel = float(rel.max()) if rel.numel() else 0.0
    k3_abs = float((d_k - d_p).abs()[near].max()) if rel.numel() else 0.0
    gate = qvalid & (d_p[:, -1] < cfg.knn_max_sq_dist)
    k3_coords_same = torch.equal(c_k[gate], c_p[gate])
    check(k3_rel <= 1e-5, f"K3 d2 rel err {k3_rel:.2e} > 1e-5")
    check(k3_coords_same, "K3 coordinates differ where the gate passes")

    # K4 at B = 4: the bench lanes' last frames at their poses against the
    # windows they met; each lane must be K3 on that lane, bit for bit
    bimg = bench_b[LANES][N_FRAMES - 1]
    ec_b = F.select_edges(bimg, F.smoothness(bimg, cfg), cfg)   # (B, E)
    qxyz_b, qvalid_b = local_map.compact(ec_b.xyz, ec_b.valid)
    query_b = se3.transform(bb_poses[-1], qxyz_b)
    map_b, mvalid_b = KNN.spatial_sort_points(
        *local_map.flatten(bb_states[-2].window))
    prep_b = KNN.knn_prepare_batched(query_b, qvalid_b, map_b, mvalid_b,
                                     radius, ref_presorted=True)
    d_b, c_b = KNN.knn_launch_batched(*prep_b)
    k4_is_k3 = True
    for s_ in range(LANES):
        d_s, c_s = KNN.knn_launch(*KNN.knn_prepare(
            query_b[s_], qvalid_b[s_], map_b[s_], mvalid_b[s_], radius,
            ref_presorted=True))
        k4_is_k3 &= torch.equal(d_b[s_], d_s) and torch.equal(c_b[s_], c_s)
    d_bp, c_bp = KNN.knn_coords_batched_plain(query_b, qvalid_b, map_b,
                                              mvalid_b)
    near_b = d_bp < cfg.knn_max_sq_dist
    rel_b = ((d_b - d_bp).abs() / torch.clamp(d_bp.abs(), min=1e-12))[near_b]
    k4_rel = float(rel_b.max()) if rel_b.numel() else 0.0
    k4_abs = float((d_b - d_bp).abs()[near_b].max()) if rel_b.numel() else 0.0
    gate_b = qvalid_b & (d_bp[..., -1] < cfg.knn_max_sq_dist)
    k4_coords_same = torch.equal(c_b[gate_b], c_bp[gate_b])
    check(k4_is_k3, "K4 differs from K3 launched on a lane alone")
    check(k4_rel <= 1e-5, f"K4 d2 rel err {k4_rel:.2e} > 1e-5")
    check(k4_coords_same, "K4 coordinates differ where the gate passes")

    # K6 on K3's inputs (its flags are K3's: the radius is sqrt(max_sq_dist))
    prep_l = tuple(x[None] for x in prep)
    gates = (cfg.knn_max_sq_dist, cfg.eig_ratio, cfg.min_line_sep)
    lpa_k, lpb_k, ok_k = (x[0] for x in KNN.knn_lines_launch(*prep_l, *gates))
    lpa_p, lpb_p, ok_p = KNN.knn_lines_plain(query, qvalid, map_xyz,
                                             map_valid, KNN.K, *gates)
    both = ok_k & ok_p
    k6_same = (torch.equal(lpa_k[both], lpa_p[both])
               and torch.equal(lpb_k[both], lpb_p[both]))
    k6_diff = torch.cat([(lpa_k - lpa_p)[both], (lpb_k - lpb_p)[both]])
    k6_err = float(k6_diff.abs().max()) if k6_diff.numel() else 0.0
    zm = c_p - c_p.mean(dim=1, keepdim=True)
    eigs = NB.sym3_eigenvalues(torch.einsum("eki,ekj->eij", zm, zm))
    at_ratio = ((eigs[:, 2] - cfg.eig_ratio * eigs[:, 1]).abs()
                <= 1e-4 * eigs[:, 2].abs())
    flips = ok_k != ok_p
    k6_flips, k6_off = int(flips.sum()), int((flips & ~at_ratio).sum())
    check(k6_same, "K6 endpoints differ where both accept")
    check(k6_off == 0, f"K6: {k6_off} gate flips away from the ratio "
          f"boundary")

    # the walk's tie order, bit for bit on every slot against the keyed
    # (d2, index) selection: K3 and K6 on K3's inputs above, K4 and K6 on
    # K4's, and both on tie-heavy scenes (one pair; 4 distinct as a batch)
    ties = {"bench": walk_vs_oracle(prep, gates),
            f"bench_b{LANES}": walk_vs_oracle(prep_b, gates)}
    scenes = [tie_scene(s_, 3000, 20000) for s_ in range(LANES)]
    tq, tqm, tr, trm = (torch.from_numpy(np.stack([sc[i] for sc in scenes]))
                        .to(dev) for i in range(4))
    ties["tie_scene"] = walk_vs_oracle(
        KNN.knn_prepare(tq[0], tqm[0], tr[0], trm[0], radius), gates)
    ties[f"tie_scene_b{LANES}"] = walk_vs_oracle(
        KNN.knn_prepare_batched(tq, tqm, tr, trm, radius), gates)
    for name, tv in ties.items():
        check(tv["d2_equal"] and tv["coords_equal"],
              f"kNN walk ({name}): d2 or coordinates differ from the "
              f"(d2, index) selection")
        check(tv["k6_endpoints_equal"],
              f"K6 ({name}): endpoints differ from the (d2, index) selection")
        check(tv["k6_gate_flips_off_ratio_boundary"] == 0,
              f"K6 ({name}): gate flips away from the ratio boundary")
    n_tied = ties["tie_scene"]["rows_with_a_tie_within_1m"]
    check(n_tied > 1000, f"the tie scene has {n_tied} rows with a tie")
    # K7 on the bench map after the last frame (every-frame cadence), at
    # the last pose: at the bench capacity and at one that truncates
    kmap = bc_states[-1][1]
    kbase = G.cell_keys(torch.trunc(bc_poses[-1].t), MCFG)
    koffs = G.local_map_offsets(MCFG)
    cap = MCFG.local_map_capacity
    k7 = {}
    for kcap in (cap, 1024):
        got = K7.compact_hits_cuda(kmap.xyz, kmap.key, kmap.valid, kbase,
                                   koffs, kcap)
        want = K7.compact_hits_plain(kmap.xyz, kmap.key, kmap.valid, kbase,
                                     koffs, kcap)
        same = (int(got[2]) == int(want[2]) and torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1]))
        k7[kcap] = {"capacity": kcap, "n_hits": int(got[2]),
                    "bit_exact": same,
                    "max_abs_err": float((got[0] - want[0]).abs().max())}
        check(same, f"K7 not bit-exact at capacity {kcap}")
    k7_hits = k7[cap]["n_hits"]
    check(k7_hits > 1024, f"K7: capacity 1024 did not truncate ({k7_hits})")

    # the probe kernel on the table the last frame met and that frame's
    # codes at its pose; its table must also be the one the drive produced
    pmap = bc_states[-2][1]
    pvalid = ec_k.valid
    pcode = G._packed_codes(se3.transform(bc_poses[-1], ec_k.xyz), pvalid,
                            MCFG)
    got = PI.probe_insert_cuda(pmap.code, pcode, pvalid)
    want = PI.probe_insert_plain(pmap.code, pcode, pvalid)
    probe_same = all(torch.equal(x, y) for x, y in zip(got, want))
    probe_drive = torch.equal(got[0], kmap.code)
    check(probe_same, "probe kernel: table, slots or flags differ from the "
          "plain rounds")
    check(probe_drive, "probe kernel: table differs from the drive's map")

    # K5 on the matching map the sharded flagship's last frame met (its
    # window slots and received map after the frame before) and on that
    # frame's edges (the gathered slots, not compacted) at its pose: the
    # path's call (no radius) and with a radius of 1 m
    s_map, s_valid = CB.matching_shard(bs_states[-2][0], 1, 0,
                                       ccfg.local_map_size)
    s_query = se3.transform(bs_poses[-1], ec_k.xyz)
    d5_p, i5_p = KNN.knn_index_plain(s_query, ec_k.valid, s_map, s_valid)
    k5 = {}
    for name, rad in (("no_radius", None), ("radius_1m", radius)):
        d5_k, i5_k = KNN.knn_index_cuda(s_query, ec_k.valid, s_map, s_valid,
                                        max_radius=rad)
        lim = d5_p < (rad * rad if rad else 1e29)
        near5 = d5_p < cfg.knn_max_sq_dist
        rel5 = ((d5_k - d5_p).abs()
                / torch.clamp(d5_p.abs(), min=1e-12))[near5]
        same_idx = torch.equal(i5_k[lim], i5_p[lim])
        k5[name] = {"compared": int(lim.sum()), "indices_equal": same_idx,
                    "d2_bit_equal": torch.equal(d5_k[lim], d5_p[lim]),
                    "max_rel_err": float(rel5.max()) if rel5.numel() else 0.0,
                    "max_abs_err": float((d5_k - d5_p).abs()[lim].max())}
        check(same_idx, f"K5 ({name}) indices differ from the plain version")
        check(k5[name]["max_rel_err"] <= 1e-5,
              f"K5 ({name}) d2 rel err {k5[name]['max_rel_err']:.2e}")
    prep5 = KNN.knn_prepare_batched(s_query[None], ec_k.valid[None],
                                    s_map[None], s_valid[None], None)
    m5 = s_map.shape[0]
    # every row bit for bit against the keyed selection: the path's call
    # and the tie scenes, without a radius
    k5_rows = {"bench": all(torch.equal(a, b) for a, b in zip(
        KNN.knn_index_launch(*prep5, m5),
        KNN.knn_index_launch_plain(*prep5, m5)))}
    for name, t_prep in (("tie_scene", KNN.knn_prepare_batched(
            tq[:1], tqm[:1], tr[:1], trm[:1], None)),
            (f"tie_scene_b{LANES}", KNN.knn_prepare_batched(
                tq, tqm, tr, trm, None))):
        k5_rows[name] = all(torch.equal(a, b) for a, b in zip(
            KNN.knn_index_launch(*t_prep, tr.shape[1]),
            KNN.knn_index_launch_plain(*t_prep, tr.shape[1])))
    for name, ok in k5_rows.items():
        check(ok, f"K5 ({name}): d2 or indices differ from the (d2, index) "
              f"selection")
    # one kernel a call: no merge kernel, no partial lists
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as k5_prof:
        KNN.knn_index_launch(*prep5, m5)
        torch.cuda.synchronize()
    k5_kernels = [e.name for e in k5_prof.events()
                  if e.device_type == DeviceType.CUDA]
    check(len(k5_kernels) == 1, f"K5 ran {k5_kernels} in one call")

    # the kNN kernels at other k, bit for bit on every slot against the
    # keyed selection on the bench inputs
    other_k = {}
    for kk in OTHER_K:
        got3 = KNN.knn_launch(*prep, k=kk)
        got4 = KNN.knn_launch_batched(*prep_b, k=kk)
        got5 = KNN.knn_index_launch(*prep5, m5, k=kk)
        got6 = KNN.knn_lines_launch(*prep_l, *gates, k=kk)
        want3 = KNN.knn_launch_plain(*prep, k=kk)
        want4 = KNN.knn_launch_plain(*prep_b, k=kk)
        want5 = KNN.knn_index_launch_plain(*prep5, m5, k=kk)
        want6 = KNN.knn_lines_launch_plain(*prep_l, *gates, k=kk)
        near = want3[1][None]
        zm = near - near.mean(dim=-2, keepdim=True)
        eigs = NB.sym3_eigenvalues(torch.einsum("...ki,...kj->...ij", zm,
                                                zm))
        at_ratio = ((eigs[..., 2] - cfg.eig_ratio * eigs[..., 1]).abs()
                    <= 1e-4 * eigs[..., 2].abs())
        flips = got6[2] != want6[2]
        other_k[kk] = {
            "knn_coords_equal": all(torch.equal(a, b)
                                    for a, b in zip(got3, want3)),
            "knn_coords_batched_equal": all(torch.equal(a, b)
                                            for a, b in zip(got4, want4)),
            "knn_index_equal": all(torch.equal(a, b)
                                   for a, b in zip(got5, want5)),
            "knn_lines_endpoints_equal": (torch.equal(got6[0], want6[0])
                                          and torch.equal(got6[1], want6[1])),
            "knn_lines_gate_flips": int(flips.sum()),
            "knn_lines_gate_flips_off_ratio_boundary":
                int((flips & ~at_ratio).sum()),
            "rows_accepted": int(want6[2].sum())}
        for key in ("knn_coords_equal", "knn_coords_batched_equal",
                    "knn_index_equal", "knn_lines_endpoints_equal"):
            check(other_k[kk][key], f"k={kk}: {key} is False")
        check(other_k[kk]["knn_lines_gate_flips_off_ratio_boundary"] == 0,
              f"k={kk}: K6 gate flips away from the ratio boundary")

    flags = prep[2]
    n_e, n_m = flags.shape
    flagged = int(flags.sum())
    flagged_b = int(prep_b[2].sum())
    flagged5 = int(prep5[2].sum())
    emit({"phase": "kernels",
          "smoothness": {"bit_exact": torch.equal(sm_k, sm_p),
                         "max_abs_err": k1_err},
          "select_edges": {"bit_exact": k2_same,
                           "n_edges": int(ec_k.valid.sum()),
                           "slots_168_bit_exact": k2_168,
                           "n_edges_168": int(ec168_k.valid.sum()),
                           "walk_steps_per_ring_max": max(w_stats["steps"]),
                           "walk_entries_visited_max":
                               max(w_stats["visited"])},
          "knn_coords": {"queries": int(qvalid.sum()),
                         "refs": int(map_valid.sum()),
                         "E": query.shape[0], "M": map_xyz.shape[0],
                         "pairs_within_1m": int(near.sum()),
                         "gated_rows": int(gate.sum()),
                         "max_rel_err": k3_rel, "max_abs_err": k3_abs,
                         "coords_equal": k3_coords_same,
                         "tile_pairs": n_e * n_m, "flagged_pairs": flagged,
                         "pruned_fraction": 1.0 - flagged / (n_e * n_m)},
          "knn_coords_batched": {"batch": LANES,
                                 "queries": qvalid_b.sum(-1).tolist(),
                                 "refs": mvalid_b.sum(-1).tolist(),
                                 "bit_identical_to_k3_per_lane": k4_is_k3,
                                 "max_rel_err": k4_rel, "max_abs_err": k4_abs,
                                 "coords_equal": k4_coords_same,
                                 "tile_pairs": prep_b[2].numel(),
                                 "flagged_pairs": flagged_b},
          "knn_walk_tie_order": ties,
          "knn_lines": {"accepted_kernel": int(ok_k.sum()),
                        "accepted_plain": int(ok_p.sum()),
                        "endpoints_equal": k6_same,
                        "gate_flips": k6_flips,
                        "gate_flips_off_ratio_boundary": k6_off},
          "local_map_compact": {"rows": kmap.xyz.shape[0],
                                "occupied": int(kmap.valid.sum()),
                                "targets": len(koffs),
                                "checks": list(k7.values())},
          "knn_index": {"queries": int(ec_k.valid.sum()),
                        "refs": int(s_valid.sum()), "E": s_query.shape[0],
                        "M": m5, "tile_pairs": prep5[2].numel(),
                        "flagged_pairs": flagged5,
                        "rows_equal_to_keyed_selection": k5_rows,
                        "kernels_a_call": k5_kernels, **k5},
          "knn_other_k": other_k,
          "probe_insert": {"bit_exact": probe_same,
                           "table_equals_drive": probe_drive,
                           "table_slots": pmap.code.shape[0],
                           "occupied_before": int(pmap.valid.sum()),
                           "codes": int(pvalid.sum()),
                           "claimed": int(got[2].sum()),
                           "failed": int(got[3].sum())}})

    r, w = img.xyz.shape[:2]
    k1_ms = cuda_ms(lambda: SM.smoothness_cuda(img.xyz, img.count), 100)
    k1_plain = cuda_ms(lambda: SM.smoothness_plain(img.xyz, img.count), 20)
    interior = int(torch.clamp(img.count - 10, min=0).sum())
    k1_bound = bound(img.xyz.numel() * 4 + r * 4 + r * w * 4,
                     interior * (3 * 12 + 5))

    k2_ms = cuda_ms(lambda: SEL.select_edges_cuda(img, sm_k, cfg), 50)
    k2_plain = cuda_ms(lambda: SEL.select_edges_plain(img, sm_k, cfg), 3, 1)
    slots = cfg.scan_regions * cfg.max_edges_per_region
    # scanned columns: per ring and region, (picks made + the failing one,
    # at most max_picks) passes over the region
    bval = ec_k.valid.reshape(r, cfg.scan_regions, cfg.max_edges_per_region)
    passes = torch.clamp(bval.sum(-1) + 1, max=cfg.max_edges_per_region)
    region_len = (torch.clamp(img.count - 10, min=0) // cfg.scan_regions)
    scanned = int((passes * region_len[:, None]).sum())
    # reads the smoothness plane, the counts and the image (gap flags),
    # writes the slots; 8 operations a column for the gaps, 2 compares a
    # scanned column
    k2_bound = bound(r * w * 4 + r * 4 + img.xyz.numel() * 4
                     + r * slots * (4 + 4 + 12), 8 * r * w + 2 * scanned)
    # the longest ring's chain of dependent walk steps, one shared-memory
    # step each
    k2_latency_ms = max(w_stats["steps"]) * WALK_STEP_S * 1e3
    k2_shape = SEL.select_shape(w, cfg.scan_regions, cfg.max_edges_per_region)
    check(k2_shape["dynamic_smem_bytes"] == SEL.select_smem_bytes(
        w, cfg.scan_regions, cfg.max_edges_per_region),
        f"K2's shared memory {k2_shape} differs from the wrapper's count")

    k3_ms = cuda_ms(lambda: KNN.knn_launch(*prep), 50)
    k3_wrapper_ms = cuda_ms(lambda: KNN.knn_coords_cuda(
        query, qvalid, map_xyz, map_valid, max_radius=radius,
        ref_presorted=True), 50)
    k3_plain = cuda_ms(lambda: KNN.knn_coords_plain(
        query, qvalid, map_xyz, map_valid), 3, 1)
    q4, r4 = prep[0], prep[1]
    e_q = query.shape[0]
    k3_bound = bound(q4.numel() * 4 + r4.numel() * 4 + flags.numel() * 4
                     + e_q * 4 + e_q * KNN.K * 4 * 4,
                     flagged * KNN.TILE_E * KNN.TILE_M * 8)

    k4_ms = cuda_ms(lambda: KNN.knn_launch_batched(*prep_b), 50)
    k4_wrapper_ms = cuda_ms(lambda: KNN.knn_coords_batched_cuda(
        query_b, qvalid_b, map_b, mvalid_b, max_radius=radius,
        ref_presorted=True), 50)
    k4_plain = cuda_ms(lambda: KNN.knn_coords_batched_plain(
        query_b, qvalid_b, map_b, mvalid_b), 3, 1)
    e_b = query_b.shape[0] * query_b.shape[1]
    # K3's bytes for each lane and the flagged pairs of all lanes
    k4_bound = bound(prep_b[0].numel() * 4 + prep_b[1].numel() * 4
                     + prep_b[2].numel() * 4 + e_b * 4 + e_b * KNN.K * 4 * 4,
                     flagged_b * KNN.TILE_E * KNN.TILE_M * 8)

    k6_ms = cuda_ms(lambda: KNN.knn_lines_launch(*prep_l, *gates), 50)
    k6_plain = cuda_ms(lambda: KNN.knn_lines_plain(
        query, qvalid, map_xyz, map_valid, KNN.K, *gates), 3, 1)
    # K3's inputs; out two endpoints and a flag a query; K3's flagged-pair
    # operations plus the epilogue's
    k6_bound = bound(q4.numel() * 4 + r4.numel() * 4 + flags.numel() * 4
                     + e_q * 4 + e_q * (2 * 12 + 1),
                     flagged * KNN.TILE_E * KNN.TILE_M * 8
                     + e_q * K6_OPS_PER_QUERY)

    k5_ms = cuda_ms(lambda: KNN.knn_index_launch(*prep5, m5), 50)
    k5_wrapper_ms = cuda_ms(lambda: KNN.knn_index_cuda(
        s_query, ec_k.valid, s_map, s_valid), 50)
    k5_plain = cuda_ms(lambda: KNN.knn_index_plain(
        s_query, ec_k.valid, s_map, s_valid), 3, 1)
    e5 = s_query.shape[0]
    # reads the prepared queries, refs, flags and permutation once, writes
    # d2 and an index a neighbour; without a radius an exact 5-NN needs
    # every valid query against every valid ref, 8 operations a distance
    # (the flagged tile pairs' slots, invalid ones included, beside it)
    k5_bytes = sum(t.numel() * 4 for t in prep5) + e5 * KNN.K * 8
    k5_bound = bound(k5_bytes,
                     int(ec_k.valid.sum()) * int(s_valid.sum()) * 8)
    k5_tile_bound = bound(k5_bytes, flagged5 * KNN.TILE_E * KNN.TILE_M * 8)

    kargs = (kmap.xyz, kmap.key, kmap.valid, kbase, koffs, cap)
    k7_ms = cuda_ms(lambda: K7.compact_hits_cuda(*kargs), 100)
    k7_plain = cuda_ms(lambda: K7.compact_hits_plain(*kargs), 10, 2)
    c_rows, occupied = kmap.xyz.shape[0], int(kmap.valid.sum())
    # reads the mask, the keys of the occupied rows (no other row can hit)
    # and the hit rows it keeps, writes the buffer, its mask and the count;
    # 3 compares an occupied row and target
    k7_bound = bound(c_rows + occupied * 12 + min(k7_hits, cap) * 12
                     + cap * (12 + 1) + 4, occupied * len(koffs) * 3)

    pargs = (pmap.code, pcode, pvalid)
    probe_ms = cuda_ms(lambda: PI.probe_insert_cuda(*pargs), 100)
    clone_ms = cuda_ms(lambda: pmap.code.clone(), 100)
    probe_plain = cuda_ms(lambda: PI.probe_insert_plain(*pargs), 5, 1)
    n_tab, e_p = pmap.code.shape[0], pcode.shape[0]
    # the function returns a new table: it reads and writes the table once,
    # reads the codes and the mask, writes slots and two flags
    probe_bound = bound(2 * n_tab * 8 + e_p * (8 + 1) + e_p * (4 + 1 + 1), 0)

    rows = [
        {"name": "smoothness", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/smoothness.cu",
         "replaces": "liodom_tpu/ops/smoothness_pallas.py:22",
         "launches": counts["smoothness"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "select_edges", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/select.cu",
         "replaces": "liodom_tpu/ops/select_pallas.py:70",
         "launches": counts["select_edges"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "latency_bound_ms": k2_latency_ms,
         "walk_steps_per_ring_max": max(w_stats["steps"]),
         **k2_shape, "ptxas": usage.get("select")},
        {"name": "knn_coords", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_coords.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:259",
         "launches": counts["knn_coords"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None,
         "wrapper_ms": k3_wrapper_ms,
         "unpruned_bound_ms": e_q * map_xyz.shape[0] * 8
         / FP32_OPS_PER_S * 1e3,
         **walk_row(ties["bench"], "knn_coords", n_m),
         "ptxas_k5": usage_at_k(usage.get("knn_coords"), "knn_coords_kernel",
                                5),
         "ptxas_k8": usage_at_k(usage.get("knn_coords"), "knn_coords_kernel",
                                8)},
        {"name": "knn_coords_batched", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_coords.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:526",
         "launches": lcounts["knn_coords_batched"], "max_abs_err": k4_abs,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "library_ms": None, "batch": LANES,
         "wrapper_ms": k4_wrapper_ms,
         **walk_row(ties[f"bench_b{LANES}"], "knn_coords",
                   prep_b[2].shape[-1]),
         "ptxas_k5": usage_at_k(usage.get("knn_coords"), "knn_coords_kernel",
                                5)},
        {"name": "knn_index", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_index.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:44",
         "launches": scounts["knn_index"],
         "max_abs_err": k5["no_radius"]["max_abs_err"], "ms": k5_ms,
         "plain_ms": k5_plain, "bound_ms": k5_bound[0],
         "bound_by": k5_bound[1], "library_ms": None,
         "wrapper_ms": k5_wrapper_ms, "flagged_pairs": flagged5,
         "tile_pair_bound_ms": k5_tile_bound[0],
         "kernels_a_call": len(k5_kernels),
         "flagged_tiles_per_query_tile_max":
             int(prep5[2].sum(-1).max()),
         "flagged_tiles_per_query_tile_mean":
             float(prep5[2].sum(-1).float().mean()),
         **KNN.knn_walk_shape("knn_index", prep5[2].shape[-1]),
         "ptxas_k5": usage_at_k(usage.get("knn_index"), "knn_index_kernel",
                                5),
         "ptxas_k8": usage_at_k(usage.get("knn_index"), "knn_index_kernel",
                                8)},
        {"name": "knn_lines", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_lines.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:580",
         "launches": lines["image_step"]["launches"]["knn_lines"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain,
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1],
         "library_ms": None, "gate_flips": k6_flips,
         **walk_row(ties["bench"], "knn_lines", n_m),
         "ptxas_k5": usage_at_k(usage.get("knn_lines"), "knn_lines_kernel",
                                5),
         "ptxas_k8": usage_at_k(usage.get("knn_lines"), "knn_lines_kernel",
                                8)},
        {"name": "local_map_compact", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/local_map_compact.cu",
         "replaces": "scripts/compact_pallas_experiment.py:50",
         "launches": ccounts["local_map_compact"],
         "max_abs_err": max(v["max_abs_err"] for v in k7.values()),
         "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": k7_bound[0],
         "bound_by": k7_bound[1], "library_ms": None, "n_hits": k7_hits},
        {"name": "probe_insert", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/probe_insert.cu",
         "replaces": "none: liodom_tpu/mapping/grid.py:200 is a "
                     "lax.while_loop, no TPU kernel",
         "launches": ccounts["probe_insert"],
         "max_abs_err": 0.0 if probe_same else float("nan"),
         "ms": probe_ms, "plain_ms": probe_plain,
         "bound_ms": probe_bound[0], "bound_by": probe_bound[1],
         "library_ms": None, "table_copy_ms": clone_ms},
    ]

    # ---- 13. where a frame's device time goes ----------------------------
    # the bench drive's last frames again, from the states they met
    n_prof = 5
    last = bimgs[N_FRAMES - n_prof:]
    emit({"phase": "profile",
          "image_step": profile_frames(
              lambda st, im: P.image_step(st, im.xyz, im.count, cfg)[0],
              bstates[N_FRAMES - n_prof - 1], last, smi),
          "combined_image_step": profile_frames(
              lambda st, im: S.combined_image_step(
                  *st, im.xyz, im.count, ccfg, MCFG, step=0,
                  local_map_every=4)[:2],
              bc_states[N_FRAMES - n_prof - 1], last, smi),
          f"batch_image_step_b{LANES}": profile_frames(
              lambda st, im: P.batch_image_step(st, im.xyz, im.count, cfg)[0],
              bb_states[N_FRAMES - n_prof - 1],
              bench_b[LANES][N_FRAMES - n_prof:], smi),
          f"batch_image_step_b{max(TIMED_BATCHES)}": profile_frames(
              lambda st, im: P.batch_image_step(st, im.xyz, im.count, cfg)[0],
              b8_state, bench_b[max(TIMED_BATCHES)][N_FRAMES - n_prof:],
              smi),
          "sharded_combined_image_step": profile_frames(
              lambda st, im: sstep(*st, im.xyz, im.count)[:2],
              bs_states[N_FRAMES - n_prof - 1], last, smi)})
    dist.destroy_process_group()

    if failures:
        emit({"phase": "failed", "failures": failures})
        return 1
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
