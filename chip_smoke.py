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
6. raw_path — the raw-scan front end on phase 2's raw scans, which
   ``RawScan.from_points`` put on the card, counters set to 0 just before
   and read just after each drive, no host synchronisation in any:
   ``full_step`` (``lidar_type`` 0, 36 frames): K1 and K2 once a frame, K3
   twice, poses ``torch.equal`` to phase 2's ``image_step`` (fed the card's
   own ``split_scan`` of the same scans), equal edge counts, ATE over 20
   frames below 0.1 m; ``combined_step`` (36 frames, the local map
   refreshed every frame): K1, K2, K7 and the probe once a frame, K3
   twice, overflow 0, no local map truncated, ATE below 0.1 m, and each
   frame's pose ``torch.equal`` to phase 4's when started from phase 4's
   state before that frame (the free-running drive is held to phase 4 at
   1 cm and 1e-3 rad over the first 20 frames, as the sharded and lines
   drives are, and its equal frames are counted); the Ouster path
   (``liodom_tpu/core/presets.py:ouster_preset(128)``: 128 rings, a
   15-frame window, ring width 4,096), ``full_step`` fed 128 x 2,048
   organised clouds that the port's ``organized_from_unorganized`` makes
   from the same spins: launches 36/36/72, every pose finite, ATE over 20
   frames below 0.1 m, its first 6 frames within 1 cm and 1e-3 rad of the
   port's CPU path with equal edge counts.
7. filtered_path — ``image_step`` with ``filter_local_map=True`` (the
   window voxel-filtered at 0.4 m once full, chosen on the device) over
   phase 2's images: launches 36/36/72, ATE over 20 frames below 0.1 m, no
   host synchronisation, its first 6 frames within 1 cm and 1e-3 rad of
   the CPU path with equal edge counts.
8. batch_path — 36 frames of ``batch_image_step`` at B = 4 over 4 distinct
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
9. chained_path — the drive of phase 2 through ``chained_image_step`` in
   chunks of 12 frames (``bench.py:147``), and again with ``use_imu=True``
   and the drive's per-frame orientation as IMU quaternions: poses within
   1e-6 m of the per-frame loop's (phase 2's poses, and a ``set_imu`` then
   ``image_step`` loop), launches 36/36/72, no host synchronisation.
10. lines_path — phases 2 and 4 again under ``LIODOM_KNN_IMPL=pallas_lines``:
   K6 twice a frame and K3 never, ATE over 20 frames below 0.1 m, poses
   within 1 cm and 1e-3 rad of the ``pallas_coords`` runs over those 20
   frames (every frame's gap printed), no host synchronisation.
11. sharded_path — the parallel layer on a one-rank NCCL mesh (data 1 x
   map 1; a process group on a free local port, its communicators created
   before any drive): 36 frames of ``make_sharded_combined_image_step`` at
   the combined configuration, counters set to 0 just before and read just
   after: K1, K2, K7 and the probe kernel once a frame, K5 twice, K3, K4
   and K6 never; ATE over 20 frames below 0.1 m, within 1 cm and 1e-3 rad
   of phase 4's ``combined_image_step`` over those 20 frames (every
   frame's gap printed), equal edge counts, overflow 0, no host
   synchronisation.  Then ``make_sharded_step`` on phase 8's 4 lanes as one
   local batch, fed ``select_edges``' edges (taken before the counters
   are reset): K5 twice a frame and nothing else, each lane within 1 cm and
   1e-3 rad of its solo ``image_step`` over 20 frames; then
   ``make_sharded_combined_step`` on lane 0's edges for 20 frames against
   ``combined_image_step`` on the same bar; then ``launch.smoke`` and
   ``launch.combined_smoke`` on the same mesh.
12. sharded_cpu_parity — the flagship's first 6 frames on the CPU in a
   one-rank gloo group (a subprocess: ``--sharded-cpu``): within 1 cm and
   1e-3 rad of the card, equal edge counts.
13. apps — the port's apps as a user runs them (``liodom_tpu_torch/apps``),
   on phase 2's 36 raw scans written as a KITTI tree (``.bin`` records, an
   identity ``Tr``, ``times.txt`` at 0.1 s, the drive's poses), each run
   with every launch counter set to 0 just before and read just after, one
   JSON line a run (frames, the kernels' build and load before frame 0,
   cold or warm, the first frame, scans/s after it, the host
   synchronisations between due points, the launches, the nvidia-smi
   line): ``run_kitti`` at its defaults (the launch file's 15-frame window,
   the ring width auto-sized) with results, a checkpoint at frame 24 and
   the PLY export: the five results files of 36 rows, poses within 1e-6 m
   of an ``image_step`` loop over ``KittiSequence.iter_images``, ATE over
   20 frames below 0.1 m, launches 36/36/72, the native loader built, no
   host synchronisation between due points; ``--chunk 12`` within 1e-6 m
   of it; ``--mapping`` (40/50 m cells, a 65,536-row local map): ATE below
   0.1 m, overflow and truncation 0, K7 37 times (36 frames and the
   end-of-run truncation check at the final pose, as the JAX app makes
   it) and the probe 36; the mapping run resumed from frame 24 in a new
   process started from a copy of the package without its build
   directories (the cold build, the native loader's included), within
   1 cm and 1e-3 rad of the uninterrupted run; the odometry run resumed
   in a second new process (the warm build), within 1e-6 m;
   ``run_synthetic`` at its defaults and with ``--mapping --raw-path``:
   ATE below 0.1 m; ``run_ouster --dir`` on the first 20 of phase 6's
   128 x 2,048 organised clouds written as ``.npy`` files (the 128-row
   preset): ATE below 0.1 m, launches 20/20/40, and a resume whose
   checkpoint covers every file returns 0 without a frame;
   ``run_mapping`` on ``run_kitti``'s poses: occupied slots and
   ``map.ply``.  Between the first two runs, ``image_step`` at
   ``run_kitti``'s configuration over the tree's frames staged from pinned
   buffers against frames copied from pageable memory, three drives each
   in turns: ms a frame to the last pose, host syncs a frame.  Then the
   warm start: ``run_kitti --aot``, ``--aot --chunk 12`` and ``--aot
   --mapping`` (the steps captured as CUDA graphs before frame 0, one a
   refresh pattern; the launch counters count the captures only) within
   1e-6 m of the eager runs (the map's within 1 cm and 1e-3 rad), and
   ``run_ouster --dir --aot`` within 1e-6 m, 0 host syncs between due
   points, the first frame and scans/s beside the eager run's.  Then
   ``run_stream`` (the streaming world pre-rendered in threads, the sensor
   thread at wall-clock 10 Hz into a queue of 1): at its defaults (100
   frames, a 5-frame window) every frame accounted for and output >= 0.8 x
   input (the watchdog's contract), ``--mapping`` (40 frames: the mapper
   thread, its truncation reads due points of its own) with the mapper
   folding >= 1 frame and no overflow or truncation, ``--rate 200
   --mapping`` (60 frames) with drops > 0, all counted, and the watchdog
   fired; launches K1/K2 once a processed frame plus the warm-up, K3
   twice, the probe once a folded frame and K7 every 4th, 0 host syncs
   between due points.  Then ``run_longcourse`` (8 render workers, the
   launch file's 15-frame window, a 2^20-slot map) at its defaults cut to
   400 frames (rc 0: overflow, truncation and ring drops 0; launches
   400/400/800, the probe 400, K7 at every 4th frame and each growth
   sample; map leaves and load, RPE@1, drift %, scans/s), a 300-frame
   course per frame with a checkpoint at frame 150, the same with
   ``--chunk 12`` (within 1 cm and 1e-3 rad over its first 36 frames, map
   leaves within 0.1 % at frame 300), with ``--imu`` (rc 0), and the
   checkpoint at 150 resumed in a new process (within 1 cm and 1e-3 rad
   of the uninterrupted run over the next 20 frames).  Run before the
   profiler, which leaves the host slower.
14. timing — the bench drive of ``bench.py`` (the same course with 1 cm
   sensor noise): steady-state ms/frame and scans/s by CUDA events after 6
   warm-up frames, for ``image_step``, for ``combined_image_step`` at the
   bench's two cadences (every frame, and every 4th frame), for
   ``batch_image_step`` at B = 4 and 8 (``bench.py:401``; lanes as in phase
   8, with noise: ms a batched frame and aggregate scans/s), for
   ``chained_image_step`` (chunks of 12), for the sharded flagship at
   mesh 1 x 1, for ``full_step`` on the raw scans and for the filtered
   ``image_step``, each drive twice in turns; every run at most 125 ms a
   frame for each lane (0.8 x the 10 Hz sensor rate).
15. aot — ``runtime/aot.get_or_compile`` captures ``image_step``,
   ``combined_image_step`` (cadence 1; cadence 4: a refreshing and a
   holding graph), ``chained_image_step`` and
   ``chained_combined_image_step`` (chunks of 12, cadence 4),
   ``batch_image_step`` at B = 4 and 8 and the sharded flagship on phase
   11's one-rank NCCL mesh (its kernels, K5's included, prepared before
   the warm calls by ``path_kernels(True, sharded=True)``) as CUDA
   graphs, the capture seconds reported; every replay under sync debug
   mode (0 syncs, the launch counters untouched): on phase 2's drive the
   odometry graphs' poses ``torch.equal`` to phase 2's and equal edge
   counts, the combined ones and the sharded flagship within 1 cm and
   1e-3 rad over 20 frames of the eager drive (the flagship's: phase
   11's) at their cadence, with the frames equal counted, and three
   poses kept across three calls distinct and equal to the eager ones;
   on the bench lanes the batch graphs' poses and edge counts
   ``torch.equal`` to an eager batch drive's; on the bench drive (the
   bench lanes for the batch), graph against eager ms a frame and host
   ms a frame, two drives each in turns by CUDA events after 12 warm-up
   frames (a finding, held only to the 125 ms limit).
16. stages — ``liodom_tpu_torch.tools.bench_stages`` in this process, its
   JSON line printed: each stage of the frame (K1, K2, the kNN and line
   fit with its prepare / K3 / line-fit sub-rows, the LM solve, the window
   push, the map update with its probe / sums sub-rows, K7) eager and
   captured alone as a CUDA graph, the fused steps eager, as a bare graph
   and chained through ``get_or_compile``: every row finite and > 0, every
   stage graph's outputs ``torch.equal`` to the eager stage's, the fused
   graphs equal to eager and at most 125 ms.
17. warm_cache — ``python -m liodom_tpu_torch.tools.warm_cache`` in a new
   process started from a copy of the package without its build
   directories (cold: the seven kernel sources and the native loader
   compiled), then in a second new process (warm: nothing compiled); the
   build seconds of each source and each program's CUDA context, library
   load, first and second eager call and capture.
18. bench — ``python -m liodom_tpu_torch.tools.bench`` (the port of
   ``bench.py``) in a new process at ``bench.py``'s sizes, with
   ``LIODOM_BENCH_BUDGET_S`` high enough that no phase is skipped, its rows
   printed as they came: every row and final key present, no
   ``parity_failed`` (each graph row against its eager run, the chained
   rows against their per-frame runs), no warning line (truncation,
   overflow, a failed gate), every lane at >= 8 scans/s eager and as a
   graph, exit code 0.
19. kernels — each kernel against its plain PyTorch version on the card, on
   the bench drive's last frame, window, map and pose: K1 bit-exact there
   and at every shape the port launches it with (``smoothness_cases``: the
   folded B = 4 and 8 rings, the Ouster path's 128 rings, a width of
   1,801, counts 0, <= 10 and the full width, one full ring, an unaligned
   tensor), timed at each beside two byte bounds (the whole image, and
   only the columns below each ring's count); the voxel filter's device
   time on a full 5- and 15-frame window; K2
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
   one that truncates, at 174 targets, on 100,003 rows, with no hit and at
   capacity 0: ``map_kernel_cases``, with its tiles and rows a thread),
   the probe kernel bit-exact table, slots, flags and rounds run (the
   bench frame, one row, no active row, 70,000 rows and a 256-slot table
   they exhaust), its rounds and a latency bound of two L2 trips a round
   beside the byte bound of its table copy, K5 on the sharded flagship's
   last frame and matching map, without a radius (the path's call) and
   with 1 m: indices identical wherever the plain d2 is finite (within the
   radius), d2 within 1e-5 relative where d2 < 1; the path's call and
   the tie scenes without a radius bit for bit on every row against
   ``knn_index_launch_plain``, one kernel a call
   under the profiler, its cluster blocks and thread groups beside its
   ptxas usage; K3, K4, K5 and K6 at k = 3, 8, 16 (the register walk,
   built for every 1 <= k <= 16), 17, 20, 32, 64 and 512 (ListWalk, its
   split over a cluster, its lists in shared memory, at 512 in device
   memory) bit for bit against
   ``knn_launch_plain`` / ``knn_index_launch_plain`` /
   ``knn_lines_launch_plain`` on the bench inputs (K6's gate as above),
   with ptxas registers and spills at k = 5 and 8 and of ListWalk's
   kernels (no static shared memory); ListWalk's own entry points at k =
   1, 5 and 16, bit for bit, and K4, K5 and K6 at 128 ref tiles of a tie
   lattice at the last k whose block's lists fit its shared memory and
   the first in device memory (both found from
   ``liodom_knn_any_k_shape``), bit for bit; the K3'-K6' rows carry the
   split built, K3''s times and bounds at k = 5-512.  The lifted
   limits (``lifted_limits`` line), each drive with its counters set to 0
   just before and read just after: ``image_step`` at ``knn_k=20`` over 20
   bench frames (K3 on ListWalk twice a frame; ATE reported, not held),
   its first 6 within 1 cm and 1e-3 rad of the CPU path with equal edge
   counts, and 6 frames each under ``pallas_lines`` (K6), of
   ``batch_image_step`` at B = 4 (K4) and of the sharded flagship (K5)
   within 1 cm and 1e-3 rad of their references; K2 at 64 seeded rings x
   49,152 columns (88 slots) and x 38,741 (424), past a block's shared
   memory, bidx, bval and points ``torch.equal`` to ``select_plain``, the
   same at 49,152 columns with 8 x 290 slots (a region's values in the
   device scratch) and 8 x 330 (the lists and slots there), its
   device-memory path also at the bench shape, and ``image_step`` at ring
   width 49,152 for 6 frames within 1e-6 m of the main drive; K7 at
   ``cells_xy=70`` (19,883 targets) on the combined drive's map at the
   bench capacity and at 1,024, its device-memory path also at 75 and 174
   targets, and 6 frames of ``combined_image_step`` at ``cells_xy=70``,
   every refresh equal to the plain version.  Then each kernel's time
   beside its plain version's and its bound, the new paths' too.  Also ``update_map_sparse_epilogue`` against ``update_map``
   over the combined drive's 36 frames at 524,288 and 2^20 slots: slots,
   keys, codes and overflow ``torch.equal``, centroids within 1e-5 m,
   the probe once a frame for each, ms a call, and whether two calls of
   each on one input give bit-equal centroids, and ``update_map_full`` at
   ``resolution=0.1`` (the sorted soup of a map that is not packable)
   called twice on one input: every field ``torch.equal``.  And the LM
   solve's row (its own ``lm_solve`` line, ``lm_solve_phase``):
   ``csrc/lm_solve.cu`` against ``lm_solve_plain`` on the card, on the
   bench frame's two calls and seeded problems (B = 1 and 8 at 5,632
   edges, ragged 1,000 and 37, 2 x 40,000 past the blocks' shared memory,
   no valid correspondence: the pose held, a start at the true pose:
   rounds rejected), within 1 mm and 1e-3 rad, reruns and each lane of a
   batch against its solo call bit for bit, each side's accepts and
   lambdas, ms a call of both, and 2 launches a frame of ``image_step``
   eager and in one replay of it captured.
20. profile — torch.profiler over 5 frames of the bench drive, for
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
import shutil
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
from liodom_tpu_torch.apps import (run_kitti, run_longcourse, run_mapping,
                                   run_ouster, run_stream, run_synthetic)
from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.io import KittiSequence
from liodom_tpu_torch.core.organize import organized_from_unorganized
from liodom_tpu_torch.core.presets import ouster_preset
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
from liodom_tpu_torch.ops import solver as SLV
from liodom_tpu_torch.ops import voxel as V
from liodom_tpu_torch.parallel import combined as CB
from liodom_tpu_torch.parallel import launch as LA
from liodom_tpu_torch.parallel.mesh import make_mesh
from liodom_tpu_torch.parallel.sharded import (all_gather, init_batch_state,
                                               make_sharded_step)
from liodom_tpu_torch.runtime import aot
from liodom_tpu_torch.runtime import checkpoint as CK
from liodom_tpu_torch.runtime import native
from liodom_tpu_torch.runtime.device_io import Stager, path_kernels
from liodom_tpu_torch.tools import bench_stages
# the card's peaks (H100 SXM data sheet: HBM3, FP32 outside the tensor
# cores), its nvidia-smi line, and device ms by CUDA events behind a
# device-side sleep, shared with the stage timer
from liodom_tpu_torch.tools.bench_stages import (
    FP32_OPS_PER_S, HBM_BYTES_PER_S, nvidia_smi_line)
from liodom_tpu_torch.tools.bench_stages import device_ms as cuda_ms

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
# the kNN kernels at k other than 5: the register walk to 16, ListWalk
# above (its lists in device memory at 512)
OTHER_K = (3, 8, 16, 17, 20, 32, 64, 512)
ANY_K = 20                  # knn_k of the drives on ListWalk
# ListWalk's shared-memory boundary is held at 128 ref tiles: the last k
# whose block's lists fit its 227 KB (16 KB of buffers, 512 bytes a
# neighbour and thread group, the filled counts, 4 bytes a ref tile and
# the count) and the first past it, both found from the library's shape
LIST_EDGE_TILES = 128
N_ANY_K = 6                 # frames of each drive past a limit
# K2 past a block's shared memory: (columns, edges_per_region): 8 x 11 and
# 8 x 53 slots a ring
WIDE_RINGS = ((49152, 10), (38741, 52))
# its layouts at 49,152 columns, (edges_per_region, what leaves shared
# memory): 8 x 290 slots leave too little room for a region's order keys,
# which each radix pass then reads from the plane; at 8 x 330 the lists
# and slots go to the device scratch, handed to rank 0 through global
# memory
SCRATCH_RINGS = ((289, "values"), (329, "lists"))
# K2' before its top-L redesign at WIDE_RINGS, ms (NVIDIA H100 80GB HBM3,
# 700.00 W; scripts/select_walk_experiment.py --earlier, that build in
# turns with this one; PERF.md, Findings)
K2W_EARLIER_MS = {(49152, 88): 5.3244527816772464,
                  (38741, 424): 3.4925535202026365}
CELLS_XY_WIDE = 70          # K7 past it: 141^2 XY keys plus the z column
# K7' before its fenced search at CELLS_XY_WIDE, ms (NVIDIA H100 80GB HBM3,
# 700.00 W; scripts/map_kernels_experiment.py --earlier, that build in
# turns with this one; PERF.md, Findings)
K7W_EARLIER_MS = 0.01892032027244568
# one dependent step of K2's walk: a shared-memory load and a warp vote,
# ~30 cycles at the H100's 1.98 GHz boost clock (published latency)
WALK_STEP_S = 30 / 1.98e9
# one dependent trip to L2 (a 64-bit ld.global.cg that hits; an atomic
# taken as the same), 141-148 ns in scripts/map_kernels_experiment.py's
# pointer chase over a 4 MB ring on the H100 80GB HBM3 at 700 W (PERF.md,
# Findings)
L2_TRIP_S = 145e-9
# bench.py's combined configuration (bench.py:91)
MCFG = MapConfig(map_capacity=524288, local_map_capacity=16384)
# the Ouster launch configuration at 128 rings (launch/liodom_ouster.launch:
# 19-33), and its organised width
OUSTER_CFG = ouster_preset(128)[0]
OUSTER_COLS = 2048


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the HBM time and the FP32 time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_COUNTED = {"smoothness": SM.smoothness_cuda,
            "select_edges": SEL.select_edges_cuda,
            "select_edges_global": SEL.select_edges_global_cuda,
            "knn_coords": KNN.knn_launch,
            "knn_coords_batched": KNN.knn_launch_batched,
            "knn_lines": KNN.knn_lines_launch,
            "knn_index": KNN.knn_index_launch,
            "knn_coords_any_k": KNN.knn_launch_any_k,
            "knn_coords_batched_any_k": KNN.knn_launch_batched_any_k,
            "knn_lines_any_k": KNN.knn_lines_launch_any_k,
            "knn_index_any_k": KNN.knn_index_launch_any_k,
            "local_map_compact": K7.compact_hits_cuda,
            "local_map_compact_global": K7.compact_hits_global_cuda,
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


def sass_of(so: Path, pattern: str) -> list:
    """The SASS instructions of the kernel whose name holds ``pattern`` in
    a built library, by ``cuobjdump`` beside ``nvcc``: no addresses,
    encodings or the anonymous namespace's per-file tag, so two builds of
    one kernel compare equal; [] where ``cuobjdump`` is missing."""
    dumper = Path(kernels.nvcc_path()).with_name("cuobjdump")
    if not dumper.exists():
        return []
    dump = subprocess.run([str(dumper), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, inside = [], False
    for ln in dump.splitlines():
        if "Function :" in ln:
            inside = pattern in ln
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if inside and m:
            out.append(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1)))
    return out


def usage_at_k(usage: dict, kernel: str, k: int) -> dict:
    """ptxas usage of the instantiation of template ``kernel`` at ``k``
    (its mangled name holds ``<kernel>ILi<k>E``)."""
    for name, u in (usage or {}).items():
        if re.search(rf"{kernel}ILi{k}E", name):
            return u
    return {}


def usage_of(usage: dict, pattern: str) -> dict:
    """ptxas usage of the entry function whose mangled name matches
    ``pattern`` (a non-template kernel, or one instantiation)."""
    for name, u in (usage or {}).items():
        if re.search(pattern, name):
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


def map_kernel_cases(kmap, kbase, pmap, pcode, pvalid, pxyz):
    """The inputs K7 and the probe kernel are held to, beside the path's
    own calls: ``({name: K7 args}, {name: probe args})``.

    K7 on the bench map ``kmap`` around ``kbase``: the bench neighbourhood
    (27 targets) at the bench capacity and at 1,024 (a truncating cut),
    ``cells_xy=6, cells_z=3`` (174 targets, past the 128 an earlier kernel
    took) at both, the map's first 100,003 rows (not a multiple of a
    tile), a base with no hit, and capacity 0.  The probe on the table
    ``pmap`` met by the bench frame's codes ``pcode``: the frame, one row,
    no active row, 70,000 rows around the frame's points ``pxyz`` (past
    the 16,384 the kernel keeps on chip, 2,048 a block of its cluster of
    8) and 20,000 of them into a 256-slot table, which they exhaust."""
    offs = G.local_map_offsets(MCFG)
    wide = G.local_map_offsets(MCFG, cells_xy=6, cells_z=3)
    cap = MCFG.local_map_capacity
    rows = 100_003
    m = (kmap.xyz, kmap.key, kmap.valid)
    head = tuple(t[:rows] for t in m)
    far = kbase + torch.tensor([4096, 0, 0], dtype=torch.int32,
                               device=kbase.device)
    k7 = {"bench": (*m, kbase, offs, cap),
          "bench_cap1024": (*m, kbase, offs, 1024),
          "targets174": (*m, kbase, wide, cap),
          "targets174_cap1024": (*m, kbase, wide, 1024),
          "rows100003": (*head, kbase, offs, cap),
          "no_hits": (*m, far, offs, 1024),
          "cap0": (*m, kbase, offs, 0)}
    g = torch.Generator().manual_seed(7)
    n_many = 70_000
    pick = torch.randint(0, pxyz.shape[0], (n_many,), generator=g)
    jitter = torch.randn((n_many, 3), generator=g) * 4.0
    many_xyz = pxyz[pick.to(pxyz.device)] + jitter.to(pxyz.device)
    many_valid = (torch.rand(n_many, generator=g) > 0.1).to(pxyz.device)
    many = G._packed_codes(many_xyz, many_valid, MCFG)
    small = torch.full((256,), G.EMPTY, dtype=torch.int64,
                       device=pmap.code.device)
    probe = {"bench": (pmap.code, pcode, pvalid),
             "one_row": (pmap.code, pcode[:1], torch.ones_like(pvalid[:1])),
             "inactive": (pmap.code, pcode, torch.zeros_like(pvalid)),
             "rows70000": (pmap.code, many, many_valid),
             "table256": (small, many[:20_000], many_valid[:20_000])}
    return k7, probe


def quat_angle(qa: np.ndarray, qb: np.ndarray) -> float:
    """Rotation angle between two wxyz quaternions, from the vector part of
    conj(qa) * qb: accurate near 0, where 2 acos(|qa . qb|) of float32
    quaternions floors at ~5e-4 rad (|qa . qb| = 1 - 3e-8)."""
    aw, av = float(qa[0]), qa[1:].astype(np.float64)
    bw, bv = float(qb[0]), qb[1:].astype(np.float64)
    w = aw * bw + float(av @ bv)
    v = aw * bv - bw * av - np.cross(av, bv)
    return 2.0 * math.atan2(float(np.linalg.norm(v)), abs(w))


def render_lanes(cfg: LiodomConfig, dev: torch.device, lanes, noise: float,
                 keep_raw=()):
    """Ring images of the lanes' drives: lane s is ``BoxWorld(seed=s)``
    driven at 1.2 m/frame and 0.01 (s + 1) rad/frame yaw (lane 0 is the
    drive of ``apps/run_synthetic.py`` and ``bench.py``), an 1800-column
    HDL-64 spin rendered in threads (noise seed 1000 s + frame), put on the
    card by ``RawScan.from_points`` and split there by the port's loader
    stage; no point may be dropped by the ring width.  Returns {lane:
    (images, positions, yaws, raw scans, spins)}, the raw scans (on the
    card) and the spins (numpy) for the lanes in ``keep_raw`` only."""
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
    raws = {s: [] for s in lanes}
    spins = {s: [] for s in lanes}
    for (s, i), scan in zip(jobs, scans):
        raw = RawScan.from_points(torch.from_numpy(scan), cfg.max_points,
                                  device=dev)
        dropped = int(F.split_overflow(raw, cfg))
        if dropped:
            raise SystemExit(f"lane {s} frame {i}: ring width "
                             f"{cfg.ring_width} dropped {dropped} points")
        imgs[s].append(F.split_scan(raw, cfg))
        if s in keep_raw:
            raws[s].append(raw)
            spins[s].append(scan)
    return {s: (imgs[s],) + drives[s] + (raws[s], spins[s]) for s in lanes}


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
                 first: int = 0, keep: bool = True, mcfg: MapConfig = MCFG):
    """Drive ``combined_image_step`` over the images (frames ``first``,
    ``first + 1``, ...) at the bench's map configuration.  ``every_frame``:
    refresh the local map each frame (``step=0``), else every 4th frame
    (``step=i``), the two cadences of ``bench.py``'s combined rows;
    ``mcfg`` the map configuration.
    Returns the (odometry, map) state after each frame (``keep=False``: the
    last one only), the poses and the edge counts, all on the device."""
    states, poses, n_edges = [], [], []
    for i, img in enumerate(imgs, start=first):
        odom, m, pose, ne = S.combined_image_step(
            odom, m, img.xyz, img.count, cfg, mcfg,
            step=0 if every_frame else i, local_map_every=4)
        states = (states if keep else []) + [(odom, m)]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def run_full(state, scans, cfg, keep: bool = True):
    """Drive ``full_step`` over raw scans (``RawScan``s, or organised
    clouds with ``cfg.lidar_type`` 1); as :func:`run_course`."""
    states, poses, n_edges = [], [], []
    for sc in scans:
        if isinstance(sc, RawScan):
            xyz, valid = sc
        else:
            xyz, valid = sc, torch.zeros(1, dtype=torch.bool,
                                         device=sc.device)
        state, pose, ne = P.full_step(state, xyz, valid, cfg)
        states = (states if keep else []) + [state]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def run_combined_raw(odom, m, raws, cfg, keep: bool = True):
    """Drive ``combined_step`` over raw scans, the local map refreshed
    every frame; as :func:`run_combined`."""
    states, poses, n_edges = [], [], []
    for raw in raws:
        odom, m, pose, ne = S.combined_step(odom, m, raw.xyz, raw.valid, cfg,
                                            MCFG, step=0, local_map_every=4)
        states = (states if keep else []) + [(odom, m)]
        poses.append(pose)
        n_edges.append(ne)
    return states, poses, n_edges


def same_poses(a, b) -> list:
    """Per frame, whether two pose sequences are bit for bit equal."""
    return [torch.equal(x.q, y.q) and torch.equal(x.t, y.t)
            for x, y in zip(a, b)]


def smoothness_cases(bench_img, folded4, folded8, ouster_img, dev):
    """K1's inputs at every shape the port launches it with, beside the
    bench frame: the folded batches (B = 4 and 8: 256 and 512 rings), the
    Ouster path's 128 rings, a width of 1,801 (not a multiple of 4: the
    kernel's scalar path), counts of 0, <= 10 and the full width, one full
    ring with the rest empty, and the bench frame 4 bytes off 16-byte
    alignment.  Returns {name: (xyz, count)}, all on the card."""
    g = torch.Generator().manual_seed(11)
    w = bench_img.xyz.shape[1]

    def rand(r, width, counts):
        xyz = torch.randn((r, width, 3), generator=g) * 5.0
        return (xyz.to(dev), torch.tensor(counts, dtype=torch.int32,
                                          device=dev))

    def fold(img):
        b, r = img.count.shape
        return img.xyz.reshape(b * r, w, 3), img.count.reshape(b * r)

    edge = [0, 3, 10, 11, w] + torch.randint(0, w + 1, (59,),
                                             generator=g).tolist()
    odd = [1801, 0, 10, 11] + torch.randint(0, 1802, (60,),
                                            generator=g).tolist()
    spare = torch.empty(bench_img.xyz.numel() + 1, device=dev)
    shifted = spare[1:].view(bench_img.xyz.shape)
    shifted.copy_(bench_img.xyz)
    return {"bench_64x4096": (bench_img.xyz, bench_img.count),
            "folded_256x4096": fold(folded4),
            "folded_512x4096": fold(folded8),
            "ouster_128x4096": (ouster_img.xyz, ouster_img.count),
            "width_1801": rand(64, 1801, odd),
            "edge_counts": rand(64, w, edge),
            "one_full_ring": rand(64, w, [w] + [0] * 63),
            "unaligned": (shifted, bench_img.count)}


def smoothness_bounds(xyz, count):
    """K1's two byte bounds in ms: the whole image, the counts and the
    output plane (every input byte once), and only what the output needs:
    the columns below each ring's count, the counts and the plane."""
    r, w = xyz.shape[:2]
    interior = int(torch.clamp(count - 10, min=0).sum())
    whole = bound(xyz.numel() * 4 + r * 4 + r * w * 4,
                  interior * (3 * 12 + 5))
    needed = bound(int(torch.clamp(count, max=w).sum()) * 12 + r * 4
                   + r * w * 4, interior * (3 * 12 + 5))
    return whole, needed


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


def graph_drive(step, init, imgs, first: int = 0, chunk: int = 1):
    """Drive a captured step over the images, keeping every pose it
    returns: ``step(state, x, c)`` for an odometry graph (``init`` an
    ``OdomState``), ``step(odom, map, x, c, i)`` for a combined one
    (``init`` a pair; ``i`` the frame index, so the caller picks the
    refresh pattern's graph), on frames ``first``, ``first + 1``, ...;
    with ``chunk`` > 1 the frames go ``chunk`` at a time (stacked) and the
    poses are split per frame.  Returns (last state, poses, edge counts)."""
    state, poses, n_edges = init, [], []
    pair = isinstance(init, tuple) and not hasattr(init, "_fields")
    for c0 in range(0, len(imgs), chunk):
        part = imgs[c0:c0 + chunk]
        x = (torch.stack([im.xyz for im in part]) if chunk > 1
             else part[0].xyz)
        c = (torch.stack([im.count for im in part]) if chunk > 1
             else part[0].count)
        if pair:
            o, m, pose, ne = step(*state, x, c, first + c0)
            state = (o, m)
        else:
            state, pose, ne = step(state, x, c)
        if chunk > 1:
            poses += [se3.Pose(pose.q[j], pose.t[j]) for j in range(len(part))]
            n_edges += list(ne)
        else:
            poses.append(pose)
            n_edges.append(ne)
    return state, poses, n_edges


def timed_in_turns(drives: dict, warm: int) -> dict:
    """Each ``drive(frames, first)`` (returning its last state) timed twice
    in turns (A B ... B A): ``warm`` frames unmeasured, then the rest
    between two CUDA events and on the host clock.  Returns {name:
    [[ms/frame, host ms/frame], ...]}."""
    runs = {name: [] for name in drives}
    for name in list(drives) + list(drives)[::-1]:
        drive, init, frames = drives[name]
        state = drive(init(), frames[:warm], 0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        drive(state, frames[warm:], warm)
        stop.record()
        torch.cuda.synchronize()
        n = len(frames) - warm
        runs[name].append([start.elapsed_time(stop) / n,
                           (time.perf_counter() - h0) * 1e3 / n])
    return runs


def lm_problem(seed: int, b: int, e: int, dev, noise: float = 0.02,
               start_off: float = 1.0):
    """B lanes of e point-to-line correspondences, each lane its own true
    pose and a start ``start_off`` x (0.1 rad, ~0.6 m) from it: edges 5-60
    m out, their lines through the true world points (with ``noise`` m of
    offset), ~10 % invalid.  Returns (pose0, cp, lpa, lpb, valid) on
    ``dev``."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (b, e))
    rad = rng.uniform(5, 60, (b, e))
    cp = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                   rng.uniform(-2, 4, (b, e))], -1)
    yaw = rng.uniform(-0.5, 0.5, b)
    rot = np.stack([yaw_matrix(y) for y in yaw])
    t_true = rng.normal(size=(b, 3)) * [2.0, 2.0, 0.2]
    world = np.einsum("bij,bej->bei", rot, cp) + t_true[:, None]
    d = rng.normal(size=(b, e, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    off = rng.normal(size=(b, e, 3)) * noise
    lpa, lpb = world + off + 0.3 * d, world + off - 0.4 * d
    yaw0 = yaw + 0.1 * start_off
    q0 = np.stack([np.cos(yaw0 / 2), 0 * yaw0, 0 * yaw0, np.sin(yaw0 / 2)],
                  -1)
    t0 = t_true + np.multiply([0.5, -0.3, 0.05], start_off)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)
    return (se3.Pose(on(q0), on(t0)), on(cp), on(lpa), on(lpb),
            on(rng.random((b, e)) > 0.1, torch.bool))


def lm_accepts(solve, args, kw, iters: int):
    """Each round's accept of ``solve``, read from its poses at iters = 0
    .. iters (a round accepted moves the pose), a list per lane, and the
    lambda each sequence leaves; with the final pose."""
    outs = [solve(*args, **kw, iters=n) for n in range(iters + 1)]
    moved = [((a.q != b.q).any(-1) | (a.t != b.t).any(-1)).cpu().numpy()
             for a, b in zip(outs, outs[1:])]
    acc = np.stack(moved, -1).reshape(-1, iters)
    lam = [float(np.float32(1e-4) * np.prod(
        [np.float32(0.5) if a else np.float32(4.0) for a in row]))
        for row in acc]
    return acc.tolist(), lam, outs[-1]


def lm_solve_phase(cfg, imgs, dev, smi, usage, check) -> None:
    """The LM row of the kernels phase: ``csrc/lm_solve.cu`` against
    ``lm_solve_plain`` on the card on the same inputs (the bench frame's
    two calls, B = 1 and 8 at 5,632 edges, ragged 1,000 and 37, 40,000
    past the blocks' shared memory, no valid correspondence, rejected
    rounds), reruns bit for bit, lanes of a batch bit for bit to their solo
    calls, each side's accepts and lambdas; ms a call (CUDA events,
    L2-warm) of both; the launches a frame of ``image_step`` eager and
    captured."""
    t_phase = time.perf_counter()
    kw = dict(min_range=cfg.min_range, max_range=cfg.max_range,
              huber_delta=cfg.huber_delta)
    iters = cfg.inner_iters
    # the bench frame's two calls, as image_step makes them
    calls = []
    real = P.lm_solve

    def record(*a, **k):
        calls.append(a)
        return real(*a, **k)

    P.lm_solve = record
    try:
        P.image_step(P.init_state(cfg, device=dev), imgs[0].xyz,
                     imgs[0].count, cfg)
        state = P.init_state(cfg, device=dev)
        for im in imgs[:6]:
            state, _, _ = P.image_step(state, im.xyz, im.count, cfg)
    finally:
        P.lm_solve = real
    cases = {"bench_frame_call1": calls[-2], "bench_frame_call2": calls[-1],
             "b1_e5632": lm_problem(1, 1, 5632, dev),
             "b8_e5632": lm_problem(8, 8, 5632, dev),
             "b1_e1000": lm_problem(2, 1, 1000, dev),
             "b1_e37": lm_problem(3, 1, 37, dev),
             "b2_e40000": lm_problem(4, 2, 40000, dev)}
    pose, cp, lpa, lpb, valid = lm_problem(5, 1, 5632, dev)
    cases["no_valid"] = (pose, cp, lpa, lpb, torch.zeros_like(valid))
    # started at the true pose with noise-free lines: nothing to gain
    pose, cp, lpa, lpb, valid = lm_problem(6, 1, 5632, dev, noise=0.0,
                                           start_off=0.0)
    cases["rejected"] = (pose, cp, lpa, lpb, valid)
    rows = {}
    for name, args in cases.items():
        shape = SLV.lm_solve_shape(args[1].shape[-2])
        k_acc, k_lam, got = lm_accepts(SLV.lm_solve_cuda, args, kw, iters)
        p_acc, p_lam, want = lm_accepts(SLV.lm_solve_plain, args, kw, iters)
        again = SLV.lm_solve_cuda(*args, **kw, iters=iters)
        rerun = bool(torch.equal(again.q, got.q) and
                     torch.equal(again.t, got.t))
        gap_m, gap_rad = pose_gap(got.t.cpu().numpy(), got.q.cpu().numpy(),
                                  want.t.cpu().numpy(), want.q.cpu().numpy())
        row = {"lanes": int(got.t[..., 0].numel()),
               "edges": int(args[1].shape[-2]),
               "valid": int(args[4].sum()), "shape": shape,
               "pose_gap_m": gap_m, "pose_gap_rad": gap_rad,
               "rerun_bit_equal": rerun, "accepts": k_acc,
               "plain_accepts": p_acc, "lambda": k_lam,
               "plain_lambda": p_lam}
        check(rerun, f"lm_solve {name}: a rerun changed the pose")
        check(gap_m < 1e-3 and gap_rad < 1e-3,
              f"lm_solve {name}: {gap_m:.2e} m, {gap_rad:.2e} rad from the "
              f"plain version")
        if got.t.dim() == 2:
            solo = [SLV.lm_solve_cuda(se3.Pose(args[0].q[i], args[0].t[i]),
                                      *(x[i] for x in args[1:]), **kw,
                                      iters=iters)
                    for i in range(got.t.shape[0])]
            row["lanes_bit_equal_solo"] = all(
                torch.equal(s.q, got.q[i]) and torch.equal(s.t, got.t[i])
                for i, s in enumerate(solo))
            check(row["lanes_bit_equal_solo"],
                  f"lm_solve {name}: a lane differs from its solo call")
        rows[name] = row
    check(rows["no_valid"]["accepts"] == [[False] * iters],
          "lm_solve no_valid: a round was accepted")
    held = SLV.lm_solve_cuda(*cases["no_valid"], **kw, iters=iters)
    check(bool(torch.equal(held.q, cases["no_valid"][0].q) and
               torch.equal(held.t, cases["no_valid"][0].t)),
          "lm_solve no_valid: the pose moved")
    check(any(not a for row in (rows["rejected"], rows["bench_frame_call2"])
              for lane in row["accepts"] for a in lane),
          "lm_solve: no case rejected a round")
    # ms a call, L2-warm, and the bench frame's plain version beside it
    timing = {}
    for name in ("bench_frame_call1", "b1_e5632", "b8_e5632", "b1_e37",
                 "b2_e40000"):
        args = cases[name]
        timing[name] = {
            "kernel_ms": cuda_ms(lambda: SLV.lm_solve_cuda(
                *args, **kw, iters=iters), reps=200),
            "plain_ms": cuda_ms(lambda: SLV.lm_solve_plain(
                *args, **kw, iters=iters), reps=20)}
    # bytes the call needs (cp, lpa, lpb, valid, the poses) and its
    # operations (JAX's count, tools/bench_stages.roofline), on the H100
    e = cases["bench_frame_call1"][1].shape[-2]
    b_ms, b_by = bound(e * 37 + 56, 2.0 * iters * e * (2 * 36 + 12 + 60))
    # launches a frame: eager, and in one replay of a captured step
    SLV.lm_solve_cuda.launches = 0
    P.image_step(state, imgs[6].xyz, imgs[6].count, cfg)
    eager = SLV.lm_solve_cuda.launches
    cap = bench_stages.capture(
        lambda s, x, c: P.image_step(s, x, c, cfg),
        (state, imgs[6].xyz, imgs[6].count))
    cap.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cap.graph.replay()
        torch.cuda.synchronize()
    in_graph = sum(1 for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and "lm_solve_kernel" in ev.name)
    check(eager == cfg.outer_iters,
          f"lm_solve: {eager} launches in an eager frame")
    check(in_graph == cfg.outer_iters,
          f"lm_solve: {in_graph} launches in a captured frame")
    emit({"phase": "lm_solve", "nvidia_smi": smi, "cases": rows,
          "timing": timing, "bound_ms": b_ms, "bound_by": b_by,
          "ptxas": usage.get("lm_solve"),
          "launches_eager_frame": eager, "launches_captured_frame": in_graph,
          "seconds": time.perf_counter() - t_phase})


def aot_phase(cfg, ccfg, imgs, eager, ceager, seager, gt_pos, bimgs,
              bench_b, mesh, sstep, smi, check) -> None:
    """The ``aot`` phase: each step captured by ``runtime/aot.py`` and
    held to its eager drive (see the module docstring)."""
    t_phase = time.perf_counter()
    (poses, n_edges), (cposes, cedges), sposes = eager, ceager, seager
    x0, c0 = imgs[0].xyz, imgs[0].count
    odom0 = P.init_state(cfg)
    comb0 = S.init_combined(ccfg, MCFG)
    shard0 = CB.init_combined_image_sharded(ccfg, MCFG, mesh)
    xs = torch.stack([im.xyz for im in imgs[:CHUNK]])
    cs = torch.stack([im.count for im in imgs[:CHUNK]])
    capture_s, graphs = {}, {}

    def capture(name, fn, args, extra, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[name] = aot.get_or_compile(name, fn, args, extra=extra, **kw)
        torch.cuda.synchronize()
        capture_s[name] = time.perf_counter() - t0

    capture("image_step", lambda s, x, c: P.image_step(s, x, c, cfg),
            (odom0, x0, c0), str(cfg))
    for every, refresh in ((1, True), (4, True), (4, False)):
        def fn(o, m, x, c, i=0 if refresh else 1, every=every):
            return S.combined_image_step(o, m, x, c, ccfg, MCFG, step=i,
                                         local_map_every=every)
        capture(f"combined_every{every}_{'refresh' if refresh else 'hold'}",
                fn, comb0 + (x0, c0),
                f"{ccfg}|{MCFG}|every={every}|refresh={refresh}")
    capture("chained_image_step",
            lambda s, x, c: P.chained_image_step(s, x, c, cfg),
            (odom0, xs, cs), f"{cfg}|chunk={CHUNK}")
    # every chunk of the drive starts at a multiple of 12: one pattern
    capture("chained_combined_every4",
            lambda o, m, x, c: S.chained_combined_image_step(
                o, m, x, c, ccfg, MCFG, step0=0, local_map_every=4),
            comb0 + (xs, cs), f"{ccfg}|{MCFG}|every=4|chunk={CHUNK}|phase=0")
    # the batch step at B = 4 and 8 (K4: knn_coords' second entry point)
    for b in TIMED_BATCHES:
        capture(f"batch_{b}",
                lambda s, x, c: P.batch_image_step(s, x, c, cfg),
                (init_batch_state(cfg, b), bench_b[b][0].xyz,
                 bench_b[b][0].count), f"{cfg}|B={b}")
    # the sharded flagship on phase 11's one-rank NCCL mesh, whose
    # communicators exist already; K5 prepared before the warm calls
    capture("sharded", sstep, shard0 + (x0, c0), f"{ccfg}|{MCFG}|sharded",
            kernel_names=path_kernels(True, sharded=True))

    def odom(name):
        return graphs[name]

    def sharded(o, m, x, c, i):
        return graphs["sharded"](o, m, x, c)

    def comb(every):
        def step(o, m, x, c, i):
            return graphs[f"combined_every{every}_" + (
                "refresh" if every == 1 or i % every == 0 else "hold")](
                o, m, x, c)
        return step

    def ccomb(o, m, x, c, i):
        return graphs["chained_combined_every4"](o, m, x, c)

    # phase 2's drive: every graph against its eager drive
    _, e4_poses, e4_edges = run_combined(*S.init_combined(ccfg, MCFG), imgs,
                                         ccfg, every_frame=False, keep=False)
    e4_t, e4_q, _, _ = drive_error(e4_poses, gt_pos)
    t_ref, q_ref, _, _ = drive_error(poses, gt_pos)
    ct_ref, cq_ref, _, _ = drive_error(cposes, gt_pos)
    st_ref, sq_ref, _, _ = drive_error(sposes, gt_pos)
    ref_edges = [int(x) for x in n_edges]
    # the batch steps' eager drives on the bench lanes
    beager = {b: run_course(init_batch_state(cfg, b), bench_b[b], cfg,
                            keep=False, step=P.batch_image_step)[1:]
              for b in TIMED_BATCHES}
    torch.cuda.synchronize()
    reset_counters()
    (drives, syncs) = sync_free(lambda: {
        "image_step": graph_drive(odom("image_step"), odom0, imgs),
        "chained_image_step": graph_drive(odom("chained_image_step"), odom0,
                                          imgs, chunk=CHUNK),
        "combined_every1": graph_drive(comb(1), comb0, imgs),
        "combined_every4": graph_drive(comb(4), comb0, imgs),
        "chained_combined_every4": graph_drive(ccomb, comb0, imgs,
                                               chunk=CHUNK),
        **{f"batch_{b}": graph_drive(odom(f"batch_{b}"),
                                     init_batch_state(cfg, b), bench_b[b])
           for b in TIMED_BATCHES},
        "sharded": graph_drive(sharded, shard0, imgs)})
    replay_counts = read_counters()
    check(replay_counts == launches(), f"aot: replays moved the launch "
          f"counters (they count at capture only): {replay_counts}")
    check(not syncs, f"aot: {len(syncs)} host synchronisations in the "
          f"captured drives: {syncs[:1]}")
    res = {}
    for name, (_, gposes, gedges) in drives.items():
        if name.startswith("batch_"):
            bposes, bedges = beager[int(name.split("_")[1])]
            same = same_poses(gposes, bposes)
            check(all(same), f"aot {name}: {same.count(False)} poses not "
                  "torch.equal to the eager drive's")
            check(all(torch.equal(g, e) for g, e in zip(gedges, bedges)),
                  f"aot {name}: edge counts differ from eager")
            res[name] = {"poses_equal": sum(same), "frames": len(same)}
            continue
        gt_, gq_, _, gate = drive_error(gposes, gt_pos)
        same_edges = [int(x) for x in gedges] == ref_edges
        check(same_edges, f"aot {name}: edge counts differ from eager")
        if name in ("image_step", "chained_image_step"):
            same = same_poses(gposes, poses)
            check(all(same), f"aot {name}: {same.count(False)} poses not "
                  "torch.equal to the eager drive's")
            res[name] = {"poses_equal": sum(same), "frames": len(same)}
            continue
        ref_t, ref_q = {"combined_every1": (ct_ref, cq_ref),
                        "sharded": (st_ref, sq_ref)}.get(name, (e4_t, e4_q))
        gap = pose_gap(gt_[:N_ATE], gq_[:N_ATE], ref_t[:N_ATE],
                       ref_q[:N_ATE])
        check(gap[0] < 0.01 and gap[1] < 1e-3, f"aot {name} vs eager over "
              f"{N_ATE} frames: {gap}")
        res[name] = {"vs_eager_max_dt_m_drot_rad": gap,
                     f"ate_m_first_{N_ATE}": gate}
        if name == "sharded":
            res[name]["poses_equal"] = sum(same_poses(gposes, sposes))
    # three poses kept across three calls: distinct, each eager's
    kept = drives["image_step"][1][:3]
    distinct = len({tuple(p.t.tolist()) for p in kept}) == 3
    check(distinct and all(same_poses(kept, poses[:3])),
          "aot: poses kept across calls were overwritten")

    # the bench drive: graph against eager, twice each in turns
    def eager_odom(st, ims, first):
        return run_course(st, ims, cfg, keep=False)[0][-1]

    def eager_comb(every):
        return lambda st, ims, first: run_combined(
            *st, ims, ccfg, every == 1, first, keep=False)[0][-1]

    def eager_chained(st, ims, first):
        return run_chained(st, ims, cfg, keep=False)[0][-1]

    def eager_cchained(st, ims, first):
        for c0_ in range(0, len(ims), CHUNK):
            part = ims[c0_:c0_ + CHUNK]
            o, m, _, _ = S.chained_combined_image_step(
                *st, torch.stack([im.xyz for im in part]),
                torch.stack([im.count for im in part]), ccfg, MCFG,
                step0=first + c0_, local_map_every=4)
            st = (o, m)
        return st

    def captured(step, chunk=1):
        return lambda st, ims, first: graph_drive(step, st, ims, first,
                                                  chunk)[0]

    def eager_batch(st, ims, first):
        return run_course(st, ims, cfg, keep=False,
                          step=P.batch_image_step)[0][-1]

    def eager_sharded(st, ims, first):
        return run_sharded(*st, ims, sstep, keep=False)[0][-1]

    n_warm = 12                 # a whole chunk unmeasured, two measured
    timing = {}
    for name, e_drive, g_drive, init in (
            ("image_step", eager_odom, captured(odom("image_step")),
             lambda: P.init_state(cfg)),
            ("combined_every1", eager_comb(1), captured(comb(1)),
             lambda: S.init_combined(ccfg, MCFG)),
            ("combined_every4", eager_comb(4), captured(comb(4)),
             lambda: S.init_combined(ccfg, MCFG)),
            ("chained_image_step", eager_chained,
             captured(odom("chained_image_step"), CHUNK),
             lambda: P.init_state(cfg)),
            ("chained_combined_every4", eager_cchained,
             captured(ccomb, CHUNK), lambda: S.init_combined(ccfg, MCFG)),
            *((f"batch_{b}", eager_batch, captured(odom(f"batch_{b}")),
               lambda b=b: init_batch_state(cfg, b))
              for b in TIMED_BATCHES),
            ("sharded", eager_sharded, captured(sharded),
             lambda: CB.init_combined_image_sharded(ccfg, MCFG, mesh))):
        frames = bench_b[int(name[6:])] if name.startswith("batch_") \
            else bimgs
        runs = timed_in_turns({"eager": (e_drive, init, frames),
                               "graph": (g_drive, init, frames)}, n_warm)
        for mode, r in runs.items():
            worst = max(ms for ms, _ in r)
            check(worst <= FRAME_BUDGET_MS, f"aot timing {name} {mode}: "
                  f"{worst:.1f} ms/frame > {FRAME_BUDGET_MS}")
        timing[name] = {f"{mode}_ms_and_host_ms_in_turns": r
                        for mode, r in runs.items()}
        timing[name].update({
            f"{mode}_ms_per_frame": float(np.mean([x[0] for x in r]))
            for mode, r in runs.items()})
    emit({"phase": "aot", "nvidia_smi": smi, "frames": N_FRAMES,
          "capture_s": capture_s, "checks": res,
          "kept_poses_distinct": distinct,
          "replay_launch_counters": replay_counts,
          "host_syncs": len(syncs), "frames_timed": N_FRAMES - n_warm,
          "timing": timing, "seconds": time.perf_counter() - t_phase})


def sparse_epilogue_phase(imgs, poses, cfg, check) -> dict:
    """``update_map_sparse_epilogue`` against ``update_map`` on the card:
    the combined drive's 36 frames of edges at their solved poses into two
    maps each, at 524,288 and 2^20 slots: slots, keys, codes and overflow
    ``torch.equal``, centroids within 1e-5 m, the probe once a frame for
    each; both functions' ms a call on the last frame, and whether two
    calls of each on the same input give bit-equal centroids.  Then
    ``update_map_full`` at ``resolution=0.1`` (not packable): every field
    of two calls on one input ``torch.equal``."""
    edges = [F.select_edges(im, F.smoothness(im, cfg), cfg) for im in imgs]
    out = {}
    for cap in (MCFG.map_capacity, 1 << 20):
        mcfg = MCFG.replace(map_capacity=cap)
        probes = {}
        for name in ("update_map", "update_map_sparse_epilogue"):
            fn = getattr(G, name)
            m = G.init_map(cap)
            torch.cuda.synchronize()
            reset_counters()
            for e, p in zip(edges, poses):
                prev = m
                m = fn(m, e.xyz, e.valid, p, mcfg)
            probes[name] = read_counters()["probe_insert"]
            if name == "update_map":
                dense, dense_prev = m, prev
            else:
                sparse, sparse_prev = m, prev
        ints = {k: torch.equal(getattr(dense, k), getattr(sparse, k))
                for k in ("valid", "key", "code", "overflow")}
        err = float((dense.xyz - sparse.xyz).abs().max())
        e, p = edges[-1], poses[-1]
        repeat = {}
        ms = {}
        for name, prev in (("update_map", dense_prev),
                           ("update_map_sparse_epilogue", sparse_prev)):
            fn = getattr(G, name)
            repeat[name] = torch.equal(fn(prev, e.xyz, e.valid, p, mcfg).xyz,
                                       fn(prev, e.xyz, e.valid, p, mcfg).xyz)
            ms[name] = cuda_ms(lambda: fn(prev, e.xyz, e.valid, p, mcfg), 50)
        check(all(ints.values()), f"sparse epilogue at {cap} slots: "
              f"{ints} (valid, key, code, overflow torch.equal)")
        check(err <= 1e-5, f"sparse epilogue at {cap} slots: centroids "
              f"{err:.2e} m from update_map's")
        check(probes == {"update_map": len(edges),
                         "update_map_sparse_epilogue": len(edges)},
              f"sparse epilogue at {cap} slots: probe launches {probes}")
        out[str(cap)] = {"frames": len(edges), "ints_equal": ints,
                         "xyz_max_abs_err": err, "probe_launches": probes,
                         "leaves": int(dense.valid.sum()),
                         "overflow": int(dense.overflow), "ms_per_call": ms,
                         "repeat_xyz_bit_equal": repeat}
    # the sorted soup of a non-packable map (0.1 m leaves): the drive's
    # frames into it, then two calls on the last frame's input
    mcfg = MCFG.replace(resolution=0.1)
    m = G.init_map(mcfg.map_capacity)
    for e, p in zip(edges[:-1], poses[:-1]):
        m = G.update_map(m, e.xyz, e.valid, p, mcfg)
    e, p = edges[-1], poses[-1]
    a = G.update_map_full(m, e.xyz, e.valid, p, mcfg)
    b = G.update_map_full(m, e.xyz, e.valid, p, mcfg)
    same = {k: torch.equal(getattr(a, k), getattr(b, k))
            for k in G.MapState._fields}
    check(not G.packable(mcfg) and all(same.values()), f"update_map_full at "
          f"resolution 0.1: two calls on one input differ: {same}")
    out["update_map_full_resolution_0.1"] = {
        "fields_equal": same, "leaves": int(a.valid.sum()),
        "overflow": int(a.overflow),
        "ms_per_call": cuda_ms(lambda: G.update_map_full(
            m, e.xyz, e.valid, p, mcfg), 20)}
    return out


def stages_phase(smi, check) -> None:
    """The ``stages`` phase: ``tools/bench_stages`` in this process (its
    JSON line printed as it prints it), every row finite and > 0 eager and
    as a graph, every stage graph's outputs ``torch.equal`` to the eager
    stage's, the fused graphs (bare and state-chained) equal to eager and
    within the frame budget."""
    t0 = time.perf_counter()
    out = bench_stages.run()
    print(json.dumps(out), flush=True)
    rows = dict(out["stage_ms"], odom_ms=out["odom_ms"],
                combined_ms=out["combined_ms"])
    bad = [name for name, row in rows.items()
           if not all(math.isfinite(row[k]) and row[k] > 0
                      for k in ("eager_ms", "graph_ms"))]
    check(not bad, f"stages: rows not finite and > 0: {bad}")
    unequal = [n for n, ok in out["graph_equal"].items() if not ok]
    check(not unequal, f"stages: graphs not torch.equal to eager: {unequal}")
    for key in ("odom_ms", "combined_ms"):
        row = out[key]
        check(row["graph_equals_eager"] and row["chained_graph_poses_equal"],
              f"stages: the fused {key} graph differs from eager")
        worst = max(row["graph_ms"], row["chained_graph_ms"])
        check(worst <= FRAME_BUDGET_MS, f"stages: fused {key} graph "
              f"{worst:.1f} ms > {FRAME_BUDGET_MS}")
    emit({"phase": "stages", "nvidia_smi": smi,
          "rows": len(out["stage_ms"]), "glue": out["glue"],
          "seconds": time.perf_counter() - t0})


def warm_cache_phase(smi, check) -> None:
    """The ``warm_cache`` phase: ``python -m liodom_tpu_torch.tools.
    warm_cache`` in a new process started from a copy of the package
    without its build directories (cold: every kernel source and the native
    loader compiled), then in a second new process (warm: nothing
    compiled); both reports, the build seconds and each program's."""
    t0 = time.perf_counter()
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        fresh = Path(tmp)
        shutil.copytree(Path(liodom_tpu_torch.__file__).parent,
                        fresh / "liodom_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        env = dict(os.environ, PYTHONPATH=str(fresh))
        for run in ("cold", "warm"):
            s0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "liodom_tpu_torch.tools.warm_cache"],
                cwd=fresh, env=env, capture_output=True, text=True,
                timeout=600)
            if out.returncode != 0:
                raise SystemExit(f"warm_cache ({run}) exited "
                                 f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                                 f"{out.stderr[-3000:]}")
            rep = json.loads(out.stdout.strip().splitlines()[-1])
            rep["process_s"] = time.perf_counter() - s0
            reports[run] = rep
    cold, warm = reports["cold"], reports["warm"]
    check(cold["compiled"] == sorted(kernels.SOURCES)
          and cold["native_loader"]["build"] == "cold",
          f"warm_cache cold: compiled {cold['compiled']}, native loader "
          f"{cold['native_loader']}")
    check(warm["compiled"] == [] and warm["native_loader"]["build"] == "warm"
          and warm["native_loader"]["loaded"],
          f"warm_cache warm: compiled {warm['compiled']}, native loader "
          f"{warm['native_loader']}")
    for run, rep in reports.items():
        check(len(rep["programs"]) == 3 and all(
            v is not None and v >= 0 for prog in rep["programs"].values()
            for v in prog.values()), f"warm_cache {run}: {rep['programs']}")
    emit({"phase": "warm_cache", "nvidia_smi": smi, "cold": cold,
          "warm": warm, "seconds": time.perf_counter() - t0})


BENCH_ROWS = ("odometry_scans_per_s_1chip", "odometry_scans_per_s_chained",
              "odometry_scans_per_s_window15", "ouster_scans_per_s",
              "combined_scans_per_s_1chip", "combined_scans_per_s_chained",
              "batched_odometry_scans_per_s_B4",
              "batched_odometry_scans_per_s_B8")
BENCH_FINAL = ("window15_scans_per_s", "chained_scans_per_s",
               "ouster_scans_per_s", "combined_chained_scans_per_s",
               "combined_chained_pf_control", "batched_B4_scans_per_s",
               "batched_B8_scans_per_s", "combined_scans_per_s",
               "combined_async_scans_per_s")


def bench_phase(smi, check) -> None:
    """The ``bench`` phase: ``python -m liodom_tpu_torch.tools.bench`` in a
    new process at ``bench.py``'s sizes, its budget high enough that no
    phase is skipped, its rows printed as they came.  Fails on an exit code
    other than 0, a row or final key missing, any ``parity_failed``, any
    warning line (stdout's truncation and overflow lines, stderr's gate
    lines) and a lane under 8 scans/s, eager or graph."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "liodom_tpu_torch.tools.bench"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        env=dict(os.environ, LIODOM_BENCH_BUDGET_S="100000"), timeout=900)
    check(out.returncode == 0, f"bench exited {out.returncode}:\n"
          f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    for line in lines:
        print(json.dumps(line), flush=True)
    if out.returncode != 0 or not lines:
        return
    final = lines[-1]
    rows = {r["metric"]: r for r in lines[:-1] if "metric" in r}
    check(list(rows) == list(BENCH_ROWS),
          f"bench rows {list(rows)} != {list(BENCH_ROWS)}")
    missing = [k for k in BENCH_FINAL + tuple(f"eager_{k}" for k in
                                                BENCH_FINAL) if k not in final]
    check(not missing, f"bench: final line lacks {missing}")
    flagged = [k for line in lines for k in line
               if k.endswith("parity_failed") or k.endswith("_skipped")]
    check(not flagged, f"bench: {flagged}")
    warned = ([line for line in lines if "warning" in line]
              + [x for x in out.stderr.splitlines()
                 if x.startswith("WARNING")])
    check(not warned, f"bench warnings: {warned}")

    def lanes(key: str) -> int:
        m = re.search(r"_B(\d+)", key)
        return int(m.group(1)) if m else 1

    rates = {f"{name}:{k}": v / lanes(name) for name, row in rows.items()
             for k, v in row.items()
             if k in ("value", "eager_value", "per_frame_same_protocol",
                      "eager_per_frame_same_protocol")}
    rates.update({k: v / lanes(k) for k, v in final.items()
                  if k.endswith("_scans_per_s") or k.endswith("_pf_control")
                  or k in ("value", "eager_value")})
    slow = {k: v for k, v in rates.items()
            if not (isinstance(v, float) and v >= MIN_SCANS_PER_S)}
    check(not slow, f"bench: lanes under {MIN_SCANS_PER_S} scans/s: {slow}")
    emit({"phase": "bench", "nvidia_smi": smi, "card": final.get("card"),
          "build_s": final.get("build_s"),
          "bench_wall_s": final.get("bench_wall_s"),
          "seconds": time.perf_counter() - t0})


APP_CK_EVERY = 24           # run_kitti's checkpoint in the apps phase
STREAM_MAPPING_FRAMES = 40  # run_stream --mapping at 10 Hz
STREAM_OVERLOAD_FRAMES = 60  # run_stream --rate 200 (apps/run_stream.py:45)
LONGCOURSE_FRAMES = 400     # run_longcourse at its defaults, cut from 1,000
LONGCOURSE_SHORT = 300      # the --chunk, --imu and resume courses
LONGCOURSE_CK = 150         # the resume's checkpoint
N_OUSTER_APP = 20           # run_ouster's organised clouds
MIN_SCANS_PER_S = 8         # the apps' real-time contract (PERF.md §2)


def write_kitti_tree(root: Path, spins, gt_pos, gt_yaw) -> None:
    """The drive's raw scans as a KITTI odometry tree: ``.bin`` records
    (x, y, z, 0), ``calib.txt`` with an identity ``Tr`` (the velodyne frame
    is the camera frame), ``times.txt`` at 0.1 s and the drive's poses."""
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    rows = []
    for i, spin in enumerate(spins):
        rec = np.zeros((len(spin), 4), np.float32)
        rec[:, :3] = spin
        rec.tofile(seq / "velodyne" / f"{i:06d}.bin")
        m = np.zeros((3, 4))
        m[:, :3] = yaw_matrix(gt_yaw[i])
        m[:, 3] = gt_pos[i]
        rows.append(m.reshape(-1))
    np.savetxt(seq / "times.txt", np.arange(len(spins)) * 0.1)
    (seq / "calib.txt").write_text(
        "Tr: " + " ".join(str(v) for v in np.eye(4)[:3].reshape(-1)) + "\n")
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt", np.stack(rows))


def read_poses(path: Path) -> np.ndarray:
    """A results directory's poses.txt as (F, 3, 4)."""
    return np.loadtxt(path).reshape(-1, 3, 4)


def traj_gap(a: np.ndarray, b: np.ndarray):
    """Largest translation (m) and rotation (rad) gap between two (F, 3, 4)
    trajectories; the angle from both the sine and the cosine of the
    relative rotation, accurate near 0."""
    dt = np.linalg.norm(a[:, :, 3] - b[:, :, 3], axis=1)
    rel = np.einsum("fji,fjk->fik", a[:, :, :3], b[:, :, :3])
    sin = 0.5 * np.linalg.norm(np.stack(
        [rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
         rel[:, 1, 0] - rel[:, 0, 1]], axis=1), axis=1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1.0)
    return float(dt.max()), float(np.arctan2(sin, cos).max())


def traj_ate(est: np.ndarray, gt_pos: np.ndarray) -> float:
    """ATE of a trajectory over its first N_ATE frames."""
    err = np.linalg.norm(est[:N_ATE, :, 3] - gt_pos[:N_ATE], axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def check_rate(rep: dict, check, label: str) -> None:
    """The real-time contract on an app run that timed its frames (a run
    with nothing to do reports no rate)."""
    if "scans_per_s" in rep:
        check(rep["scans_per_s"] >= MIN_SCANS_PER_S, f"{label}: "
              f"{rep['scans_per_s']:.2f} scans/s < {MIN_SCANS_PER_S}")


def run_app_process(pkg_root: Path, module: str, argv, check,
                    label: str, rate: bool = True) -> dict:
    """``python -m liodom_tpu_torch.apps.<module> argv`` in a fresh process
    that imports the package under ``pkg_root``; its report (the last line
    of its output), held to the real-time contract with ``rate``.  Raises
    if the app fails."""
    env = dict(os.environ, PYTHONPATH=str(pkg_root))
    out = subprocess.run(
        [sys.executable, "-m", f"liodom_tpu_torch.apps.{module}",
         *(str(a) for a in argv)],
        cwd=pkg_root, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"{module} {argv} exited {out.returncode}:\n"
                         f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    if rate:
        check_rate(rep, check, label)
    return rep


def run_app(app, argv, check, label: str, rate: bool = True):
    """``app.run(argv)`` in this process, every launch counter set to 0
    just before and read just after; returns (report, counters).  With
    ``rate``, a run that timed its frames is held to the real-time
    contract (not the long course, whose renders share the process)."""
    torch.cuda.synchronize()
    reset_counters()
    rep = app.run([str(a) for a in argv])
    counts = read_counters()
    check(rep["rc"] == 0, f"{label}: exit code {rep['rc']}")
    if rate:
        check_rate(rep, check, label)
    return rep, counts


def app_line(label: str, rep: dict, counts, smi: str, **extra) -> dict:
    """One JSON line of the apps phase."""
    keys = ("frames", "start_frame", "native_loader", "native_loader_s",
            "kernel_build_s", "kernel_build", "compiled", "first_frame_s",
            "first_dispatch_frames", "scans_per_s", "host_syncs",
            "stager_waits", "ate_m", "map_overflow", "local_map_truncated",
            "occupied_slots", "ring_width")
    return {"phase": "apps", "run": label, "nvidia_smi": smi,
            **{k: rep[k] for k in keys if k in rep},
            "launches": counts, **extra}


def stream_runs(smi, check) -> None:
    """``run_stream`` as a user runs it (see the module docstring): one
    apps line a run."""
    keys = ("frames", "processed", "dropped", "leftover", "accounted",
            "warn_count", "input_hz", "output_hz", "ate_m",
            "mapper_processed", "mapper_dropped", "map_overflow",
            "local_map_truncation", "step_ms_median", "step_ms_max",
            "host_syncs", "host_syncs_by_thread", "due_point_syncs",
            "stager_waits", "ring_dropped", "warm_s", "kernel_build")
    for label, argv, overload in (
            ("run_stream", [], False),
            ("run_stream --mapping", ["--frames", STREAM_MAPPING_FRAMES,
                                      "--mapping"], False),
            ("run_stream --rate 200 --mapping (overload)",
             ["--frames", STREAM_OVERLOAD_FRAMES, "--rate", 200,
              "--mapping"], True)):
        rep, counts = run_app(run_stream, argv, check, label)
        n, done = rep["frames"], rep["processed"]
        check(rep["accounted"] == n, f"{label}: {rep['accounted']} of {n} "
              "frames accounted for")
        check(rep["host_syncs"] == 0, f"{label}: {rep['host_syncs']} host "
              "synchronisations between due points")
        # the warm-up frame before the sensor starts, then each processed
        want = dict(smoothness=done + 1, select_edges=done + 1,
                    knn_coords=2 * (done + 1))
        if "--mapping" in argv:
            mp = rep["mapper_processed"]
            want.update(probe_insert=mp, local_map_compact=mp // 4)
            check(mp >= 1 and rep["map_overflow"] == 0
                  and rep["local_map_truncation"] == 0,
                  f"{label}: mapper folded {mp} frames, overflow "
                  f"{rep['map_overflow']}, truncation "
                  f"{rep['local_map_truncation']}")
        check(counts == launches(**want), f"{label}: launch counts {counts} "
              f"!= {launches(**want)}")
        if overload:
            check(rep["dropped"] > 0 and rep["warn_count"] >= 1,
                  f"{label}: {rep['dropped']} drops, {rep['warn_count']} "
                  "watchdog warnings")
        else:
            check(rep["output_hz"] >= 0.8 * rep["input_hz"],
                  f"{label}: output {rep['output_hz']} Hz < 0.8 x input "
                  f"{rep['input_hz']} Hz")
        emit({"phase": "apps", "run": label, "nvidia_smi": smi,
              **{k: rep[k] for k in keys if k in rep}, "launches": counts})


def longcourse_runs(tmp: Path, fresh: Path, smi, check) -> None:
    """``run_longcourse`` as a user runs it (see the module docstring):
    one apps line a run."""
    keys = ("frames", "start_frame", "course_m", "ate_m", "rpe1_m",
            "rpe1_deg", "drift_pct", "scans_per_s", "engine_scans_per_s",
            "first_dispatch_s", "map_leaves", "map_cells", "map_load_pct",
            "map_overflow", "ring_dropped", "local_map_truncation",
            "growth", "host_syncs", "stager_waits", "kernel_build")
    workers = ["--render-workers", min(8, os.cpu_count() or 1)]

    def gate(label, rep):
        check(rep["rc"] == 0 and rep["map_overflow"] == 0
              and rep["local_map_truncation"] == 0
              and rep["ring_dropped"] == 0,
              f"{label}: rc {rep['rc']}, overflow {rep['map_overflow']}, "
              f"truncation {rep['local_map_truncation']}, ring drops "
              f"{rep['ring_dropped']}")
        check(rep["host_syncs"] == 0, f"{label}: {rep['host_syncs']} host "
              "synchronisations between due points")

    n = LONGCOURSE_FRAMES
    label = f"run_longcourse --frames {n}"
    rep, counts = run_app(run_longcourse, ["--frames", n, *workers], check,
                          label, rate=False)
    gate(label, rep)
    refreshes = len(range(0, n, 4))
    want = launches(smoothness=n, select_edges=n, knn_coords=2 * n,
                    probe_insert=n,
                    local_map_compact=refreshes + len(rep["growth"]))
    check(counts == want, f"{label}: launch counts {counts} != {want}")
    emit({"phase": "apps", "run": label, "nvidia_smi": smi,
          **{k: rep[k] for k in keys if k in rep}, "launches": counts})

    # the 300-frame course per frame, with a checkpoint at 150 (and 300):
    # the reference of the chunked run and of the resume
    m = LONGCOURSE_SHORT
    course = ["--frames", m, *workers]
    res_pf, ck = tmp / "lc_per_frame", tmp / "lc_ck"
    rep_pf, _ = run_app(run_longcourse, course + [
        "--results-dir", res_pf, "--checkpoint-dir", ck,
        "--checkpoint-every", LONGCOURSE_CK], check,
        f"run_longcourse --frames {m}", rate=False)
    gate(f"run_longcourse --frames {m}", rep_pf)
    est_pf = read_poses(res_pf / "poses.txt")
    emit({"phase": "apps", "run": f"run_longcourse --frames {m}",
          "nvidia_smi": smi, **{k: rep_pf[k] for k in keys if k in rep_pf}})

    res_c = tmp / "lc_chunk"
    label = f"run_longcourse --frames {m} --chunk {CHUNK}"
    rep, _ = run_app(run_longcourse, course + ["--chunk", CHUNK,
                                               "--results-dir", res_c],
                     check, label, rate=False)
    gate(label, rep)
    gap = traj_gap(read_poses(res_c / "poses.txt")[:N_FRAMES],
                   est_pf[:N_FRAMES])
    leaves_rel = abs(rep["map_leaves"] - rep_pf["map_leaves"]) / max(
        rep_pf["map_leaves"], 1)
    check(gap[0] < 0.01 and gap[1] < 1e-3, f"{label} vs per frame over "
          f"{N_FRAMES} frames: {gap}")
    check(leaves_rel <= 1e-3, f"{label}: map leaves {rep['map_leaves']} vs "
          f"{rep_pf['map_leaves']} per frame")
    emit({"phase": "apps", "run": label, "nvidia_smi": smi,
          **{k: rep[k] for k in keys if k in rep},
          f"vs_per_frame_first_{N_FRAMES}_max_dt_m_drot_rad": gap,
          "map_leaves_rel_diff": leaves_rel})

    label = f"run_longcourse --frames {m} --imu"
    rep, _ = run_app(run_longcourse, course + ["--imu"], check, label,
                     rate=False)
    gate(label, rep)
    emit({"phase": "apps", "run": label, "nvidia_smi": smi,
          **{k: rep[k] for k in keys if k in rep}})

    # the checkpoint at 150 alone, resumed in a new process
    step = f"step_{LONGCOURSE_CK:08d}"
    ck_mid = tmp / "lc_ck_mid"
    shutil.copytree(ck / step, ck_mid / step)
    res_r = tmp / "lc_resumed"
    label = f"run_longcourse resumed at {LONGCOURSE_CK}, new process"
    rep = run_app_process(fresh, "run_longcourse", course + [
        "--results-dir", res_r, "--checkpoint-dir", ck_mid,
        "--checkpoint-every", 10 * m], check, label, rate=False)
    gate(label, rep)
    window = slice(LONGCOURSE_CK, LONGCOURSE_CK + 20)
    gap = traj_gap(read_poses(res_r / "poses.txt")[window], est_pf[window])
    check(rep.get("start_frame") == LONGCOURSE_CK, f"{label}: started at "
          f"{rep.get('start_frame')}")
    check(gap[0] < 0.01 and gap[1] < 1e-3, f"{label} vs uninterrupted over "
          f"the next 20 frames: {gap}")
    emit({"phase": "apps", "run": label, "nvidia_smi": smi,
          **{k: rep[k] for k in keys if k in rep},
          "vs_uninterrupted_next_20_max_dt_m_drot_rad": gap})


def apps_phase(tmp: Path, spins, gt_pos, gt_yaw, dev, smi, check) -> None:
    """Phase 13: the port's apps, as a user runs them, on phase 2's drive
    written as a KITTI tree (see the module docstring)."""
    t_phase = time.perf_counter()
    n = len(spins)
    root = tmp / "kitti"
    write_kitti_tree(root, spins, gt_pos, gt_yaw)
    base = ["--root", root, "--seq", "00"]
    # a fresh copy of the package without its build directories: the
    # resumed runs below start in new processes from it, the first with
    # nothing built (a user's cold start), the second warm
    fresh = tmp / "fresh"
    shutil.copytree(Path(liodom_tpu_torch.__file__).parent,
                    fresh / "liodom_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))

    # run_kitti at the launch file's defaults (15-frame window, the ring
    # width auto-sized), results, a checkpoint at frame 24 and the PLYs
    res, ck, viz = tmp / "res", tmp / "ck", tmp / "viz"
    rep, counts = run_app(run_kitti, base + [
        "--results-dir", res, "--checkpoint-dir", ck,
        "--checkpoint-every", APP_CK_EVERY, "--export-viz", viz],
        check, "run_kitti")
    eager_reps = {"run_kitti": rep}
    est = read_poses(res / "poses.txt")
    rows = {name: len(np.loadtxt(res / name, ndmin=1))
            for name in ("poses.txt", "feat_ext_times.txt",
                         "laser_odom_times.txt", "nfeats.txt",
                         "frame_times.txt")}
    cfg = LiodomConfig(local_map_size=15, ring_width=rep["ring_width"])
    state, direct = P.init_state(cfg, device=dev), []
    for img, cnt, _ in KittiSequence(str(root), "00").iter_images(
            cfg.scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range):
        state, pose, _ = P.image_step(state, torch.from_numpy(img).to(dev),
                                      torch.from_numpy(cnt).to(dev), cfg)
        direct.append(pose.matrix()[:3])
    direct = torch.stack(direct).cpu().double().numpy()
    direct_gap = traj_gap(est, direct)
    ate = traj_ate(est, gt_pos)
    want = launches(smoothness=n, select_edges=n, knn_coords=2 * n)
    check(all(r == n for r in rows.values()), f"run_kitti results rows "
          f"{rows} != {n}")
    check(direct_gap[0] <= 1e-6, f"run_kitti vs an image_step loop over "
          f"KittiSequence.iter_images: {direct_gap}")
    check(ate < 0.1, f"run_kitti ATE over {N_ATE} frames {ate:.4f} m")
    check(counts == want, f"run_kitti launch counts {counts} != {want}")
    check(native.native_available(), "the native loader was not built")
    check(rep["host_syncs"] == 0, f"run_kitti: {rep['host_syncs']} host "
          "synchronisations between due points")
    check(CK.latest_step(str(ck)) == APP_CK_EVERY,
          f"run_kitti: checkpoint steps {CK.latest_step(str(ck))}")
    emit(app_line("run_kitti", rep, counts, smi, results_rows=rows,
                  vs_direct_loop_max_dt_m_drot_rad=direct_gap,
                  native_loader=native.native_available(),
                  ate_m_first_20=ate))

    # the copy to the card: the apps' pinned staging against a copy from
    # pageable memory (``.to(device)``, which ends in a stream
    # synchronisation), image_step at run_kitti's configuration over the
    # tree's frames, host clock to the last pose, in turns (A B B A A B)
    frames = list(KittiSequence(str(root), "00").iter_images(
        cfg.scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range))
    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev)
    puts = {"staged": stager.put,
            "pageable": lambda img, cnt: (torch.from_numpy(img).to(dev),
                                          torch.from_numpy(cnt).to(dev))}

    def staging_drive(put):
        def loop():
            state = P.init_state(cfg, device=dev)
            for img, cnt, _ in frames:
                state, _, _ = P.image_step(state, *put(img, cnt), cfg)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs = sync_free(loop)
        return (time.perf_counter() - t0) * 1e3 / n, len(syncs) / n

    staging = {name: [] for name in puts}
    for name in ("staged", "pageable", "pageable", "staged", "staged",
                 "pageable"):
        staging[name].append(staging_drive(puts[name]))
    check(all(sy == 0 for _, sy in staging["staged"]), "staged frames "
          f"synchronised the host: {staging['staged']}")
    emit({"phase": "apps", "run": "staging", "nvidia_smi": smi,
          "frames": n, "window": cfg.local_map_size,
          "ring_width": cfg.ring_width, "stager_waits": stager.waits,
          **{f"{name}_ms_per_frame": [ms for ms, _ in r]
             for name, r in staging.items()},
          **{f"{name}_syncs_per_frame": [sy for _, sy in r]
             for name, r in staging.items()}})

    # --chunk 12: chained_image_step, three chunks
    res_c = tmp / "res_chunk"
    rep, counts = run_app(run_kitti, base + ["--results-dir", res_c,
                                             "--chunk", 12],
                          check, "run_kitti --chunk 12")
    eager_reps["run_kitti --chunk 12"] = rep
    gap = traj_gap(read_poses(res_c / "poses.txt"), est)
    check(gap[0] <= 1e-6, f"run_kitti --chunk 12 vs per frame: {gap}")
    check(counts == want, f"run_kitti --chunk 12 launch counts {counts}")
    check(rep["host_syncs"] == 0, f"run_kitti --chunk 12: "
          f"{rep['host_syncs']} host synchronisations between due points")
    emit(app_line("run_kitti --chunk 12", rep, counts, smi,
                  vs_per_frame_max_dt_m_drot_rad=gap))

    # --mapping: the launch file's map (40/50 m cells, 3/2 neighbours) and a
    # 65,536-row received local map; K7 once a frame and once more for the
    # end-of-run truncation check at the final pose, as the JAX app does
    res_m, ck_m = tmp / "res_map", tmp / "ck_map"
    rep, counts = run_app(run_kitti, base + [
        "--mapping", "--results-dir", res_m, "--checkpoint-dir", ck_m,
        "--checkpoint-every", APP_CK_EVERY], check, "run_kitti --mapping")
    eager_reps["run_kitti --mapping"] = rep
    est_m = read_poses(res_m / "poses.txt")
    ate = traj_ate(est_m, gt_pos)
    want_m = launches(smoothness=n, select_edges=n, knn_coords=2 * n,
                      local_map_compact=n + 1, probe_insert=n)
    check(ate < 0.1, f"run_kitti --mapping ATE {ate:.4f} m")
    check(rep["map_overflow"] == 0 and rep["local_map_truncated"] == 0,
          f"run_kitti --mapping: overflow {rep['map_overflow']}, local map "
          f"truncated by {rep['local_map_truncated']}")
    check(counts == want_m, f"run_kitti --mapping launch counts {counts} "
          f"!= {want_m}")
    check(rep["host_syncs"] == 0, f"run_kitti --mapping: "
          f"{rep['host_syncs']} host synchronisations between due points")
    emit(app_line("run_kitti --mapping", rep, counts, smi,
                  ate_m_first_20=ate))

    # --aot: each of the three runs again with its steps captured before
    # frame 0; the launch counters count the captures' calls only
    for label, extra, ref, exact in (
            ("run_kitti", [], est, True),
            ("run_kitti --chunk 12", ["--chunk", 12], est, True),
            ("run_kitti --mapping", ["--mapping"], est_m, False)):
        res_a = tmp / f"res_aot_{len(extra)}"
        rep, counts = run_app(run_kitti, base + extra + [
            "--aot", "--results-dir", res_a], check, f"{label} --aot")
        gap = traj_gap(read_poses(res_a / "poses.txt"), ref)
        check(gap[0] <= 1e-6 if exact else (gap[0] < 0.01 and gap[1] < 1e-3),
              f"{label} --aot vs eager: {gap}")
        check(rep["host_syncs"] == 0, f"{label} --aot: {rep['host_syncs']} "
              "host synchronisations between due points")
        eager = eager_reps[label]
        emit(app_line(f"{label} --aot", rep, counts, smi,
                      graphs=rep.get("graphs"),
                      aot_capture_s=rep.get("aot_capture_s"),
                      vs_eager_max_dt_m_drot_rad=gap,
                      eager_first_frame_s=eager.get("first_frame_s"),
                      eager_scans_per_s=eager.get("scans_per_s")))

    # the resumes, each in a new process: the map restored there needs
    # nothing of the look-back status words K7 keeps per device
    res_mr = tmp / "res_map_resumed"
    rep = run_app_process(fresh, "run_kitti", base + [
        "--mapping", "--results-dir", res_mr, "--checkpoint-dir", ck_m],
        check, "run_kitti --mapping resumed")
    gap = traj_gap(read_poses(res_mr / "poses.txt")[APP_CK_EVERY:],
                   est_m[APP_CK_EVERY:])
    check(rep.get("start_frame") == APP_CK_EVERY, f"run_kitti --mapping "
          f"resumed at {rep.get('start_frame')}")
    check(gap[0] < 0.01 and gap[1] < 1e-3, f"run_kitti --mapping resumed "
          f"vs uninterrupted: {gap}")
    check(rep.get("kernel_build") == "cold", "the first new process found the "
          "kernels built")
    check(rep["host_syncs"] == 0, f"run_kitti --mapping resumed: "
          f"{rep['host_syncs']} host synchronisations between due points")
    emit(app_line("run_kitti --mapping, resumed in a new process", rep,
                  None, smi, vs_uninterrupted_max_dt_m_drot_rad=gap))
    res_r = tmp / "res_resumed"
    rep = run_app_process(fresh, "run_kitti", base + [
        "--results-dir", res_r, "--checkpoint-dir", ck], check,
        "run_kitti resumed")
    gap = traj_gap(read_poses(res_r / "poses.txt")[APP_CK_EVERY:],
                   est[APP_CK_EVERY:])
    check(rep.get("start_frame") == APP_CK_EVERY, f"run_kitti resumed at "
          f"{rep.get('start_frame')}")
    check(gap[0] <= 1e-6, f"run_kitti resumed vs uninterrupted: {gap}")
    check(rep.get("kernel_build") == "warm", "the second new process rebuilt "
          f"{rep.get('compiled')}")
    check(rep["host_syncs"] == 0, f"run_kitti resumed: {rep['host_syncs']} "
          "host synchronisations between due points")
    emit(app_line("run_kitti, resumed in a new process", rep, None, smi,
                  vs_uninterrupted_max_dt_m_drot_rad=gap))

    # run_synthetic: its defaults (20 frames), then the map on raw scans
    for label, argv in (("run_synthetic", []),
                        ("run_synthetic --mapping --raw-path",
                         ["--mapping", "--raw-path"])):
        rep, counts = run_app(run_synthetic, argv, check, label)
        check(rep["ate_m"] < 0.1, f"{label} ATE {rep['ate_m']:.4f} m")
        check(rep["host_syncs"] == 0, f"{label}: {rep['host_syncs']} host "
              "synchronisations between its frames")
        emit(app_line(label, rep, counts, smi))

    # run_ouster --dir on phase 6's organised clouds (the 128-row preset),
    # then a resume whose checkpoint covers every file
    odir, res_o, ck_o = tmp / "ouster", tmp / "res_ouster", tmp / "ck_ouster"
    odir.mkdir()
    for i, spin in enumerate(spins[:N_OUSTER_APP]):
        np.save(odir / f"{i:06d}.npy", organized_from_unorganized(
            spin, OUSTER_CFG.scan_lines, OUSTER_COLS))
    o_args = ["--dir", odir, "--prefetch", 8, "--checkpoint-dir", ck_o,
              "--checkpoint-every", N_OUSTER_APP]
    rep, counts = run_app(run_ouster, o_args + ["--results-dir", res_o],
                          check, "run_ouster")
    ate = traj_ate(read_poses(res_o / "poses.txt"), gt_pos)
    want_o = launches(smoothness=N_OUSTER_APP, select_edges=N_OUSTER_APP,
                      knn_coords=2 * N_OUSTER_APP)
    check(rep["rings"] == OUSTER_CFG.scan_lines
          and rep["frames"] == N_OUSTER_APP, f"run_ouster read "
          f"{rep['rings']} rows, {rep['frames']} frames")
    check(ate < 0.1, f"run_ouster ATE {ate:.4f} m")
    check(counts == want_o, f"run_ouster launch counts {counts}")
    check(rep["host_syncs"] == 0, f"run_ouster: {rep['host_syncs']} host "
          "synchronisations between due points")
    emit(app_line("run_ouster --dir", rep, counts, smi, ate_m_first_20=ate))
    res_oa = tmp / "res_ouster_aot"
    rep_a, counts = run_app(run_ouster, ["--dir", odir, "--prefetch", 8,
                                         "--aot", "--results-dir", res_oa],
                            check, "run_ouster --dir --aot")
    gap = traj_gap(read_poses(res_oa / "poses.txt"),
                   read_poses(res_o / "poses.txt"))
    check(gap[0] <= 1e-6, f"run_ouster --dir --aot vs eager: {gap}")
    check(rep_a["host_syncs"] == 0, f"run_ouster --dir --aot: "
          f"{rep_a['host_syncs']} host synchronisations between due points")
    emit(app_line("run_ouster --dir --aot", rep_a, counts, smi,
                  graphs=rep_a.get("graphs"),
                  aot_capture_s=rep_a.get("aot_capture_s"),
                  vs_eager_max_dt_m_drot_rad=gap,
                  eager_first_frame_s=rep.get("first_frame_s"),
                  eager_scans_per_s=rep.get("scans_per_s")))
    rep, counts = run_app(run_ouster, o_args, check, "run_ouster resumed")
    check(rep.get("frames") == 0 and counts == launches(),
          f"run_ouster resumed past its files ran {rep.get('frames')} "
          f"frames, launches {counts}")
    emit(app_line("run_ouster, checkpoint covers every file", rep, counts,
                  smi))

    # run_mapping on run_kitti's trajectory
    map_out = tmp / "map_out"
    rep, counts = run_app(run_mapping, base + [
        "--poses", res / "poses.txt", "--out", map_out], check,
        "run_mapping")
    want = launches(smoothness=n, select_edges=n, probe_insert=n,
                    local_map_compact=1)
    check(rep["occupied_slots"] > 0, "run_mapping: empty map")
    check((map_out / "map.ply").exists(), "run_mapping wrote no map.ply")
    check(counts == want, f"run_mapping launch counts {counts} != {want}")
    emit(app_line("run_mapping", rep, counts, smi))
    stream_runs(smi, check)
    longcourse_runs(tmp, fresh, smi, check)
    emit({"phase": "apps", "run": "all",
          "seconds": time.perf_counter() - t_phase})


def any_k_drives(cfg, ccfg, bimgs, lanes_b, gt_pos, mesh, check) -> dict:
    """The steps at ``knn_k`` = ANY_K, past the register walk, so that the
    kNN kernels run ListWalk (each drive's counters set to 0 just before
    and read just after): ``image_step`` over N_ATE bench frames (K3 on
    ListWalk twice a frame, its ATE reported, not held: k = 20 is not the
    reference's setting), its first N_CPU_FRAMES against the port's CPU
    path (< 1 cm, < 1e-3 rad, equal edge counts); under ``pallas_lines``
    (K6), ``batch_image_step`` on the bench lanes (K4, lane 0 against the
    solo drive) and the sharded flagship on ``mesh`` (K5, against
    ``combined_image_step`` at the same k), N_ANY_K frames each, within
    1 cm and 1e-3 rad; no host synchronisation anywhere."""
    k20, c20 = cfg.replace(knn_k=ANY_K), ccfg.replace(knn_k=ANY_K)
    n = N_ANY_K
    out, counts = {}, {}

    def drive(name, run, **want):
        torch.cuda.synchronize()
        reset_counters()
        (_, poses, ne), syncs = sync_free(run)
        counts[name] = read_counters()
        check(counts[name] == launches(**want),
              f"knn_k={ANY_K} {name}: launches {counts[name]}")
        check(not syncs, f"knn_k={ANY_K} {name}: {len(syncs)} host syncs")
        return poses, ne

    poses, ne = drive("image_step", lambda: run_course(
        P.init_state(k20), bimgs[:N_ATE], k20, keep=False),
        smoothness=N_ATE, select_edges=N_ATE, knn_coords_any_k=2 * N_ATE)
    t, q, _, ate = drive_error(poses, gt_pos[:N_ATE])
    ne = torch.stack(ne).cpu().numpy()
    cpu = [RingImage(im.xyz.cpu(), im.count.cpu())
           for im in bimgs[:N_CPU_FRAMES]]
    _, cposes, cedges = run_course(P.init_state(k20, device="cpu"), cpu, k20)
    ct, cq, _, _ = drive_error(cposes, gt_pos[:N_CPU_FRAMES])
    dt, dr = pose_gaps(ct, cq, t[:N_CPU_FRAMES], q[:N_CPU_FRAMES])
    same = [int(c) for c in cedges] == ne[:N_CPU_FRAMES].tolist()
    check(dt.max() < 0.01 and dr.max() < 1e-3 and same,
          f"knn_k={ANY_K}: card vs CPU path {dt.max():.2e} m "
          f"{dr.max():.2e} rad, same edge counts {same}")
    out["image_step"] = {
        "frames": N_ATE, "launches": counts["image_step"],
        f"ate_m_first_{N_ATE}": ate, "n_edges_min": int(ne.min()),
        "cpu_frames": N_CPU_FRAMES, "cpu_max_dt_m": float(dt.max()),
        "cpu_max_drot_rad": float(dr.max()), "cpu_same_n_edges": same}

    def near(name, poses, ref_t, ref_q):
        pt, pq, _, _ = drive_error(poses, gt_pos[:n])
        gt, gr = pose_gaps(pt, pq, ref_t, ref_q)
        check(gt.max() < 0.01 and gr.max() < 1e-3,
              f"knn_k={ANY_K} {name}: {gt.max():.2e} m {gr.max():.2e} rad")
        out[name] = {"frames": n, "launches": counts[name],
                     "max_dt_m": float(gt.max()),
                     "max_drot_rad": float(gr.max())}

    os.environ["LIODOM_KNN_IMPL"] = "pallas_lines"
    lp, _ = drive("lines", lambda: run_course(
        P.init_state(k20), bimgs[:n], k20, keep=False),
        smoothness=n, select_edges=n, knn_lines_any_k=2 * n)
    os.environ["LIODOM_KNN_IMPL"] = "pallas_coords"
    near("lines", lp, t[:n], q[:n])
    bp, _ = drive("batch", lambda: run_course(
        init_batch_state(k20, LANES), lanes_b[:n], k20, keep=False,
        step=P.batch_image_step),
        smoothness=n, select_edges=n, knn_coords_batched_any_k=2 * n)
    near("batch", [se3.Pose(p.q[0], p.t[0]) for p in bp], t[:n], q[:n])
    cp, _ = drive("combined", lambda: run_combined(
        *S.init_combined(c20, MCFG), bimgs[:n], c20, keep=False),
        smoothness=n, select_edges=n, knn_coords_any_k=2 * n,
        local_map_compact=n, probe_insert=n)
    cpt, cpq, _, _ = drive_error(cp, gt_pos[:n])
    sstep = CB.make_sharded_combined_image_step(mesh, c20, MCFG)
    sp, _ = drive("sharded", lambda: run_sharded(
        *CB.init_combined_image_sharded(c20, MCFG, mesh), bimgs[:n], sstep,
        keep=False),
        smoothness=n, select_edges=n, knn_index_any_k=2 * n,
        local_map_compact=n, probe_insert=n)
    near("sharded", sp, cpt, cpq)
    out["combined"] = {"frames": n, "launches": counts["combined"]}
    return out


def wide_planes(dev, rings: int, width: int, seed: int, counts=()):
    """Rings of ``width`` columns sampled every 5 cm along gentle curves
    (~12 % of the gaps broken, so a pick suppresses up to 5 neighbours a
    side), counts within 2,000 of the width and one ring below
    ``min_points``, the first rings' counts ``counts`` where given, and a
    smoothness plane quantised to 1/8 (many exact ties), all from
    ``seed``: (RingImage, smoothness) on ``dev``."""
    rng = np.random.default_rng(seed)
    s = np.cumsum(np.where(rng.random((rings, width)) < 0.12, 0.4, 0.05),
                  axis=1)
    off = np.arange(rings)[:, None]
    xyz = np.stack([10.0 + np.cos(s * 0.01 + off), s,
                    0.1 * np.sin(s * 0.3 + off)], -1).astype(np.float32)
    count = (width - rng.integers(0, 2000, rings)).astype(np.int32)
    count[5] = 20
    count[:len(counts)] = counts
    xyz[np.arange(width)[None, :] >= count[:, None]] = 0.0
    sm = (np.round(rng.random((rings, width)) * 8.0) / 8.0).astype(np.float32)
    return (RingImage(torch.from_numpy(xyz).to(dev),
                      torch.from_numpy(count).to(dev)),
            torch.from_numpy(sm).to(dev))


def region_lengths(count, cfg):
    """(R, n_regions) int64: each region's columns on rings of ``count``
    points (0 on a ring below ``min_points``), as select_plain cuts them:
    total = count - 10 in sectors of total // n_regions, the last taking
    the rest."""
    n = cfg.scan_regions
    total = torch.clamp(count.long() - 10, min=0)
    lens = (total // n)[:, None].repeat(1, n)
    lens[:, -1] = total - total // n * (n - 1)
    return torch.where((count >= cfg.min_points_per_scan)[:, None], lens, 0)


def select_bound(img, sm, cfg, bval):
    """(bound_ms, bound_by) of K2 on ``img``: what the function needs. It
    reads the counts, each active region's smoothness, and the points
    within 5 columns of a list entry (the first min(L, len) columns of a
    region's (value desc, column asc) order, the only columns whose reach
    the walk can ask for; the picks' points are among them), and writes
    the slots; 8 operations a column for the gaps of those points, 2
    compares a scanned column (per ring and region, the picks made plus
    the failing one, at most max_picks, passes over the region)."""
    r, w = img.xyz.shape[:2]
    n, mp = cfg.scan_regions, cfg.max_edges_per_region
    dev = sm.device
    lens = region_lengths(img.count, cfg)
    starts = 5 + torch.cumsum(lens, 1) - lens
    cols = torch.arange(w, device=dev)[None, :]
    region = torch.full((r, w), n, dtype=torch.int64, device=dev)
    for j in range(n):
        inside = (cols >= starts[:, j:j + 1]) & (
            cols < starts[:, j:j + 1] + lens[:, j:j + 1])
        region = torch.where(inside, j, region)
    # each region's (key, column) order in one sort of the ring: region,
    # then key (ascending as the value descends), then column
    order = torch.sort((region << 56) | (SEL.order_keys(sm) << 24) | cols,
                       dim=1).values
    j = order >> 56
    inside = j < n
    jj = torch.clamp(j, max=n - 1)
    rank = (torch.arange(w, device=dev)[None, :]
            - (torch.cumsum(lens, 1) - lens).gather(1, jj))
    cap = torch.clamp(lens, max=SEL.walk_list_len(mp)).gather(1, jj)
    entry = order & 0xFFFFFF
    listed = inside & (rank < cap)
    need = torch.zeros((r, w + 10), dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev)[:, None].expand(r, w)[listed]
    at = entry[listed]
    for d in range(11):                 # columns at - 5 .. at + 5
        need[rows, at + d] = True
    points = int(need[:, 5:w + 5].sum())
    slots = n * mp
    bval = bval.reshape(r, n, mp)
    passes = torch.clamp(bval.sum(-1) + 1, max=mp)
    scanned = int((passes * lens).sum())
    return bound(r * 4 + int(lens.sum()) * 4 + points * 12
                 + r * slots * (4 + 4 + 12), 8 * points + 2 * scanned)


def select_global_equal(img, sm, cfg):
    """(equal, edges): K2's device-memory path on ``img`` against
    select_plain, bidx, bval and the points bit for bit."""
    bidx, bval, pts = SEL.select_slots_global(img, sm, cfg)
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    pidx, pval = SEL.select_plain(sm, reach, img.count, cfg)
    w = img.xyz.shape[1]
    want = torch.gather(img.xyz, 1, torch.clamp(pidx, 0, w - 1).long()[
        :, :, None].expand(-1, -1, 3))
    want = torch.where(pval[:, :, None], want, torch.zeros_like(want))
    same = (torch.equal(bidx, pidx) and torch.equal(bval != 0, pval)
            and torch.equal(pts.reshape(want.shape), want))
    return same, int(pval.sum())


def select_wide_phase(cfg, img, sm, raws, poses, dev, check) -> dict:
    """K2 where a ring's arrays exceed a block's shared memory
    (WIDE_RINGS on 64 seeded rings): ``select_smem_bytes`` above 227 KB,
    the wrapper's launch on the device-memory path, bidx, bval and the
    points ``torch.equal`` to ``select_plain``, timed beside it and the
    earlier design's time; the same at SCRATCH_RINGS, each layout of that
    path taken (a region's order keys read from the plane, then the lists
    and slots in the device scratch); on 16 rings, either side of each
    layout boundary, found from ``select_global_shape``, and regions no
    longer than their list (counts from min_points to 10 + 8 L); that path
    called directly on the bench frame (88 and 168 slots) equal to the
    shared-memory kernel; and ``image_step`` at ring width 49,152 over the
    main drive's first N_ANY_K raw scans (K2 on that path once a frame):
    poses within 1e-6 m of the main drive's (the picks depend on the
    counts, not the width)."""
    out = {}
    for seed, (w, picks) in enumerate(WIDE_RINGS):
        c = cfg.replace(edges_per_region=picks, ring_width=w)
        wimg, wsm = wide_planes(dev, 64, w, seed)
        smem = SEL.select_smem_bytes(w, c.scan_regions,
                                     c.max_edges_per_region)
        check(smem > 232448, f"K2 at {w} columns fits shared memory")
        bidx, bval, pts = SEL.select_slots_global(wimg, wsm, c)
        reach = SEL._reach_plane(wimg.xyz, c.neighbor_gap_sq)
        pidx, pval = SEL.select_plain(wsm, reach, wimg.count, c)
        pedges = SEL.select_edges_plain(wimg, wsm, c)
        before = SEL.select_edges_global_cuda.launches
        edges = SEL.select_edges_cuda(wimg, wsm, c)
        took = SEL.select_edges_global_cuda.launches - before
        same = (torch.equal(bidx, pidx) and torch.equal(bval != 0, pval)
                and torch.equal(pts.reshape(-1, 3), pedges.xyz)
                and torch.equal(edges.xyz, pedges.xyz)
                and torch.equal(edges.valid, pedges.valid))
        check(same and took == 1,
              f"K2 at {w} columns, {c.scan_regions * c.max_edges_per_region}"
              f" slots: equal {same}, device-memory launches {took}")
        b = select_bound(wimg, wsm, c, pval)
        s_ = c.scan_regions * c.max_edges_per_region
        ms = cuda_ms(lambda: SEL.select_edges_cuda(wimg, wsm, c), 10)
        out[f"rings64x{w}_slots{s_}"] = {
            "smem_bytes_needed": smem, "bit_exact": same,
            "n_edges": int(pval.sum()),
            **SEL.select_global_shape(w, c.scan_regions,
                                      c.max_edges_per_region),
            "ms": ms, "earlier_ms": K2W_EARLIER_MS[(w, s_)],
            "plain_ms": cuda_ms(lambda: SEL.select_edges_plain(wimg, wsm, c),
                                2, 1),
            "bound_ms": b[0], "bound_by": b[1], "share_of_bound": b[0] / ms}
    # the layouts at 49,152 columns: SCRATCH_RINGS on 64 rings, timed; on
    # 16 rings, either side of each boundary found from the library's shape
    # (the last picks a region whose keys shared memory holds, and the last
    # whose lists it holds), and regions no longer than their list
    w = 49152
    regions = cfg.scan_regions
    shapes = {mp: SEL.select_global_shape(w, regions, mp)
              for mp in range(1, 400)}
    planes = {64: wide_planes(dev, 64, w, len(WIDE_RINGS)),
              16: wide_planes(dev, 16, w, len(WIDE_RINGS) + 1)}

    def longest_region(rings):
        return int(region_lengths(planes[rings][0].count, cfg).max())

    keys_edge = min(mp for mp, lay in shapes.items()
                    if lay["keys_in_smem"] < longest_region(16)) - 1
    lists_edge = min(mp for mp, lay in shapes.items()
                     if lay["lists_in_scratch"]) - 1
    cases = [(64, picks, where) for picks, where in SCRATCH_RINGS]
    cases += [(16, keys_edge - 1, "keys_edge"), (16, keys_edge, "values"),
              (16, lists_edge - 1, "lists_edge"), (16, lists_edge, "lists")]
    for rings, picks, where in cases:
        wimg, wsm = planes[rings]
        longest = longest_region(rings)
        c = cfg.replace(edges_per_region=picks, ring_width=w)
        mp = c.max_edges_per_region
        lay = shapes[mp]
        in_scratch = {"values": lay["keys_in_smem"] < longest,
                      "lists": lay["lists_in_scratch"]}
        want_in = {"values": where == "values", "lists": where == "lists"}
        if where == "lists_edge":       # past the keys' edge: either
            want_in["values"] = in_scratch["values"]
        same, n_edges = select_global_equal(wimg, wsm, c)
        s_ = regions * mp
        name = (f"rings{rings}x{w}_slots{s_}_{where}_in_scratch"
                if where in ("values", "lists") else
                f"rings{rings}x{w}_slots{s_}_{where}")
        out[name] = {**lay, "longest_region": longest, "bit_exact": same,
                     "n_edges": n_edges}
        if rings == 64:
            out[name]["ms"] = cuda_ms(
                lambda: SEL.select_slots_global(wimg, wsm, c), 5)
        check(in_scratch == want_in,
              f"K2 at {w} columns, {s_} slots ({where}): layout {lay}, "
              f"longest region {longest}")
        check(same and n_edges > 0,
              f"K2 at {w} columns, {s_} slots ({where}): not equal to "
              "select_plain")
    out["layout_edges"] = {"keys_in_smem_last_max_picks": keys_edge,
                           "lists_in_smem_last_max_picks": lists_edge,
                           "longest_region_16_rings": longest_region(16)}
    # regions no longer than their list (the radix select skipped, every
    # entry ranked): at 8 x 330 slots, L = 3,635, rings whose counts lie
    # between min_points and 10 + 8 L, at and either side of both
    c = cfg.replace(edges_per_region=SCRATCH_RINGS[1][0], ring_width=w)
    lo, top = c.min_points_per_scan, 10 + regions * SEL.walk_list_len(
        c.max_edges_per_region)
    counts = (lo - 1, lo, lo + 37, (lo + top) // 2, top - 1, top, top + 1)
    wimg, wsm = wide_planes(dev, 16, w, len(WIDE_RINGS) + 2, counts)
    lens = region_lengths(wimg.count, c)
    lens = lens[lens > 0]
    short = int((lens < SEL.walk_list_len(c.max_edges_per_region)).sum())
    exact = int((lens == SEL.walk_list_len(c.max_edges_per_region)).sum())
    same, n_edges = select_global_equal(wimg, wsm, c)
    check(short > 0 and exact > 0 and same and n_edges > 0,
          f"K2 at {w} columns, {regions * c.max_edges_per_region} slots, "
          f"regions no longer than L ({short} shorter, {exact} of L): equal "
          f"{same}, {n_edges} edges")
    out[f"rings16x{w}_slots{regions * c.max_edges_per_region}_short_regions"] = {
        "counts": list(counts), "regions_shorter_than_list": short,
        "regions_of_list_length": exact, "bit_exact": same,
        "n_edges": n_edges}
    for c in (cfg, cfg.replace(edges_per_region=20)):
        got = SEL.select_edges_global_cuda(img, sm, c)
        want = SEL.select_edges_cuda(img, sm, c)
        same = (torch.equal(got.valid, want.valid)
                and torch.equal(got.xyz, want.xyz))
        s_ = c.scan_regions * c.max_edges_per_region
        check(same, f"K2's device-memory path at the bench shape, {s_} slots")
        out[f"bench_slots{s_}_equal_to_smem_path"] = same
    out["bench_ms"] = cuda_ms(
        lambda: SEL.select_edges_global_cuda(img, sm, cfg), 50)
    out["bench_smem_path_ms"] = cuda_ms(
        lambda: SEL.select_edges_cuda(img, sm, cfg), 50)
    # image_step at ring width 49,152: the path in a drive
    wc = cfg.replace(ring_width=WIDE_RINGS[0][0])
    wimgs = [F.split_scan(r, wc) for r in raws[:N_ANY_K]]
    torch.cuda.synchronize()
    reset_counters()
    (_, wp, _), syncs = sync_free(lambda: run_course(
        P.init_state(wc), wimgs, wc, keep=False))
    counts = read_counters()
    want = launches(smoothness=N_ANY_K, select_edges_global=N_ANY_K,
                    knn_coords=2 * N_ANY_K)
    gap = max(float((a.t - b.t).norm()) for a, b in zip(wp, poses))
    equal = all(torch.equal(a.t, b.t) and torch.equal(a.q, b.q)
                for a, b in zip(wp, poses))
    check(counts == want, f"image_step at {wc.ring_width} columns: "
          f"launches {counts}")
    check(gap <= 1e-6 and not syncs,
          f"image_step at {wc.ring_width} columns: {gap:.2e} m from the "
          f"main drive, {len(syncs)} host syncs")
    out["image_step_ring_width_49152"] = {
        "frames": N_ANY_K, "launches": counts, "max_dt_m_to_main": gap,
        "poses_equal_to_main": equal}
    return out, counts


def compact_wide_phase(kmap, kbase, imgs, ccfg, check):
    """K7 past the targets a block's shared memory holds: at
    ``cells_xy`` = CELLS_XY_WIDE on the combined drive's 524,288-slot map
    at the bench capacity and at 1,024 (a truncating cut), rows, validity
    and ``n_hits`` ``torch.equal`` to ``compact_hits_plain`` (the wrapper
    takes the device-memory path); that path called directly at 75 and 174
    targets and either side of its first fence-stride change (the targets
    nearest the base); and N_ANY_K frames of ``combined_image_step`` at that
    ``cells_xy``, every refresh's local map equal to the plain version's
    on the frame's map and pose."""
    offs = G.local_map_offsets(MCFG, cells_xy=CELLS_XY_WIDE)
    check(len(offs) > K7.MAX_TARGETS, f"{len(offs)} targets fit K7's smem")
    cap = MCFG.local_map_capacity
    m = (kmap.xyz, kmap.key, kmap.valid)
    out = {"targets": len(offs)}
    for c in (cap, 1024):
        before = K7.compact_hits_global_cuda.launches
        got = K7.compact_hits_cuda(*m, kbase, offs, c)
        took = K7.compact_hits_global_cuda.launches - before
        want = K7.compact_hits_plain(*m, kbase, offs, c)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same and took == 1, f"K7 at {len(offs)} targets, capacity {c}:"
              f" equal {same}, device-memory launches {took}")
        out[f"cap{c}"] = {"n_hits": int(got[2]), "bit_exact": same}
    check(out["cap1024"]["n_hits"] > 1024, "K7: 1,024 did not truncate")
    for kw in ({"cells_xy": 3, "cells_z": 16}, {"cells_xy": 6, "cells_z": 3}):
        o = G.local_map_offsets(MCFG, **kw)
        got = K7.compact_hits_global_cuda(*m, kbase, o, cap)
        want = K7.compact_hits_plain(*m, kbase, o, cap)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"K7's device-memory path at {len(o)} targets")
        out[f"entry_targets{len(o)}"] = {"n_hits": int(got[2]),
                                         "bit_exact": same}
    # either side of the first fence-stride change (1 to 2), found from the
    # library's fence, the targets nearest the base so that some rows hit
    near = offs[np.argsort(np.abs(offs).sum(1), kind="stable")]
    edge = next(n for n in range(1, len(offs))
                if K7.compact_shape(kmap.xyz.shape[0], n + 1)[
                    "fence_stride"] > 1)
    for n in (edge, edge + 1):
        o = near[:n]
        got = K7.compact_hits_global_cuda(*m, kbase, o, cap)
        want = K7.compact_hits_plain(*m, kbase, o, cap)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        shape = K7.compact_shape(kmap.xyz.shape[0], n)
        check(same and int(got[2]) > 0
              and shape["fence_stride"] == K7.fence_stride(n),
              f"K7's device-memory path at {n} targets (fence {shape}): "
              f"equal {same}, {int(got[2])} hits")
        out[f"stride_edge_targets{n}"] = {
            "n_hits": int(got[2]), "bit_exact": same,
            "fence_stride": shape["fence_stride"],
            "fence_entries": shape["fence_entries"]}
    check(out[f"stride_edge_targets{edge}"]["fence_stride"] == 1
          and out[f"stride_edge_targets{edge + 1}"]["fence_stride"] == 2,
          "K7's fence stride does not change at the edge")
    occupied = int(kmap.valid.sum())
    out["fence"] = {k_: v for k_, v in K7.compact_shape(
        kmap.xyz.shape[0], len(offs)).items() if k_.startswith("fence")}
    out["ms"] = cuda_ms(lambda: K7.compact_hits_cuda(*m, kbase, offs, cap),
                        50)
    out["plain_ms"] = cuda_ms(
        lambda: K7.compact_hits_plain(*m, kbase, offs, cap), 2, 1)
    # the mask, the keys of the occupied rows, the hit rows kept, the
    # buffer, its mask and the count; a binary search of ceil(log2 K) + 1
    # steps of 3 compares an occupied row
    steps = math.ceil(math.log2(len(offs))) + 1
    b = bound(kmap.xyz.shape[0] + occupied * 12
              + min(out[f"cap{cap}"]["n_hits"], cap) * 12 + cap * 13 + 4,
              occupied * steps * 3)
    out.update(bound_ms=b[0], bound_by=b[1], occupied=occupied,
               share_of_bound=b[0] / out["ms"],
               earlier_ms=K7W_EARLIER_MS)
    # the combined step at that neighbourhood
    wide = MCFG.replace(cells_xy=CELLS_XY_WIDE)
    torch.cuda.synchronize()
    reset_counters()
    (states, poses, _), syncs = sync_free(lambda: run_combined(
        *S.init_combined(ccfg, wide), imgs[:N_ANY_K], ccfg, mcfg=wide))
    counts = read_counters()
    want = launches(smoothness=N_ANY_K, select_edges=N_ANY_K,
                    knn_coords=2 * N_ANY_K, probe_insert=N_ANY_K,
                    local_map_compact_global=N_ANY_K)
    refresh = []
    for (odom, mp), p in zip(states, poses):
        want_map = K7.compact_hits_plain(
            mp.xyz, mp.key, mp.valid, G.cell_keys(torch.trunc(p.t), wide),
            offs, wide.local_map_capacity)
        refresh.append(torch.equal(odom.received_xyz, want_map[0])
                       and torch.equal(odom.received_valid, want_map[1]))
    check(counts == want, f"combined at cells_xy={CELLS_XY_WIDE}: launches "
          f"{counts}")
    check(all(refresh) and not syncs,
          f"combined at cells_xy={CELLS_XY_WIDE}: refreshes equal {refresh},"
          f" {len(syncs)} host syncs")
    out["combined_image_step"] = {"frames": N_ANY_K, "launches": counts,
                                  "refreshes_equal_to_plain": refresh}
    return out, counts


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
    acc = render_lanes(cfg, dev, range(LANES), noise=0.0, keep_raw=(0,))
    bench = render_lanes(cfg, dev, range(max(TIMED_BATCHES)), noise=0.01,
                         keep_raw=(0,))
    render_s = time.perf_counter() - t0
    imgs, gt_pos, gt_yaw, raws, spins = acc[0]

    state = P.init_state(cfg)
    torch.cuda.synchronize()
    reset_counters()
    (states, poses, n_edges), syncs = sync_free(
        lambda: run_course(state, imgs, cfg))
    counts = read_counters()
    main_drive = (poses, n_edges)            # held by the aot phase
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

    # ---- 6. the raw-scan front end: full_step, combined_step, Ouster ------
    t0 = time.perf_counter()
    raw_path = {}
    torch.cuda.synchronize()
    reset_counters()
    (_, fposes, fedges), fsyncs = sync_free(
        lambda: run_full(P.init_state(cfg), raws, cfg, keep=False))
    fcounts = read_counters()
    ft, fq, ferr, fate = drive_error(fposes, gt_pos)
    f_same = same_poses(fposes, poses)
    f_same_edges = torch.equal(torch.stack(fedges), torch.stack(n_edges))
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES)
    check(fcounts == want, f"full_step launch counts {fcounts} != {want}")
    check(all(f_same), f"full_step vs image_step: poses differ at frames "
          f"{[i for i, ok in enumerate(f_same) if not ok]}")
    check(f_same_edges, "full_step vs image_step: different edge counts")
    check(fate < 0.1, f"full_step ATE over {N_ATE} frames {fate:.4f} m")
    check(not fsyncs, f"{len(fsyncs)} host synchronisations in full_step: "
          f"{fsyncs[:1]}")
    raw_path["full_step"] = {
        "launches": fcounts, f"ate_m_first_{N_ATE}": fate,
        "poses_equal_to_image_step": sum(f_same),
        "same_n_edges": f_same_edges, "host_syncs": len(fsyncs)}

    torch.cuda.synchronize()
    reset_counters()
    (rc_states, rc_poses, rc_edges), rcsyncs = sync_free(
        lambda: run_combined_raw(*S.init_combined(ccfg, MCFG), raws, ccfg))
    rccounts = read_counters()
    rct, rcq, rcerr, rcate = drive_error(rc_poses, gt_pos)
    rc_overflow = int(rc_states[-1][1].overflow)
    rc_hits = [int(G.get_local_map(m, p.t, MCFG,
                                   capacity=MCFG.local_map_capacity)[2])
               for (_, m), p in zip(rc_states, rc_poses)]
    del rc_states
    rc_dt, rc_dr = pose_gaps(rct, rcq, ct, cq)
    rc_gap = (float(rc_dt[:N_ATE].max()), float(rc_dr[:N_ATE].max()))
    rc_free_same = same_poses(rc_poses, cposes_k)
    # each frame from phase 4's state before it: the same pose, bit for bit
    rc_step_same = []
    prev = S.init_combined(ccfg, MCFG)
    for i, raw in enumerate(raws):
        _, _, p_i, ne_i = S.combined_step(*prev, raw.xyz, raw.valid, ccfg,
                                          MCFG, step=0, local_map_every=4)
        rc_step_same.append(same_poses([p_i], [cposes_k[i]])[0]
                            and int(ne_i) == int(cne[i]))
        prev = cstates[i]
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES, local_map_compact=N_FRAMES,
                    probe_insert=N_FRAMES)
    check(rccounts == want, f"combined_step launch counts {rccounts} != "
          f"{want}")
    check(all(rc_step_same), f"combined_step vs combined_image_step from "
          f"the same state: poses differ at frames "
          f"{[i for i, ok in enumerate(rc_step_same) if not ok]}")
    check(rc_gap[0] < 0.01 and rc_gap[1] < 1e-3, f"combined_step vs "
          f"combined_image_step, free-running, over {N_ATE} frames: "
          f"{rc_gap}")
    check(rcate < 0.1, f"combined_step ATE over {N_ATE} frames "
          f"{rcate:.4f} m")
    check(rc_overflow == 0, f"combined_step: {rc_overflow} points dropped")
    check(max(rc_hits) <= MCFG.local_map_capacity,
          f"combined_step: local map truncated ({max(rc_hits)} hits)")
    check(not rcsyncs, f"{len(rcsyncs)} host synchronisations in "
          f"combined_step: {rcsyncs[:1]}")
    raw_path["combined_step"] = {
        "launches": rccounts, f"ate_m_first_{N_ATE}": rcate,
        "poses_equal_from_phase_4_states": sum(rc_step_same),
        "free_running_poses_equal": sum(rc_free_same),
        f"free_running_max_dt_m_drot_rad_first_{N_ATE}": rc_gap,
        "free_running_dt_m_per_frame": rc_dt.tolist(),
        "free_running_drot_rad_per_frame": rc_dr.tolist(),
        "overflow": rc_overflow, "n_hits_max": max(rc_hits),
        "host_syncs": len(rcsyncs)}

    clouds = [torch.from_numpy(organized_from_unorganized(
        sp, OUSTER_CFG.scan_lines, OUSTER_COLS)).to(dev) for sp in spins]
    torch.cuda.synchronize()
    reset_counters()
    (_, oposes, oedges), osyncs = sync_free(
        lambda: run_full(P.init_state(OUSTER_CFG), clouds, OUSTER_CFG,
                         keep=False))
    ocounts = read_counters()
    ot, oq, oerr, oate = drive_error(oposes, gt_pos)
    one = torch.stack(oedges).cpu().numpy()
    _, ocposes, ocedges = run_full(
        P.init_state(OUSTER_CFG, device="cpu"),
        [c.cpu() for c in clouds[:N_CPU_FRAMES]], OUSTER_CFG)
    o_gap = pose_gap(torch.stack([p.t for p in ocposes]).numpy(),
                     torch.stack([p.q for p in ocposes]).numpy(),
                     ot[:N_CPU_FRAMES], oq[:N_CPU_FRAMES])
    o_same_edges = [int(c) for c in ocedges] == one[:N_CPU_FRAMES].tolist()
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES)
    check(ocounts == want, f"Ouster full_step launch counts {ocounts} != "
          f"{want}")
    check(bool(np.isfinite(oq).all() and np.isfinite(ot).all()),
          "Ouster: non-finite pose")
    check(oate < 0.1, f"Ouster ATE over {N_ATE} frames {oate:.4f} m >= 0.1")
    check(o_gap[0] < 0.01 and o_gap[1] < 1e-3,
          f"Ouster card vs CPU path: {o_gap}")
    check(o_same_edges, "Ouster: card and CPU path picked different edge "
          "counts")
    check(not osyncs, f"{len(osyncs)} host synchronisations in the Ouster "
          f"path: {osyncs[:1]}")
    raw_path["ouster"] = {
        "rings": OUSTER_CFG.scan_lines, "organised_cols": OUSTER_COLS,
        "ring_width": OUSTER_CFG.ring_width,
        "window_frames": OUSTER_CFG.local_map_size, "launches": ocounts,
        f"ate_m_first_{N_ATE}": oate,
        "ate_m_all": float(np.sqrt(np.mean(oerr ** 2))),
        "err_m_per_frame": oerr.tolist(),
        "n_edges_min": int(one.min()), "n_edges_max": int(one.max()),
        f"cpu_parity_max_dt_m_drot_rad_first_{N_CPU_FRAMES}": o_gap,
        "cpu_parity_same_n_edges": o_same_edges, "host_syncs": len(osyncs)}
    emit({"phase": "raw_path", "frames": N_FRAMES, "noise_m": 0.0,
          **raw_path, "seconds": time.perf_counter() - t0})

    # ---- 7. the voxel-filtered matching map -------------------------------
    t0 = time.perf_counter()
    vcfg = cfg.replace(filter_local_map=True)
    torch.cuda.synchronize()
    reset_counters()
    (_, vposes, vedges), vsyncs = sync_free(
        lambda: run_course(P.init_state(vcfg), imgs, vcfg, keep=False))
    vcounts = read_counters()
    vt, vq, verr, vate = drive_error(vposes, gt_pos)
    vne = torch.stack(vedges).cpu().numpy()
    _, vcposes, vcedges = run_course(P.init_state(vcfg, device="cpu"),
                                     cpu_imgs, vcfg)
    v_gap = pose_gap(torch.stack([p.t for p in vcposes]).numpy(),
                     torch.stack([p.q for p in vcposes]).numpy(),
                     vt[:N_CPU_FRAMES], vq[:N_CPU_FRAMES])
    v_same_edges = [int(c) for c in vcedges] == vne[:N_CPU_FRAMES].tolist()
    want = launches(smoothness=N_FRAMES, select_edges=N_FRAMES,
                    knn_coords=2 * N_FRAMES)
    check(vcounts == want, f"filtered launch counts {vcounts} != {want}")
    check(bool(np.isfinite(vq).all() and np.isfinite(vt).all()),
          "filtered: non-finite pose")
    check(vate < 0.1, f"filtered ATE over {N_ATE} frames {vate:.4f} m")
    check(v_gap[0] < 0.01 and v_gap[1] < 1e-3,
          f"filtered card vs CPU path: {v_gap}")
    check(v_same_edges, "filtered: card and CPU path picked different edge "
          "counts")
    check(not vsyncs, f"{len(vsyncs)} host synchronisations in the filtered "
          f"path: {vsyncs[:1]}")
    emit({"phase": "filtered_path", "frames": N_FRAMES, "noise_m": 0.0,
          "leaf_m": vcfg.local_map_voxel, "launches": vcounts,
          f"ate_m_first_{N_ATE}": vate,
          "ate_m_all": float(np.sqrt(np.mean(verr ** 2))),
          "err_m_per_frame": verr.tolist(),
          f"cpu_parity_max_dt_m_drot_rad_first_{N_CPU_FRAMES}": v_gap,
          "cpu_parity_same_n_edges": v_same_edges,
          "n_edges_min": int(vne.min()), "host_syncs": len(vsyncs),
          "seconds": time.perf_counter() - t0})

    # ---- 8. batch_image_step over distinct drives -------------------------
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

    # ---- 9. chained_image_step, with and without the IMU ------------------
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

    # ---- 10. the lines-kNN configuration (K6) ------------------------------
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

    # ---- 11. the parallel layer on a one-rank NCCL mesh ---------------------
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

    # ---- 12. the flagship's CPU route, a one-rank gloo group -------------
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

    # ---- 13. the apps, as a user runs them (before the profiler runs) -----
    with tempfile.TemporaryDirectory() as tmp:
        apps_phase(Path(tmp), spins, gt_pos, gt_yaw, dev, smi, check)

    # ---- 14. the bench drive: steady-state time a frame -------------------
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
        "full_step": (
            lambda st, raws_, _first: run_full(st, raws_, cfg, keep=False),
            lambda: P.init_state(cfg), bench[0][3]),
        "filtered": (
            lambda st, ims, _first: run_course(st, ims, vcfg, keep=False),
            lambda: P.init_state(vcfg), bimgs),
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
    raw_timing = {name: {"ms_per_frame": mean[name][0],
                         "host_ms_per_frame": mean[name][1],
                         "scans_per_s": 1e3 / mean[name][0],
                         "minus_image_step_ms":
                             mean[name][0] - mean["image_step"][0]}
                  for name in ("full_step", "filtered")}
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
          "full_step": raw_timing["full_step"],
          "filtered_image_step": raw_timing["filtered"],
          "runs_ms_and_host_ms_in_turns": runs})
    # ---- 15. the steps captured as CUDA graphs before frame 0 -------------
    aot_phase(cfg, ccfg, imgs, main_drive, (cposes_k, cedges_k), sposes,
              gt_pos, bimgs, bench_b, mesh, sstep, smi, check)

    # ---- 16. the per-stage timer, eager and as CUDA graphs ----------------
    stages_phase(smi, check)

    # ---- 17. the deploy-time warm cache, cold then warm -----------------
    warm_cache_phase(smi, check)

    # ---- 18. the port of bench.py, eager and as CUDA graphs -------------
    bench_phase(smi, check)

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

    # ---- 19. each kernel against its plain version, bench shapes ---------
    t_kernels = time.perf_counter()
    img = bimgs[N_FRAMES - 1]
    sm_k = SM.smoothness_cuda(img.xyz, img.count)
    sm_p = SM.smoothness_plain(img.xyz, img.count)
    k1_err = float((sm_k - sm_p).abs().max())
    check(torch.equal(sm_k, sm_p), f"K1 not bit-exact (max err {k1_err})")
    # K1 at every shape the port launches it with, timed beside both bounds
    o_img = F.split_scan_ouster(torch.from_numpy(organized_from_unorganized(
        bench[0][4][-1], OUSTER_CFG.scan_lines, OUSTER_COLS)).to(dev),
        OUSTER_CFG)
    k1_cases = smoothness_cases(img, bench_b[LANES][N_FRAMES - 1],
                                bench_b[max(TIMED_BATCHES)][N_FRAMES - 1],
                                o_img, dev)
    k1 = {}
    for name, (x, c) in k1_cases.items():
        got, want = SM.smoothness_cuda(x, c), SM.smoothness_plain(x, c)
        whole, needed = smoothness_bounds(x, c)
        k1[name] = {"rings": x.shape[0], "width": x.shape[1],
                    "bit_exact": torch.equal(got, want),
                    "max_abs_err": float((got - want).abs().max()),
                    "ms": cuda_ms(lambda: SM.smoothness_cuda(x, c), 100),
                    "bound_ms": needed[0], "whole_image_bound_ms": whole[0],
                    "points": int(torch.clamp(c, max=x.shape[1]).sum())}
        check(k1[name]["bit_exact"], f"K1 not bit-exact ({name})")
    k1_err = max(v["max_abs_err"] for v in k1.values())
    # the voxel filter's device time on a full window: the bench's 5 frames
    # and the presets' 15 (three bench windows end to end)
    wins = [local_map.flatten(bstates[-2 - 5 * j].window) for j in range(3)]
    vox = {}
    for n_frames, (wx, wv) in ((5, wins[0]),
                               (15, (torch.cat([w[0] for w in wins]),
                                     torch.cat([w[1] for w in wins])))):
        vox[f"window_{n_frames}"] = {
            "rows": wx.shape[0], "valid": int(wv.sum()),
            "leaves": int(V.voxel_downsample(wx, wv, 0.4)[1].sum()),
            "ms": cuda_ms(lambda: V.voxel_downsample(wx, wv, 0.4), 50)}

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
    # the last pose, and the probe kernel on the table the last frame met
    # with that frame's codes at its pose (its table must also be the one
    # the drive produced), each with the cases of map_kernel_cases
    kmap = bc_states[-1][1]
    kbase = G.cell_keys(torch.trunc(bc_poses[-1].t), MCFG)
    koffs = G.local_map_offsets(MCFG)
    cap = MCFG.local_map_capacity
    pmap = bc_states[-2][1]
    pvalid = ec_k.valid
    pxyz = se3.transform(bc_poses[-1], ec_k.xyz)
    pcode = G._packed_codes(pxyz, pvalid, MCFG)
    k7_cases, probe_cases = map_kernel_cases(kmap, kbase, pmap, pcode,
                                             pvalid, pxyz)
    k7 = {}
    for name, args in k7_cases.items():
        got = K7.compact_hits_cuda(*args)
        want = K7.compact_hits_plain(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        k7[name] = {"rows": args[0].shape[0], "targets": len(args[4]),
                    "capacity": args[5], "n_hits": int(got[2]),
                    "bit_exact": same,
                    "max_abs_err": float((got[0] - want[0]).abs().max())
                    if args[5] else 0.0}
        check(same, f"K7 not bit-exact ({name})")
    k7_hits = k7["bench"]["n_hits"]
    for name in ("bench_cap1024", "targets174_cap1024"):
        check(k7[name]["n_hits"] > 1024,
              f"K7: capacity 1024 did not truncate ({name})")
    check(k7["no_hits"]["n_hits"] == 0, "K7: the far base has hits")
    check(k7["targets174"]["targets"] == 174, "K7: not 174 targets")
    k7_shape = K7.compact_shape(kmap.xyz.shape[0], len(koffs))

    probe = {}
    for name, args in probe_cases.items():
        got = PI.probe_insert_cuda(*args, with_rounds=True)
        want = PI.probe_insert_plain(*args, with_rounds=True)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        probe[name] = {"rows": args[1].shape[0],
                       "active": int(args[2].sum()),
                       "table_slots": args[0].shape[0],
                       "rounds": int(got[4]), "plain_rounds": int(want[4]),
                       "claimed": int(got[2].sum()),
                       "failed": int(got[3].sum()), "bit_exact": same}
        check(same, f"probe kernel ({name}): table, slots, flags or rounds "
              f"differ from the plain rounds")
    probe_drive = torch.equal(PI.probe_insert_cuda(*probe_cases["bench"])[0],
                              kmap.code)
    check(probe_drive, "probe kernel: table differs from the drive's map")
    check(probe["inactive"]["rounds"] == 0, "probe kernel: rounds without "
          "an active row")
    check(probe["table256"]["rounds"] == PI.MAX_PROBES
          and probe["table256"]["failed"] > 0,
          "probe kernel: the 256-slot table was not exhausted")
    probe_same = all(v["bit_exact"] for v in probe.values())

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
            "walk": ("register" if kk <= KNN.MAX_K else
                     "lists in shared memory"
                     if KNN.knn_any_k_shape("knn_coords", prep[2].shape[-1],
                                            kk)["lists_in_smem"] else
                     "lists in device memory"),
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
    check(other_k[512]["walk"] == "lists in device memory",
          "k=512: ListWalk's lists did not go to device memory")

    # ListWalk's own entry points where the register walk also runs, bit
    # for bit
    t_lifted = time.perf_counter()
    any_k_entry = {}
    for kk in (1, 5, 16):
        got = (KNN.knn_launch_any_k(*prep, k=kk),
               KNN.knn_launch_batched_any_k(*prep_b, k=kk),
               KNN.knn_index_launch_any_k(*prep5, m5, k=kk))
        want = (KNN.knn_launch_plain(*prep, k=kk),
                KNN.knn_launch_plain(*prep_b, k=kk),
                KNN.knn_index_launch_plain(*prep5, m5, k=kk))
        same = all(torch.equal(a, b) for g, w_ in zip(got, want)
                   for a, b in zip(g, w_))
        if kk >= 2:
            g6 = KNN.knn_lines_launch_any_k(*prep_l, *gates, k=kk)
            w6 = KNN.knn_lines_launch_plain(*prep_l, *gates, k=kk)
            same &= torch.equal(g6[0], w6[0]) and torch.equal(g6[1], w6[1])
        name = f"k{kk}"
        any_k_entry[name] = same
        check(same, f"ListWalk's entry points ({name}) differ from the "
              f"plain versions")
    # the shared-memory boundary at 128 ref tiles of the tie lattice: the
    # last k whose block's lists fit beside the staging buffers, the filled
    # counts and the ranked flags, and the first in device memory; each
    # launch takes ListWalk, bit for bit
    for kern in ("knn_coords", "knn_index", "knn_lines"):
        st = usage_of(usage.get(kern), f"{kern}_any_k_kernel").get(
            "static_smem_bytes")
        check(st == 0, f"{kern}'s ListWalk kernel has {st} bytes of static "
              "shared memory beside the dynamic size it is sized to")
    lat = [tie_scene(s_, 1000, LIST_EDGE_TILES * KNN.TILE_M)
           for s_ in range(2)]
    prep_e = KNN.knn_prepare_batched(*(
        torch.from_numpy(np.stack([ln[i] for ln in lat])).to(dev)
        for i in range(4)), 1.0)
    check(prep_e[2].shape[-1] == LIST_EDGE_TILES,
          f"the boundary lattice has {prep_e[2].shape[-1]} ref tiles")
    m_e = LIST_EDGE_TILES * KNN.TILE_M
    edge = KNN.knn_any_k_list_edge("knn_coords", LIST_EDGE_TILES)
    for kk in (edge, edge + 1):
        shape_e = KNN.knn_any_k_shape("knn_coords", LIST_EDGE_TILES, kk)
        before = (KNN.knn_launch_batched_any_k.launches,
                  KNN.knn_index_launch_any_k.launches,
                  KNN.knn_lines_launch_any_k.launches)
        got = (KNN.knn_launch_batched(*prep_e, k=kk),
               KNN.knn_index_launch(*prep_e, m_e, k=kk),
               KNN.knn_lines_launch(*prep_e, *gates, k=kk)[:2])
        took = tuple(a - b for a, b in zip(
            (KNN.knn_launch_batched_any_k.launches,
             KNN.knn_index_launch_any_k.launches,
             KNN.knn_lines_launch_any_k.launches), before))
        want = (KNN.knn_launch_plain(*prep_e, k=kk),
                KNN.knn_index_launch_plain(*prep_e, m_e, k=kk),
                KNN.knn_lines_launch_plain(*prep_e, *gates, k=kk)[:2])
        same = all(torch.equal(a, b) for g, w_ in zip(got, want)
                   for a, b in zip(g, w_))
        name = f"k{kk}_at_{LIST_EDGE_TILES}_ref_tiles"
        any_k_entry[name] = {"equal": same, "any_k_launches": took,
                             **shape_e}
        check(same and took == (1, 1, 1)
              and shape_e["lists_in_smem"] == (kk == edge)
              and shape_e["dynamic_smem_bytes"] <= 232448,
              f"ListWalk at {name}: {any_k_entry[name]}")
    any_k = any_k_drives(cfg, ccfg, bimgs, bench_b[LANES], gt_pos, mesh,
                         check)
    select_wide, wide_counts = select_wide_phase(
        cfg, img, sm_k, raws, main_drive[0], dev, check)
    compact_wide, k7w_counts = compact_wide_phase(kmap, kbase, imgs, ccfg,
                                                  check)
    emit({"phase": "lifted_limits", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_lifted,
          "any_k_entry_points_equal": any_k_entry, "knn_k_20": any_k,
          "select_edges_global": select_wide,
          "local_map_compact_global": compact_wide})

    flags = prep[2]
    n_e, n_m = flags.shape
    flagged = int(flags.sum())
    flagged_b = int(prep_b[2].sum())
    flagged5 = int(prep5[2].sum())
    sparse_epilogue = sparse_epilogue_phase(imgs, cposes_k, cfg, check)
    lm_solve_phase(cfg, imgs, dev, smi, usage, check)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_kernels,
          "sparse_epilogue": sparse_epilogue,
          "smoothness": {"bit_exact": all(v["bit_exact"]
                                          for v in k1.values()),
                         "max_abs_err": k1_err, "shapes": k1,
                         **SM.smoothness_shape()},
          "voxel_filter": vox,
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
                                "targets": len(koffs), **k7_shape,
                                "checks": k7},
          "knn_index": {"queries": int(ec_k.valid.sum()),
                        "refs": int(s_valid.sum()), "E": s_query.shape[0],
                        "M": m5, "tile_pairs": prep5[2].numel(),
                        "flagged_pairs": flagged5,
                        "rows_equal_to_keyed_selection": k5_rows,
                        "kernels_a_call": k5_kernels, **k5},
          "knn_other_k": other_k,
          "probe_insert": {"bit_exact": probe_same,
                           "table_equals_drive": probe_drive,
                           "occupied_before": int(pmap.valid.sum()),
                           **PI.probe_shape(), "checks": probe}})

    r, w = img.xyz.shape[:2]
    k1_ms = k1["bench_64x4096"]["ms"]
    k1_plain = cuda_ms(lambda: SM.smoothness_plain(img.xyz, img.count), 20)
    # the bound counts what this frame's output needs: the columns below
    # each ring's count (the whole image's beside it)
    k1_whole, k1_bound = smoothness_bounds(img.xyz, img.count)

    k2_ms = cuda_ms(lambda: SEL.select_edges_cuda(img, sm_k, cfg), 50)
    k2_plain = cuda_ms(lambda: SEL.select_edges_plain(img, sm_k, cfg), 3, 1)
    k2_bound = select_bound(img, sm_k, cfg, ec_k.valid)
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

    pargs = probe_cases["bench"]
    probe_ms = cuda_ms(lambda: PI.probe_insert_cuda(*pargs), 100)
    clone_ms = cuda_ms(lambda: pmap.code.clone(), 100)
    probe_plain = cuda_ms(lambda: PI.probe_insert_plain(*pargs), 5, 1)
    n_tab, e_p = pmap.code.shape[0], pcode.shape[0]
    # the function returns a new table: it reads and writes the table once
    # (the copy), reads the codes and the mask, writes slots and two flags;
    # the rounds are bound by latency: the first reads, then two dependent
    # L2 trips a round (the claims, the reads)
    probe_bound = bound(2 * n_tab * 8 + e_p * (8 + 1) + e_p * (4 + 1 + 1), 0)
    copy_bound = bound(2 * n_tab * 8, 0)[0]
    rounds = probe["bench"]["rounds"]
    rounds_bound_ms = (2 * rounds + 1) * L2_TRIP_S * 1e3

    # ListWalk at k = 17 (ANY_K's neighbour below it) beside the plain
    # versions, with its bound at that k: the register rows' bytes and
    # flagged pairs, the outputs k wide; K3 also at 32, 64 and 512
    kw = OTHER_K[OTHER_K.index(KNN.MAX_K) + 1]

    def err(got, want):
        return float((got - want).abs().max())

    a3 = (lambda: KNN.knn_launch_any_k(*prep, k=kw))
    a3_err = err(a3()[0], KNN.knn_launch_plain(*prep, k=kw)[0])
    a3_ms = cuda_ms(a3, 20)
    a3_ms_at = {kk: cuda_ms(lambda: KNN.knn_launch_any_k(*prep, k=kk),
                            2 if kk > 100 else 10)
                for kk in OTHER_K if kk > kw}
    a3_ms_at.update({kk: cuda_ms(lambda: KNN.knn_launch_any_k(*prep, k=kk),
                                 20) for kk in (5, 16)})
    a3_plain = cuda_ms(lambda: KNN.knn_coords_plain(
        query, qvalid, map_xyz, map_valid, kw), 3, 1)
    # the bound at each k: the larger of the flagged pairs' operations and
    # the bytes, the k outputs a query (16 bytes each) among them
    def a3_bound_at(kk):
        return bound(q4.numel() * 4 + r4.numel() * 4 + flags.numel() * 4
                     + e_q * 4 + e_q * kk * 4 * 4,
                     flagged * KNN.TILE_E * KNN.TILE_M * 8)

    a3_bound = a3_bound_at(kw)
    a4 = (lambda: KNN.knn_launch_batched_any_k(*prep_b, k=kw))
    a4_err = err(a4()[0], KNN.knn_launch_plain(*prep_b, k=kw)[0])
    a4_ms = cuda_ms(a4, 20)
    a4_plain = cuda_ms(lambda: KNN.knn_coords_batched_plain(
        query_b, qvalid_b, map_b, mvalid_b, kw), 3, 1)
    a4_bound = bound(prep_b[0].numel() * 4 + prep_b[1].numel() * 4
                     + prep_b[2].numel() * 4 + e_b * 4 + e_b * kw * 4 * 4,
                     flagged_b * KNN.TILE_E * KNN.TILE_M * 8)
    a5 = (lambda: KNN.knn_index_launch_any_k(*prep5, m5, k=kw))
    a5_err = err(a5()[0], KNN.knn_index_launch_plain(*prep5, m5, k=kw)[0])
    a5_ms = cuda_ms(a5, 20)
    a5_plain = cuda_ms(lambda: KNN.knn_index_plain(
        s_query, ec_k.valid, s_map, s_valid, kw), 3, 1)
    a5_bound = bound(sum(t.numel() * 4 for t in prep5) + e5 * kw * 8,
                     int(ec_k.valid.sum()) * int(s_valid.sum()) * 8)
    a6 = (lambda: KNN.knn_lines_launch_any_k(*prep_l, *gates, k=kw))
    a6_got, a6_want = a6(), KNN.knn_lines_launch_plain(*prep_l, *gates, k=kw)
    a6_err = max(err(a6_got[0], a6_want[0]), err(a6_got[1], a6_want[1]))
    a6_ms = cuda_ms(a6, 20)
    a6_plain = cuda_ms(lambda: KNN.knn_lines_plain(
        query, qvalid, map_xyz, map_valid, kw, *gates), 3, 1)
    a6_bound = bound(q4.numel() * 4 + r4.numel() * 4 + flags.numel() * 4
                     + e_q * 4 + e_q * (2 * 12 + 1),
                     flagged * KNN.TILE_E * KNN.TILE_M * 8
                     + e_q * K6_OPS_PER_QUERY)
    any_k_launches = {name: any_k[drive]["launches"][name] for drive, name in
                      (("image_step", "knn_coords_any_k"),
                       ("batch", "knn_coords_batched_any_k"),
                       ("sharded", "knn_index_any_k"),
                       ("lines", "knn_lines_any_k"))}
    wide_rings = {k_: v for k_, v in select_wide.items()
                  if k_.startswith("rings64x") and "bound_ms" in v}
    k2w_main = wide_rings[f"rings64x{WIDE_RINGS[0][0]}_slots"
                          f"{cfg.scan_regions * (WIDE_RINGS[0][1] + 1)}"]

    rows = [
        {"name": "smoothness", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/smoothness.cu",
         "replaces": "liodom_tpu/ops/smoothness_pallas.py:22",
         "launches": counts["smoothness"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "whole_image_bound_ms": k1_whole[0],
         "ms_512x4096": k1["folded_512x4096"]["ms"],
         "bound_ms_512x4096": k1["folded_512x4096"]["bound_ms"],
         "whole_image_bound_ms_512x4096":
             k1["folded_512x4096"]["whole_image_bound_ms"],
         **SM.smoothness_shape(), "ptxas": usage.get("smoothness")},
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
         "bound_by": k7_bound[1], "library_ms": None, "n_hits": k7_hits,
         "latency_bound_ms": 4 * L2_TRIP_S * 1e3,
         "tiles": k7_shape["tiles"],
         "ptxas": usage.get("local_map_compact")},
        {"name": "probe_insert", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/probe_insert.cu",
         "replaces": "none: liodom_tpu/mapping/grid.py:200 is a "
                     "lax.while_loop, no TPU kernel",
         "launches": ccounts["probe_insert"],
         "max_abs_err": 0.0 if probe_same else float("nan"),
         "ms": probe_ms, "plain_ms": probe_plain,
         "bound_ms": probe_bound[0], "bound_by": probe_bound[1],
         "library_ms": None, "table_copy_ms": clone_ms,
         "kernel_ms": probe_ms - clone_ms, "copy_bound_ms": copy_bound,
         "rounds": rounds, "rounds_latency_bound_ms": rounds_bound_ms,
         "ptxas": usage.get("probe_insert")},
        {"name": "knn_coords_any_k", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_coords.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:259",
         "launches": any_k_launches["knn_coords_any_k"],
         "max_abs_err": a3_err, "ms": a3_ms, "plain_ms": a3_plain,
         "bound_ms": a3_bound[0], "bound_by": a3_bound[1],
         "library_ms": None, "k": kw,
         "ms_at_k": {str(kk): v for kk, v in sorted(a3_ms_at.items())},
         "bound_ms_at_k": {str(kk): list(a3_bound_at(kk))
                           for kk in sorted(a3_ms_at)},
         "shape": KNN.knn_any_k_shape("knn_coords", n_m, kw),
         "shape_k512": KNN.knn_any_k_shape("knn_coords", n_m, 512),
         "ptxas": usage_of(usage.get("knn_coords"),
                           "knn_coords_any_k_kernel")},
        {"name": "knn_coords_batched_any_k", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_coords.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:526",
         "launches": any_k_launches["knn_coords_batched_any_k"],
         "max_abs_err": a4_err, "ms": a4_ms, "plain_ms": a4_plain,
         "bound_ms": a4_bound[0], "bound_by": a4_bound[1],
         "library_ms": None, "k": kw, "batch": LANES,
         "shape": KNN.knn_any_k_shape("knn_coords", prep_b[2].shape[-1],
                                      kw),
         "ptxas": usage_of(usage.get("knn_coords"),
                           "knn_coords_any_k_kernel")},
        {"name": "knn_index_any_k", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_index.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:44",
         "launches": any_k_launches["knn_index_any_k"],
         "max_abs_err": a5_err, "ms": a5_ms, "plain_ms": a5_plain,
         "bound_ms": a5_bound[0], "bound_by": a5_bound[1],
         "library_ms": None, "k": kw,
         "shape": KNN.knn_any_k_shape("knn_index", prep5[2].shape[-1], kw),
         "ptxas": usage_of(usage.get("knn_index"),
                           "knn_index_any_k_kernel")},
        {"name": "knn_lines_any_k", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/knn_lines.cu",
         "replaces": "liodom_tpu/ops/knn_pallas.py:580",
         "launches": any_k_launches["knn_lines_any_k"],
         "max_abs_err": a6_err, "ms": a6_ms, "plain_ms": a6_plain,
         "bound_ms": a6_bound[0], "bound_by": a6_bound[1],
         "library_ms": None, "k": kw,
         "shape": KNN.knn_any_k_shape("knn_lines", n_m, kw),
         "ptxas": usage_of(usage.get("knn_lines"),
                           "knn_lines_any_k_kernel")},
        {"name": "local_map_compact_global", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/local_map_compact.cu",
         "replaces": "scripts/compact_pallas_experiment.py:50",
         "launches": k7w_counts["local_map_compact_global"],
         "max_abs_err": 0.0 if compact_wide[f"cap{cap}"]["bit_exact"]
         else float("nan"),
         "ms": compact_wide["ms"], "plain_ms": compact_wide["plain_ms"],
         "bound_ms": compact_wide["bound_ms"],
         "bound_by": compact_wide["bound_by"], "library_ms": None,
         "targets": compact_wide["targets"],
         "n_hits": compact_wide[f"cap{cap}"]["n_hits"],
         "earlier_ms": compact_wide["earlier_ms"],
         "share_of_bound": compact_wide["share_of_bound"],
         "fence": compact_wide["fence"],
         "ptxas": usage_of(usage.get("local_map_compact"),
                           "compact_kernelILb0E")},
        {"name": "select_edges_global", "route": "cuda",
         "source": "liodom_tpu_torch/csrc/select.cu",
         "replaces": "liodom_tpu/ops/select_pallas.py:70",
         "launches": wide_counts["select_edges_global"],
         "max_abs_err": 0.0 if k2w_main["bit_exact"] else float("nan"),
         "ms": k2w_main["ms"], "plain_ms": k2w_main["plain_ms"],
         "bound_ms": k2w_main["bound_ms"], "bound_by": k2w_main["bound_by"],
         "library_ms": None, "earlier_ms": k2w_main["earlier_ms"],
         "share_of_bound": k2w_main["share_of_bound"],
         "layout": {k_: k2w_main[k_] for k_ in (
             "lists_in_scratch", "keys_in_smem", "dynamic_smem_bytes",
             "scratch_bytes_per_ring", "radix_bits")},
         "rings": wide_rings,
         "bench_ms": select_wide["bench_ms"],
         "bench_smem_path_ms": select_wide["bench_smem_path_ms"],
         "ptxas": usage_of(usage.get("select"), "select_global_kernel")},
    ]

    # ---- 20. where a frame's device time goes ----------------------------
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
