"""Per-stage time of the odometry / mapping frame (port of ``bench_stages.py``).

    python -m liodom_tpu_torch.tools.bench_stages [--device cpu] [--out FILE]

The inputs and stages are the JAX tool's (``bench_stages.py:46-276``):
``LiodomConfig(local_map_size=5)`` and the default ``MapConfig()`` on a
12-frame ``BoxWorld(seed=0)`` drive (1.2 m and 0.01 rad a frame, 1,800
columns, 1 cm noise), each scan split by ``runtime/native.split_velodyne``.
The pipeline runs 11 frames; the last frame, its smoothness and edges, the
compacted edges, the flattened window, the predicted pose, ``edges_world``
and the correspondences are kept, and the combined state after 11 frames.
Each stage is then timed alone on them: ``_dispatch_floor`` (``x + 1`` on
an (8, 128) tensor), ``smoothness`` (K1), ``select_edges`` (K2),
``knn_line_fit`` (``ops/neighbors.line_correspondences``), ``lm_solve``,
``window_push``, ``map_update`` (``grid.update_map``) and ``map_local``
(``grid.get_local_map``, K7); then the fused ``image_step`` and
``combined_image_step`` over 30 state-chained frames after 3.

Where JAX has one jit the port launches several, so two rows have sub-rows
of their own: ``knn_line_fit`` = ``knn_prepare`` (``knn_pallas.knn_prepare``:
the query sort, tile boxes and pair flags) + ``knn_launch`` (K3) +
``line_fit`` (``neighbors._line_fit``), and ``map_update`` = ``probe``
(``grid.insert_frame``: the transform, the codes and the probe kernel) +
``sums`` (``grid._fold``: the frame-sized fold, one launch of
``csrc/map_fold.cu``).

Two columns a row:

* ``eager_ms`` -- JAX's method as written (``bench_stages.py:33-45``): N
  calls queued back to back, closed by one small fetch, on the host clock.
  Eager dispatch is host-bound on the card, so this is the host plus the
  device.
* ``graph_ms`` -- the stage captured alone as a ``torch.cuda.CUDAGraph`` on
  static inputs (clones of the kept intermediates), N bare replays between
  two CUDA events, queued behind a device-side sleep so that the events
  time the device and not the host's replay rate: the device's time.  The
  input copies and output clones that ``runtime/aot``'s replay adds a call
  are timed on their own (``copy_ms``); the fused rows' ``graph_ms`` is the
  bare replay of the captured step on the 11-frame state, and
  ``chained_graph_ms`` the step through ``aot.get_or_compile`` over the 30
  state-chained frames, copies included.

``glue`` sets the stage graphs' sum against the fused graph: the
difference is compaction, transforms, prediction, the map's sort and the
second association round (``round_sum_ms`` counts ``knn_line_fit`` and
``lm_solve`` once a round).  Roofline anchors are the card's: 3.35 TB/s
HBM and 67 TFLOP/s FP32 outside the tensor cores (NVIDIA's H100 SXM data
sheet), beside the card's name and power limit from ``nvidia-smi``.

Output: a table on stderr and one JSON line on stdout with the JAX tool's
keys (``stage_ms``, ``odom_ms``, ``combined_ms``, ``roofline``, ``note``;
each row ``{eager_ms, graph_ms}``); ``--out FILE`` writes the line there
too.  No other file is written.  On the card by default, raising without
one; with ``--device cpu`` the plain versions are timed, ``graph_ms`` and
the achieved rates are null.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import EdgeCloud, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping.service import combined_image_step, init_combined
from liodom_tpu_torch.odometry import local_map as LM
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import knn_pallas as KNN
from liodom_tpu_torch.ops import neighbors as NB
from liodom_tpu_torch.ops.solver import lm_solve
from liodom_tpu_torch.runtime import aot, native

FRAMES = 12            # the drive (bench_stages.py:69)
WIDTH = 1800           # columns of a spin
RING_WIDTH = None      # the config's (4,096) unless set
SPEED, YAW_RATE, NOISE = 1.2, 0.01, 0.01
REPS = 30              # timed calls a row (bench_stages.py:33, 150)
WARM = 3               # unmeasured calls first (bench_stages.py:33, 146)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores
STAGES = ("smoothness", "select_edges", "knn_line_fit", "lm_solve",
          "window_push", "map_update", "map_local")
SUB_ROWS = {"knn_line_fit": ("knn_prepare", "knn_launch", "line_fit"),
            "map_update": ("probe", "sums")}
ODOM_STAGES = STAGES[:5]
ROUND_STAGES = ("knn_line_fit", "lm_solve")   # once a round of the solve


def configs(ring_width: Optional[int] = None
            ) -> Tuple[LiodomConfig, MapConfig, LiodomConfig]:
    """(odometry config, map config, combined config) of the JAX tool
    (``bench_stages.py:64-66``), at ``ring_width`` if given."""
    cfg = LiodomConfig(local_map_size=5)
    if ring_width is not None:
        cfg = cfg.replace(ring_width=ring_width)
    return cfg, MapConfig(), cfg.replace(mapping=True)


def drive_scans(cfg: LiodomConfig, frames: int = FRAMES, width: int = WIDTH
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The drive's ring images and counts on the host
    (``bench_stages.py:67-78``): ``BoxWorld(seed=0)`` spins at 1 cm noise
    (noise seed = frame), split by the native loader."""
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(frames, speed=SPEED, yaw_rate=YAW_RATE)
    out = []
    for i in range(frames):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=width,
                            noise=NOISE, seed=i)
        img, counts, _ = native.split_velodyne(
            scan.astype(np.float32), cfg.scan_lines, cfg.ring_width,
            cfg.min_range, cfg.max_range)
        out.append((img, counts))
    return out


class Intermediates(NamedTuple):
    """What the stages are timed on (``bench_stages.py:80-108``)."""
    img: RingImage               # the last frame
    smooth: torch.Tensor         # its smoothness
    edges: EdgeCloud             # its edges
    edges_c: EdgeCloud           # compacted, padding zeroed
    state: P.OdomState           # after frames - 1 image_steps
    map_xyz: torch.Tensor        # the flattened window
    map_valid: torch.Tensor
    match_xyz: torch.Tensor      # the window as the step matches against it
    match_valid: torch.Tensor    # (spatially sorted on CUDA)
    pred: Pose                   # the constant-velocity prediction
    edges_world: torch.Tensor    # the compacted edges at the prediction
    corr: NB.LineCorrespondences
    comb: Tuple[P.OdomState, G.MapState]   # combined state, frames - 1
    cpose: Pose                  # its last pose


def intermediates(scans, cfg: LiodomConfig, mcfg: MapConfig,
                  dev: torch.device) -> Intermediates:
    """Run the pipeline over all frames but the last and keep what each
    stage takes, as ``bench_stages.py:80-108`` does.  On CUDA the window is
    matched as ``odometry_step`` matches it: spatially sorted once
    (``spatial_sort_points``), the kNN told it is presorted."""
    imgs = [(torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev))
            for x, c in scans]
    state = P.init_state(cfg, device=dev)
    for x, c in imgs[:-1]:
        state, _, _ = P.image_step(state, x, c, cfg)
    img = RingImage(*imgs[-1])
    sm = F.smoothness(img, cfg)
    edges = F.select_edges(img, sm, cfg)
    edges_c = EdgeCloud(*LM.compact(edges.xyz, edges.valid))
    map_xyz, map_valid = LM.flatten(state.window)
    match_xyz, match_valid = map_xyz, map_valid
    if dev.type == "cuda":
        match_xyz, match_valid = KNN.spatial_sort_points(map_xyz, map_valid)
    pred = se3.compose(state.odom,
                       se3.compose(se3.inverse(state.prev_odom), state.odom))
    edges_world = se3.transform(pred, edges_c.xyz)
    corr = _correspondences(cfg, dev)(edges_world, edges_c.valid, match_xyz,
                                      match_valid)
    ccfg = cfg.replace(mapping=True)
    co, cm = init_combined(ccfg, mcfg, device=dev)
    for x, c in imgs[:-1]:
        co, cm, cpose, _ = combined_image_step(co, cm, x, c, ccfg, mcfg)
    return Intermediates(img, sm, edges, edges_c, state, map_xyz, map_valid,
                         match_xyz, match_valid, pred, edges_world, corr,
                         (co, cm), cpose)


def _correspondences(cfg: LiodomConfig, dev: torch.device) -> Callable:
    """``line_correspondences`` as ``odometry_step`` calls it."""
    def fn(ew, ev, mx, mv):
        return NB.line_correspondences(
            ew, ev, mx, mv, k=cfg.knn_k, max_sq_dist=cfg.knn_max_sq_dist,
            eig_ratio=cfg.eig_ratio, min_line_sep=cfg.min_line_sep,
            map_presorted=dev.type == "cuda")
    return fn


def stages(it: Intermediates, cfg: LiodomConfig, mcfg: MapConfig
           ) -> Dict[str, Tuple[Callable, tuple]]:
    """``{row: (fn, args)}``: each stage as the pipeline calls it, on the
    intermediates.  The sub-rows' inputs are their predecessors' outputs,
    computed here once."""
    dev = it.img.xyz.device
    k = cfg.knn_k
    radius = float(cfg.knn_max_sq_dist) ** 0.5
    cuda = dev.type == "cuda"
    launch = ((lambda *prep: KNN.knn_launch("knn_coords", *prep)) if cuda
              else KNN.knn_launch_plain)
    co, cm = it.comb
    ev = it.edges_c.valid
    knn_args = (it.edges_world, ev, it.match_xyz, it.match_valid)
    map_args = (cm, it.edges_c.xyz, ev, it.cpose)

    def knn_prepare(ew, e_valid, mx, mv):          # K3: a batch of one
        return KNN.knn_prepare(ew[None], e_valid[None], mx[None], mv[None],
                               radius, ref_presorted=cuda)

    def knn_launch(q4, r4, flags, qperm):
        return tuple(t[0] for t in launch(q4, r4, flags, qperm, k))

    def line_fit(near, dk, e_valid):
        return NB._line_fit(near, dk, e_valid, cfg.knn_max_sq_dist,
                            cfg.eig_ratio, cfg.min_line_sep)

    prep = knn_prepare(*knn_args)
    d2, near = knn_launch(*prep)
    ins = G.insert_frame(*map_args, mcfg)
    return {
        "_dispatch_floor": (lambda x: x + 1.0,
                            (torch.zeros((8, 128), dtype=torch.float32,
                                         device=dev),)),
        "smoothness": (lambda x, c: F.smoothness(RingImage(x, c), cfg),
                       (it.img.xyz, it.img.count)),
        "select_edges": (lambda x, c, s: F.select_edges(RingImage(x, c), s,
                                                        cfg),
                         (it.img.xyz, it.img.count, it.smooth)),
        "knn_line_fit": (_correspondences(cfg, dev), knn_args),
        "knn_prepare": (knn_prepare, knn_args),
        "knn_launch": (knn_launch, prep),
        "line_fit": (line_fit, (near, d2[..., k - 1], ev)),
        "lm_solve": (lambda p, ex, a, b, v: lm_solve(
            p, ex, a, b, v, min_range=cfg.min_range,
            max_range=cfg.max_range, huber_delta=cfg.huber_delta,
            iters=cfg.inner_iters),
            (it.pred, it.edges_c.xyz, it.corr.lpa, it.corr.lpb,
             it.corr.valid)),
        "window_push": (LM.push, (it.state.window, it.edges_world, ev)),
        "map_update": (lambda m, x, v, p: G.update_map(m, x, v, p, mcfg),
                       map_args),
        "probe": (lambda m, x, v, p: G.insert_frame(m, x, v, p, mcfg),
                  map_args),
        "sums": (lambda m, v, i: G._fold(m, v, i, mcfg), (cm, ev, ins)),
        "map_local": (lambda m, t: G.get_local_map(
            m, t, mcfg, capacity=mcfg.local_map_capacity), (cm, it.cpose.t)),
    }


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _fetch(out) -> None:
    """A small piece of the result to the host (``bench_stages.py:33``)."""
    _tensors(out)[0].reshape(-1)[:1].cpu()


def eager_ms(fn: Callable, args: tuple, reps: int = REPS,
             warm: int = WARM) -> float:
    """Mean ms a call of ``reps`` calls queued back to back after ``warm``,
    closed by one fetch, on the host clock (``bench_stages.py:33-45``)."""
    out = None
    for _ in range(warm):
        out = fn(*args)
    _fetch(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _fetch(out)
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn: Callable[[], object], reps: int = REPS,
              warm: int = WARM) -> float:
    """Mean device ms of ``fn()`` over ``reps`` runs by two CUDA events,
    after ``warm`` unmeasured runs.  The runs are queued behind a
    device-side sleep of twice the time the host takes to enqueue them, so
    the events time the device's work, not the host's launch rate."""
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
    # cycles at 2 GHz, above the H100's 1.98 GHz boost clock
    torch.cuda._sleep(int(2.0 * host_s * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: list                 # the graph's input leaves
    out: object                  # its outputs (the graph's buffers)


def capture(fn: Callable, args: tuple) -> Captured:
    """``fn`` captured alone as a CUDA graph on clones of ``args``
    (``runtime/aot.capture_graph``: warmed on a side stream, then one call
    captured), without ``get_or_compile``'s per-call copies."""
    leaves, spec = tree_flatten(args)
    static = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in leaves]
    dev = _tensors(args)[0].device
    graph, out = aot.capture_graph(
        lambda: fn(*tree_unflatten(static, spec)), dev)
    return Captured(graph, static, out)


def outputs_equal(a, b) -> bool:
    """Every tensor of two results ``torch.equal``."""
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def copy_ms(args: tuple, out, reps: int = REPS) -> float:
    """Device ms of what ``runtime/aot``'s replay adds to a call with these
    inputs and outputs: each input tensor copied into a static buffer, each
    output cloned."""
    src = _tensors(args)
    dst = [x.clone() for x in src]
    outs = _tensors(out)

    def copies():
        for d, s in zip(dst, src):
            d.copy_(s)
        for o in outs:
            o.clone()
    return device_ms(copies, reps)


def time_rows(rows: Dict[str, Tuple[Callable, tuple]], cuda: bool,
              reps: int = REPS) -> Tuple[dict, dict, dict]:
    """({row: {eager_ms, graph_ms}}, {row: copy_ms}, {row: the replayed
    graph's outputs torch.equal to an eager call's}); the graph columns
    None on the CPU."""
    out, copies, equal = {}, {}, {}
    for name, (fn, args) in rows.items():
        row = {"eager_ms": eager_ms(fn, args, reps), "graph_ms": None}
        copies[name] = equal[name] = None
        if cuda:
            cap = capture(fn, args)
            row["graph_ms"] = device_ms(cap.graph.replay, reps)
            cap.graph.replay()
            equal[name] = outputs_equal(cap.out, fn(*args))
            copies[name] = copy_ms(args, cap.out, reps)
            del cap
        out[name] = row
    return out, copies, equal


def fused_rows(scans, cfg: LiodomConfig, mcfg: MapConfig, it: Intermediates,
               dev: torch.device, reps: int = REPS) -> dict:
    """``odom_ms`` and ``combined_ms``: eager over ``reps`` state-chained
    frames after 3 (``bench_stages.py:145-173``); on CUDA also the bare
    replay of the step captured on the kept state and last frame
    (``graph_ms``), its copies (``copy_ms``), and the step through
    ``aot.get_or_compile`` over the same chained frames by CUDA events
    (``chained_graph_ms``), with its poses ``torch.equal`` to eager's."""
    imgs = [(torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev))
            for x, c in scans]
    n = len(imgs)
    order = [3 + r % (n - 3) for r in range(reps)]
    ccfg = cfg.replace(mapping=True)

    def odom(st, x, c):
        st, pose, _ = P.image_step(st, x, c, cfg)
        return st, pose

    def comb(st, x, c):
        o, m, pose, _ = combined_image_step(*st, x, c, ccfg, mcfg)
        return (o, m), pose

    out = {}
    for key, step, init, kept in (
            ("odom_ms", odom, lambda: P.init_state(cfg, device=dev),
             it.state),
            ("combined_ms", comb,
             lambda: init_combined(ccfg, mcfg, device=dev), it.comb)):
        def chained(st, frames):
            poses = []
            for i in frames:
                st, pose = step(st, *imgs[i])
                poses.append(pose)
            return st, poses

        st, poses = chained(init(), range(3))
        _fetch(poses[-1])
        t0 = time.perf_counter()
        _, eager_poses = chained(st, order)
        _fetch(eager_poses[-1])
        row = {"eager_ms": (time.perf_counter() - t0) * 1e3 / reps,
               "graph_ms": None}
        if dev.type == "cuda":
            args = (kept,) + imgs[-1]
            cap = capture(step, args)
            row["graph_ms"] = device_ms(cap.graph.replay, reps)
            cap.graph.replay()
            row["graph_equals_eager"] = outputs_equal(cap.out, step(*args))
            row["copy_ms"] = copy_ms(args, cap.out, reps)
            del cap
            g = aot.get_or_compile(f"bench_stages_{key}", step,
                                   (init(),) + imgs[0],
                                   extra=f"{ccfg}|{mcfg}")
            st, _ = chained(init(), range(3))
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            gposes = []
            for i in order:
                st, pose = g(st, *imgs[i])
                gposes.append(pose)
            stop.record()
            torch.cuda.synchronize()
            row["chained_graph_ms"] = start.elapsed_time(stop) / reps
            row["chained_graph_poses_equal"] = all(
                outputs_equal(a, b) for a, b in zip(gposes, eager_poses))
        out[key] = row
    return out


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def roofline(stage_ms: dict, it: Intermediates, cfg: LiodomConfig,
             card: Optional[str]) -> dict:
    """Work counts and achieved rates against the card's peaks
    (``bench_stages.py:175-249`` with the H100's anchors).  The kNN's
    operations and the LM's are JAX's counts; the kNN's bytes are what the
    port's walk (K3) streams: the prepared queries, refs, flags and
    permutation read once, the distances and coordinates written once.
    The rates use ``graph_ms``; null on the CPU."""
    e = cfg.max_edges
    m = cfg.local_map_size * cfg.max_edges
    radius = float(cfg.knn_max_sq_dist) ** 0.5
    q4, r4, flags, qperm = KNN.knn_prepare(
        it.edges_world[None], it.edges_c.valid[None], it.match_xyz[None],
        it.match_valid[None], radius, ref_presorted=it.match_xyz.is_cuda)
    knn_flops = 8.0 * e * m
    knn_bytes = float(4 * (q4.numel() + r4.numel() + flags.numel()
                           + qperm.numel()) + e * cfg.knn_k * 4 * 4)
    lm_flops = 2.0 * cfg.inner_iters * e * (2 * 36 + 12 + 60)

    def rates(flops, nbytes, ms):
        if ms is None:
            return {"achieved_gflops": None, "fp32_peak_fraction": None,
                    "achieved_hbm_gbps": None, "hbm_peak_fraction": None}
        s = ms / 1e3
        return {"achieved_gflops": flops / s / 1e9,
                "fp32_peak_fraction": flops / s / FP32_OPS_PER_S,
                "achieved_hbm_gbps": nbytes / s / 1e9,
                "hbm_peak_fraction": nbytes / s / HBM_BYTES_PER_S}

    knn = {"flops": knn_flops, "hbm_bytes": knn_bytes,
           **rates(knn_flops, knn_bytes, stage_ms["knn_line_fit"]["graph_ms"]),
           "knn_launch": rates(knn_flops, knn_bytes,
                               stage_ms["knn_launch"]["graph_ms"]),
           "flagged_tile_pairs": int(flags.sum()),
           "tile_pairs": flags.numel(),
           "note": "8 operations a (query, ref) pair over the whole window "
                   "(JAX's count); the walk prunes the tile pairs whose "
                   "boxes lie beyond the gate, so it does a fraction of "
                   "them.  knn_launch is K3 alone, knn_line_fit with the "
                   "prepare and the line fit"}
    lm_ms = stage_ms["lm_solve"]["graph_ms"]
    lm = {"flops": lm_flops,
          "achieved_gflops": None if lm_ms is None
          else lm_flops / (lm_ms / 1e3) / 1e9,
          "note": "a chain of small dependent ops: 4 damped solves of "
                  "6 x 6 systems over E rows; latency, not operations"}
    return {"knn_line_fit": knn, "lm_solve": lm,
            "anchors": {"hbm_bytes_s": HBM_BYTES_PER_S,
                        "fp32_ops_s": FP32_OPS_PER_S,
                        "source": "NVIDIA H100 SXM data sheet: HBM3, FP32 "
                                  "outside the tensor cores",
                        "card": card}}


def glue(stage_ms: dict, fused: dict, cfg: LiodomConfig) -> dict:
    """The stage graphs' sum against each fused graph: once each, and with
    ``knn_line_fit`` and ``lm_solve`` once a round of the solve."""
    out = {}
    for key, names in (("odom_ms", ODOM_STAGES), ("combined_ms", STAGES)):
        g = fused[key]["graph_ms"]
        if g is None:
            out[key] = None
            continue
        once = sum(stage_ms[n]["graph_ms"] for n in names)
        rounds = once + (cfg.outer_iters - 1) * sum(
            stage_ms[n]["graph_ms"] for n in ROUND_STAGES)
        out[key] = {"stage_sum_ms": once, "fused_graph_ms": g,
                    "glue_ms": g - once, "round_sum_ms": rounds,
                    "glue_after_rounds_ms": g - rounds}
    return out


NOTE = ("eager_ms: N calls queued back to back, closed by one fetch, on the "
        "host clock (the JAX tool's method; on the card the host's dispatch "
        "plus the device).  graph_ms: the stage captured alone as a CUDA "
        "graph on static inputs, N bare replays between two CUDA events "
        "behind a device-side sleep (the device's time); copy_ms: what "
        "runtime/aot's replay adds a call (inputs copied, outputs cloned).  "
        "Sub-rows: knn_line_fit = knn_prepare + knn_launch + line_fit, "
        "map_update = probe + sums.  glue: fused graph minus the stage "
        "graphs (compaction, transforms, prediction, the map's sort, the "
        "second round).  The fused graphs are the ground truth.")


def run(device=None, frames: Optional[int] = None, width: Optional[int] = None,
        ring_width: Optional[int] = None, reps: Optional[int] = None) -> dict:
    """The whole measurement on ``device`` (CUDA unless ``"cpu"``); the
    arguments default to the module's constants.  Returns the JSON payload,
    with ``graph_equal`` (each stage graph's outputs ``torch.equal`` to an
    eager call's; null on the CPU) beside the JAX tool's keys."""
    dev = resolve_device(device)
    frames = FRAMES if frames is None else frames
    width = WIDTH if width is None else width
    ring_width = RING_WIDTH if ring_width is None else ring_width
    reps = REPS if reps is None else reps
    cuda = dev.type == "cuda"
    card = nvidia_smi_line() if cuda else None
    cfg, mcfg, _ = configs(ring_width)
    scans = drive_scans(cfg, frames, width)
    it = intermediates(scans, cfg, mcfg, dev)
    rows = stages(it, cfg, mcfg)
    stage_ms, copies, equal = time_rows(rows, cuda, reps)
    fused = fused_rows(scans, cfg, mcfg, it, dev, reps)
    return {"stage_ms": stage_ms,
            "odom_ms": fused["odom_ms"], "combined_ms": fused["combined_ms"],
            "roofline": roofline(stage_ms, it, cfg, card),
            "note": NOTE,
            "sub_rows": {k: list(v) for k, v in SUB_ROWS.items()},
            "copy_ms": copies, "graph_equal": equal,
            "glue": glue(stage_ms, fused, cfg),
            "device": {"type": dev.type, "name": card or "cpu",
                       "torch": torch.__version__},
            "frames": frames, "reps": reps,
            "edges": int(it.edges.valid.sum()),
            "window_points": int(it.map_valid.sum())}


def table(payload: dict) -> str:
    """The human table (stderr)."""
    def f(v):
        return "       -" if v is None else f"{v:8.3f}"
    lines = [f"device: {payload['device']['name']}",
             "stage                  eager_ms graph_ms  copy_ms"]
    subs = {n for v in SUB_ROWS.values() for n in v}
    for name, row in payload["stage_ms"].items():
        label = ("  " if name in subs else "") + name
        lines.append(f"  {label:<21}{f(row['eager_ms'])} "
                     f"{f(row['graph_ms'])} {f(payload['copy_ms'][name])}")
    for key in ("odom_ms", "combined_ms"):
        row = payload[key]
        lines.append(f"  {key + ' (fused)':<21}{f(row['eager_ms'])} "
                     f"{f(row['graph_ms'])} {f(row.get('copy_ms'))}")
        g = payload["glue"][key]
        if g is not None:
            lines.append(f"    stages {g['stage_sum_ms']:.3f} ms, with the "
                         f"second round {g['round_sum_ms']:.3f}; glue "
                         f"{g['glue_ms']:.3f} ({g['glue_after_rounds_ms']:.3f}"
                         f"); chained through aot "
                         f"{row['chained_graph_ms']:.3f} ms a frame")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    payload = run(args.device)
    print(table(payload), file=sys.stderr, flush=True)
    line = json.dumps(payload)
    print(line, flush=True)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
