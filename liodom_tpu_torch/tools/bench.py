"""Throughput of the port's steps, each eager and as a CUDA graph (port of
``bench.py``).

    python -m liodom_tpu_torch.tools.bench [--device cpu]

The inputs are ``bench.py``'s, unchanged: ``LiodomConfig(local_map_size=5)``
(``bench.py:69``), ``MapConfig(local_map_capacity=16384,
map_capacity=524288)`` (``:91``) and its mapping config;
``BoxWorld(seed=0)`` spins 1,800 columns wide at 1 cm noise (noise seed =
frame) along ``drive_trajectory(36, speed=1.2, yaw_rate=0.01)``, 6 warm-up
frames then 30 timed (``:92-95``), each split by
``runtime/native.split_velodyne`` with no point dropped (``:98-109``).  One
JSON line a row as soon as it is measured, with ``bench.py``'s metric
names and keys, in its order:

* ``odometry_scans_per_s_1chip`` (``bench.py:112-135``): ``image_step``,
  printed first as a partial line.
* ``odometry_scans_per_s_chained`` (``:139-185``): ``chained_image_step``
  in chunks of 12, a parity pass, then 3 repetitions over the 36 frames.
* ``odometry_scans_per_s_window15`` (``:187-213``): ``image_step`` at the
  launch file's 15-frame window.
* ``ouster_scans_per_s`` (``:215-249``): ``image_step`` at ``lidar_type=1``
  on the spins reshaped to (64, 1800, 3) organised clouds, split by
  ``native.split_ouster_np`` with no point dropped.
* ``combined_scans_per_s_1chip`` (``:252-317``): ``combined_image_step``
  refreshing the local map every frame (``step=0``, ``local_map_every=4``).
  After the timed loop, untimed: the final map's local map at every pose of
  the run (K7 once a pose) against its capacity, and the map's overflow,
  each a warning line when lossy.  The same at the async cadence
  (``step=i``: a refresh every 4th frame) gives the final line's
  ``combined_async_scans_per_s`` (``:318-321``), with no row of its own.
* ``combined_scans_per_s_chained`` (``:323-388``):
  ``chained_combined_image_step`` by 12 at the async cadence, each
  repetition a fresh ``init_combined`` and the whole course, beside the
  per-frame step under the same protocol (``per_frame_same_protocol``).
* ``batched_odometry_scans_per_s_B4`` and ``_B8`` (``:390-428``):
  ``batch_image_step`` on the bench scans repeated over B lanes
  (materialised once, before the loop), with ``x_over_solo``.
* the final line (``:430-462``): ``bench.py``'s keys, ``eager_<key>``
  beside each rate, ``card`` (the ``nvidia-smi`` name and power limit, or
  ``cpu``) and ``build_s`` (the kernels' build and load before the first
  frame; null on the CPU).

Each row is run twice, ``eager`` first.  ``eager`` calls the step itself;
``graph`` calls it through ``runtime/aot.get_or_compile``, as
``run_kitti --aot`` does: one CUDA graph a refresh pattern (aot bakes the
branch in), captured before the warm-up and never inside a timed loop, its
input copies and output clones paid every call.  ``value``, ``vs_baseline``
and the final line's keys carry the graph's rate, because the JAX bench
times one compiled program a frame and the captured graph is the port's
counterpart; ``eager_value`` (``eager_<key>`` in the final line) carries
the eager rate, so neither hides the other.  Both are timed by
``bench.py``'s method, the rate a user's frame loop sees: warm-up frames
closed by a fetch of the pose to the host, then the timed frames, each fed
the state of the one before, on the host clock, closed by a fetch.

Gates, extending ``bench.py``'s rule that a numerically wrong program
publishes no throughput (``:176-184``): the two chained rows within
``CHAIN_PARITY_TOL_M`` of their per-frame runs, as in ``bench.py`` (each
mode against its own); each graph run against its eager run on the same
scans: final poses ``torch.equal`` for the odometry, chained odometry,
window-15, Ouster and batch rows, within ``COMBINED_PARITY_TOL_M`` for the
combined ones.  A row that fails a gate gets ``"parity_failed": true`` and
a warning on stderr, and its keys stay out of the final line (the async
run, which has no row, gets ``combined_async_parity_failed``).

Budget, as in ``bench.py``: ``LIODOM_BENCH_BUDGET_S`` (520 s unless set)
from the start, the build included; each phase starts only above its
headroom (``HEADROOM_S``), a skipped one leaves a ``<phase>_skipped`` note
in the final line, and the run always ends with the final line.  Nothing
else skips a phase and no exception is caught.  On the card by default,
raising without one; ``--device cpu`` runs the plain versions, where
``get_or_compile`` returns the eager step, so ``graph`` repeats ``eager``.
Stdout carries the JSON lines only; rates are not rounded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.parallel.sharded import init_batch_state
from liodom_tpu_torch.runtime import aot, native
from liodom_tpu_torch.runtime.device_io import path_kernels, prepare_kernels
from liodom_tpu_torch.tools.bench_stages import nvidia_smi_line

BASELINE_SCANS_PER_S = 10.0   # the reference's 10 Hz contract (bench.py:45)
BUDGET_S = 520.0              # bench.py:46, unless LIODOM_BENCH_BUDGET_S
CHAIN_PARITY_TOL_M = 1e-3     # bench.py:50
COMBINED_PARITY_TOL_M = 1e-6  # a combined graph against its eager run
N_WARM, N_BENCH = 6, 30       # bench.py:94
WIDTH = 1800                  # columns of a spin (bench.py:104)
RING_WIDTH = None             # the config's lossless 4,096 unless set
SPEED, YAW_RATE, NOISE = 1.2, 0.01, 0.01
MAP_CAPACITY, LOCAL_MAP_CAPACITY = 524288, 16384   # bench.py:91
CHUNK = 12                    # frames a chained call (bench.py:147)
REPS = 3                      # timed repetitions of a chained course
LOCAL_MAP_EVERY = 4           # the async mapper's cadence (bench.py:265)
BATCHES = (4, 8)              # bench.py:401
# a phase starts only with this much of the budget left (bench.py:149-402)
HEADROOM_S = {"chained": 80.0, "window15": 90.0, "ouster": 120.0,
              "combined": 60.0, "combined_async": 20.0,
              "combined_chained": 70.0, "batched": 90.0}
MODES = ("eager", "graph")
SKIPPED = "wall budget exhausted (slow backend)"   # bench.py:460

Scan = Tuple[torch.Tensor, torch.Tensor]   # a ring image and its counts


def configs(ring_width: Optional[int] = None,
            map_capacity: int = MAP_CAPACITY,
            local_map_capacity: int = LOCAL_MAP_CAPACITY
            ) -> Dict[str, object]:
    """The bench's configurations (``bench.py:69,91-92,193,222``): ``cfg``
    (5-frame window), ``mcfg``, ``ccfg`` (mapping), ``cfg15`` (15-frame
    window) and ``ocfg`` (Ouster), at ``ring_width`` if given."""
    cfg = LiodomConfig(local_map_size=5)
    if ring_width is not None:
        cfg = cfg.replace(ring_width=ring_width)
    return {"cfg": cfg,
            "mcfg": MapConfig(local_map_capacity=local_map_capacity,
                              map_capacity=map_capacity),
            "ccfg": cfg.replace(mapping=True),
            "cfg15": cfg.replace(local_map_size=15),
            "ocfg": cfg.replace(lidar_type=1, laser_frame="")}


def spins(frames: int, width: int = WIDTH) -> List[np.ndarray]:
    """The drive's spins, (64 x width, 3) ring-major (``bench.py:92-104``)."""
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(frames, speed=SPEED, yaw_rate=YAW_RATE)
    return [world.render(pos[i], yaw_matrix(yaws[i]), width=width,
                         noise=NOISE, seed=i) for i in range(frames)]


def velodyne_scans(cfg: LiodomConfig, raw: Sequence[np.ndarray]
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each spin split by the native loader, no point dropped
    (``bench.py:105-109``)."""
    out = []
    for scan in raw:
        img, counts, n_drop = native.split_velodyne(
            scan.astype(np.float32), cfg.scan_lines, cfg.ring_width,
            cfg.min_range, cfg.max_range)
        assert n_drop == 0, (
            f"bench ring_width={cfg.ring_width} dropped {n_drop} points")
        out.append((img, counts))
    return out


def ouster_scans(ocfg: LiodomConfig, raw: Sequence[np.ndarray]
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each spin as the organised cloud an Ouster driver emits (BoxWorld
    renders ring-major, so a reshape), split by ``split_ouster_np``, no
    point dropped (``bench.py:225-231``)."""
    out = []
    for scan in raw:
        org = scan.reshape(ocfg.scan_lines, -1, 3)
        img, counts, n_drop = native.split_ouster_np(
            org, ocfg.ring_width, ocfg.min_range, ocfg.max_range)
        assert n_drop == 0, f"bench Ouster split dropped {n_drop} points"
        out.append((img, counts))
    return out


def to_device(scans, dev: torch.device) -> List[Scan]:
    return [(torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev))
            for x, c in scans]


class Run(NamedTuple):
    rate: float          # scans/s over the timed frames
    state: object        # the state after the last frame
    poses: List[Pose]    # every frame's pose


def _frames(poses: Pose) -> List[Pose]:
    """A chained call's (K, ...) poses as K poses."""
    return [Pose(q, t) for q, t in zip(poses.q, poses.t)]


def _fetch(pose: Pose) -> None:
    """The pose to the host: the barrier that closes a loop
    (``bench.py:122,131``)."""
    pose.t.cpu()


def timed_course(step: Callable, state, n_warm: int, n_total: int) -> Run:
    """``bench.py``'s timing: ``step(state, i) -> (state, pose)`` over
    frames ``0..n_warm-1`` closed by a fetch, then over the rest on the
    host clock, closed by a fetch of the last pose."""
    poses: List[Pose] = []
    for i in range(n_total):
        if i == n_warm:
            _fetch(poses[-1])
            t0 = time.perf_counter()
        state, pose = step(state, i)
        poses.append(pose)
    _fetch(poses[-1])
    return Run((n_total - n_warm) / (time.perf_counter() - t0), state, poses)


def _captured(name: str, fn: Callable, example: tuple, extra: str
              ) -> Callable:
    """``fn`` through ``aot.get_or_compile``: a CUDA graph on the card,
    ``fn`` itself on the CPU.  The kernels' build line goes to stderr, so
    that stdout carries the JSON lines only."""
    with contextlib.redirect_stdout(sys.stderr):
        return aot.get_or_compile(f"bench_{name}", fn, example, extra=extra)


def _gap_m(a: Pose, b: Pose) -> float:
    """Largest translation gap between two (batches of) poses, metres."""
    return float(torch.linalg.vector_norm(a.t - b.t, dim=-1).max())


def _equal(a: Pose, b: Pose) -> bool:
    return torch.equal(a.t, b.t) and torch.equal(a.q, b.q)


def _rate_row(metric: str, runs: Dict[str, float], unit: str = "scans/s",
              **extra) -> dict:
    return {"metric": metric, "value": runs["graph"], "unit": unit,
            "vs_baseline": runs["graph"] / BASELINE_SCANS_PER_S,
            "eager_value": runs["eager"], **extra}


class Bench:
    """One run of the bench: its inputs, budget, lines and results."""

    def __init__(self, dev: torch.device, cfgs: dict, scans: List[Scan],
                 n_warm: int, n_total: int, chunk: int, budget_s: float,
                 emit: Callable[[dict], None], t_start: float):
        self.dev, self.cfgs, self.scans = dev, cfgs, scans
        self.n_warm, self.n_total, self.chunk = n_warm, n_total, chunk
        self.budget_s, self.emit, self.t_start = budget_s, emit, t_start
        # every frame's pose of each phase, eager and graph
        self.poses: Dict[str, Dict[str, List[Pose]]] = {}
        self.warnings: List[dict] = []

    def remaining(self) -> float:
        return self.budget_s - (time.perf_counter() - self.t_start)

    def gate(self, row: dict, failed: List[str]) -> dict:
        """Flag ``row`` and warn on stderr for each failed gate."""
        for what in failed:
            print(f"WARNING: {row['metric']}: {what}; row excluded from the "
                  "final line", file=sys.stderr, flush=True)
        if failed:
            row["parity_failed"] = True
        return row

    def chunks(self) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
        """The course in calls of ``chunk`` frames: (images, counts, first
        frame) (``bench.py:150-153,335-338``)."""
        xs = torch.stack([s[0] for s in self.scans])
        cs = torch.stack([s[1] for s in self.scans])
        k = self.chunk
        return [(xs[j:j + k], cs[j:j + k], j)
                for j in range(0, self.n_total, k)]

    # --- odometry rows: image_step and batch_image_step ---------------
    def image_runs(self, name: str, cfg: LiodomConfig, scans: List[Scan],
                   init: Callable[[], object], batch: bool = False
                   ) -> Dict[str, Run]:
        """The step eager and captured over ``scans``, from ``init()``."""
        call = P.batch_image_step if batch else P.image_step

        def fn(s, x, c):
            return call(s, x, c, cfg)
        runs = {}
        for mode in MODES:
            f = fn if mode == "eager" else _captured(
                name, fn, (init(),) + scans[0], str(cfg))
            runs[mode] = timed_course(
                lambda s, i, f=f: f(s, *scans[i])[:2], init(), self.n_warm,
                self.n_total)
            self.poses.setdefault(name, {})[mode] = runs[mode].poses
        return runs

    def image_row(self, metric: str, name: str, cfg: LiodomConfig,
                  scans: List[Scan], partial: str) -> Tuple[dict, dict]:
        """A per-frame ``image_step`` row: (row, rates), the graph's final
        pose ``torch.equal`` to eager's."""
        runs = self.image_runs(name, cfg, scans,
                               lambda: P.init_state(cfg, device=self.dev))
        rates = {m: r.rate for m, r in runs.items()}
        e, g = runs["eager"].poses[-1], runs["graph"].poses[-1]
        row = _rate_row(metric, rates, graph_vs_eager_m=_gap_m(g, e),
                        partial=partial)
        failed = [] if _equal(g, e) else [
            f"graph final pose differs from eager by {_gap_m(g, e):.3g} m"]
        return self.gate(row, failed), rates

    # --- chained odometry (bench.py:139-185) -------------------------
    def chained_row(self, odo_pose: Dict[str, Pose], reps: int
                    ) -> Tuple[dict, dict]:
        """Against ``odo_pose``, each mode's last per-frame pose."""
        cfg, k = self.cfgs["cfg"], self.chunk
        chunks = [(x, c) for x, c, _ in self.chunks()]

        def fn(s, x, c):
            return P.chained_image_step(s, x, c, cfg)
        init = lambda: P.init_state(cfg, device=self.dev)   # noqa: E731
        rates, errs, last = {}, {}, {}
        for mode in MODES:
            steps = {len(x): fn if mode == "eager" else _captured(
                "chained", fn, (init(), x, c), f"{cfg}|chunk={len(x)}")
                for x, c in chunks}
            stc, track = init(), []
            for x, c in chunks:            # warm AND the parity pass
                stc, cps, _ = steps[len(x)](stc, x, c)
                track += _frames(cps)
            self.poses.setdefault("chained", {})[mode] = track
            last[mode] = track[-1]
            errs[mode] = _gap_m(last[mode], odo_pose[mode])
            t0 = time.perf_counter()
            for _ in range(reps):
                for x, c in chunks:
                    stc, cps, _ = steps[len(x)](stc, x, c)
            _fetch(cps)
            rates[mode] = reps * self.n_total / (time.perf_counter() - t0)
        row = _rate_row(
            "odometry_scans_per_s_chained", rates, chunk=k,
            final_pose_err_vs_per_frame_m=errs["graph"],
            eager_final_pose_err_vs_per_frame_m=errs["eager"],
            graph_vs_eager_m=_gap_m(last["graph"], last["eager"]),
            partial=f"odometry-only, {k} frames per call "
                    "(chained_image_step), chained from the parity pass")
        failed = [f"{m} chained odometry diverged from the per-frame loop "
                  f"by {errs[m]:.4f} m (> {CHAIN_PARITY_TOL_M} m)"
                  for m in MODES if errs[m] > CHAIN_PARITY_TOL_M]
        if not _equal(last["graph"], last["eager"]):
            failed.append("graph chained pose differs from eager")
        return self.gate(row, failed), rates

    # --- fused odometry + mapping (bench.py:252-321) ------------------
    def combined_graphs(self, refresh: Sequence[bool]) -> Dict[bool, Callable]:
        """One captured ``combined_image_step`` a refresh pattern
        (``step`` 0 refreshes, 1 holds, at ``local_map_every=4``)."""
        ccfg, mcfg = self.cfgs["ccfg"], self.cfgs["mcfg"]
        example = S.init_combined(ccfg, mcfg, device=self.dev) + self.scans[0]
        out = {}
        for r in refresh:
            def fn(o, m, x, c, i=0 if r else 1):
                return S.combined_image_step(o, m, x, c, ccfg, mcfg, step=i,
                                             local_map_every=LOCAL_MAP_EVERY)
            out[r] = _captured("combined", fn, example,
                               f"{ccfg}|{mcfg}|refresh={r}")
        return out

    def combined_step(self, mode: str, every_frame: bool) -> Callable:
        """``step(state, i)`` of the combined course: ``step=0`` every frame,
        else ``step=i``; the graph mode picks the pattern's graph."""
        ccfg, mcfg = self.cfgs["ccfg"], self.cfgs["mcfg"]
        scans = self.scans
        if mode == "eager":
            def step(st, i):
                o, m, pose, _ = S.combined_image_step(
                    *st, *scans[i], ccfg, mcfg, step=0 if every_frame else i,
                    local_map_every=LOCAL_MAP_EVERY)
                return (o, m), pose
            return step
        graphs = self.combined_graphs((True,) if every_frame
                                      else (True, False))

        def step(st, i):
            o, m, pose, _ = graphs[every_frame or i % LOCAL_MAP_EVERY == 0](
                *st, *scans[i])
            return (o, m), pose
        return step

    def local_map_check(self, m, poses: List[Pose], mode: str) -> int:
        """``bench.py:274-297``, untimed: the largest neighbourhood of the
        final map over every pose of the run (the map only grows, so a
        bound on every extraction), and the map's overflow; a warning line
        for either loss."""
        mcfg = self.cfgs["mcfg"]
        cap = mcfg.local_map_capacity
        n_hits = max(int(G.get_local_map(m, p.t, mcfg, capacity=cap)[2])
                     for p in poses)
        overflow = int(m.overflow)
        lines = []
        if n_hits > cap:
            lines.append({"warning": "local map truncated during combined "
                                     "bench", "mode": mode,
                          "max_hits": n_hits, "local_map_capacity": cap})
        if overflow > 0:
            lines.append({"warning": "map insert overflow during combined "
                                     "bench", "mode": mode,
                          "overflow": overflow,
                          "map_capacity": mcfg.map_capacity})
        for line in lines:
            self.warnings.append(line)
            self.emit(line)
        return n_hits

    def combined_runs(self, every_frame: bool
                      ) -> Tuple[Dict[str, Run], Dict[str, int]]:
        ccfg, mcfg = self.cfgs["ccfg"], self.cfgs["mcfg"]
        runs, hits = {}, {}
        for mode in MODES:
            step = self.combined_step(mode, every_frame)
            runs[mode] = timed_course(
                step, S.init_combined(ccfg, mcfg, device=self.dev),
                self.n_warm, self.n_total)
            hits[mode] = self.local_map_check(runs[mode].state[1],
                                              runs[mode].poses, mode)
        return runs, hits

    # --- chained combined (bench.py:323-388) --------------------------
    def combined_chained_row(self, async_pose: Dict[str, Pose], reps: int
                             ) -> Tuple[dict, dict, dict]:
        """Against ``async_pose``, each mode's last pose of the async
        run."""
        ccfg, mcfg, k = self.cfgs["ccfg"], self.cfgs["mcfg"], self.chunk
        every = LOCAL_MAP_EVERY
        chunks = self.chunks()
        init = lambda: S.init_combined(ccfg, mcfg, device=self.dev)  # noqa

        def chained_fn(phase):
            def fn(o, m, x, c):
                return S.chained_combined_image_step(
                    o, m, x, c, ccfg, mcfg, step0=phase,
                    local_map_every=every)
            return fn

        rates, pf, errs, last = {}, {}, {}, {}
        for mode in MODES:
            # every graph captured here, before the parity pass and the reps
            if mode == "eager":
                call = {j: chained_fn(j) for _, _, j in chunks}
            else:
                graphs = {}
                for x, c, j in chunks:     # one graph a (phase, length)
                    key = (j % every, len(x))
                    if key not in graphs:
                        graphs[key] = _captured(
                            "combined_chained", chained_fn(key[0]),
                            init() + (x, c),
                            f"{ccfg}|{mcfg}|phase={key[0]}|chunk={key[1]}")
                call = {j: graphs[(j % every, len(x))] for x, _, j in chunks}
            frame = self.combined_step(mode, every_frame=False)

            def chained_course():
                co, cm = init()
                track = []
                for x, c, j in chunks:
                    co, cm, cps, _ = call[j](co, cm, x, c)
                    track.append(cps)
                _fetch(cps)
                return track

            def per_frame_course():
                st = init()
                for i in range(self.n_total):
                    st, cp = frame(st, i)
                _fetch(cp)

            # warm AND the parity pass
            track = [p for cps in chained_course() for p in _frames(cps)]
            self.poses.setdefault("combined_chained", {})[mode] = track
            last[mode] = track[-1]
            errs[mode] = _gap_m(last[mode], async_pose[mode])
            t0 = time.perf_counter()
            for _ in range(reps):
                chained_course()
            rates[mode] = reps * self.n_total / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(reps):
                per_frame_course()
            pf[mode] = reps * self.n_total / (time.perf_counter() - t0)
        gap = _gap_m(last["graph"], last["eager"])
        row = _rate_row(
            "combined_scans_per_s_chained", rates, chunk=k,
            per_frame_same_protocol=pf["graph"],
            eager_per_frame_same_protocol=pf["eager"],
            final_pose_err_vs_per_frame_m=errs["graph"],
            eager_final_pose_err_vs_per_frame_m=errs["eager"],
            graph_vs_eager_m=gap,
            partial=f"odometry+mapping fused, {k} frames per call, async "
                    f"local-map cadence (every {every}); protocol = fresh "
                    "init + full course per rep")
        failed = [f"{m} chained combined course diverged from the per-frame "
                  f"loop by {errs[m]:.4f} m (> {CHAIN_PARITY_TOL_M} m)"
                  for m in MODES if errs[m] > CHAIN_PARITY_TOL_M]
        if gap > COMBINED_PARITY_TOL_M:
            failed.append(f"graph chained combined pose differs from eager "
                          f"by {gap:.3g} m (> {COMBINED_PARITY_TOL_M} m)")
        return self.gate(row, failed), rates, pf


def _emit_stdout(line: dict) -> None:
    print(json.dumps(line), flush=True)


NOTE = ("vs_baseline = scans/s over the 10 Hz sensor rate the reference CPU "
        "stack is engineered to sustain (laser_odometry.cc:253-256). value "
        "and every rate key: the step through runtime/aot.get_or_compile (a "
        "CUDA graph a refresh pattern, input copies and output clones "
        "included); eager_*: the step called directly; both on the host "
        "clock from a fetch to a fetch. Per-stage device times: "
        "python -m liodom_tpu_torch.tools.bench_stages.")


def run(device=None, width: Optional[int] = None,
        ring_width: Optional[int] = None, n_warm: Optional[int] = None,
        n_bench: Optional[int] = None, map_capacity: Optional[int] = None,
        local_map_capacity: Optional[int] = None,
        batches: Optional[Sequence[int]] = None,
        chunk: Optional[int] = None, reps: Optional[int] = None,
        emit: Callable[[dict], None] = _emit_stdout) -> dict:
    """The whole bench on ``device`` (CUDA unless ``"cpu"``); every size
    defaults to the module's constant (``bench.py``'s).  Each line goes to
    ``emit`` as it is measured, the final line last.  Returns ``{"rows":
    [...], "final": {...}, "warnings": [...], "poses": {phase: {mode:
    [Pose]}}}``: every frame's pose of each phase, eager and graph (the
    chained phases' parity pass)."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    width = WIDTH if width is None else width
    ring_width = RING_WIDTH if ring_width is None else ring_width
    n_warm = N_WARM if n_warm is None else n_warm
    n_bench = N_BENCH if n_bench is None else n_bench
    batches = BATCHES if batches is None else tuple(batches)
    chunk = CHUNK if chunk is None else chunk
    reps = REPS if reps is None else reps
    if n_warm < 1 or n_bench < 1:
        raise ValueError(f"n_warm={n_warm}, n_bench={n_bench}: each >= 1")
    budget_s = float(os.environ.get("LIODOM_BENCH_BUDGET_S", BUDGET_S))
    cfgs = configs(ring_width,
                   MAP_CAPACITY if map_capacity is None else map_capacity,
                   LOCAL_MAP_CAPACITY if local_map_capacity is None
                   else local_map_capacity)
    cfg, mcfg = cfgs["cfg"], cfgs["mcfg"]
    with contextlib.redirect_stdout(sys.stderr):
        build = prepare_kernels(path_kernels(True), dev)
    card = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    n_total = n_warm + n_bench
    raw = spins(n_total, width)
    scans = to_device(velodyne_scans(cfg, raw), dev)
    b = Bench(dev, cfgs, scans, n_warm, n_total, chunk, budget_s, emit,
              t_start)
    rows: List[dict] = []

    def put(row: dict) -> None:
        rows.append(row)
        emit(row)

    final = {}
    ok = lambda row: not row.get("parity_failed")   # noqa: E731

    # --- odometry-only (bench.py:112-135) -------------------------------
    row, solo = b.image_row(
        "odometry_scans_per_s_1chip", "odometry", cfg, scans,
        "odometry-only; combined configs follow")
    put(row)
    if ok(row):
        final["odometry"] = solo

    # --- chained odometry (bench.py:139-185) ----------------------------
    if b.remaining() > HEADROOM_S["chained"]:
        row, rates = b.chained_row(
            {m: p[-1] for m, p in b.poses["odometry"].items()}, reps)
        put(row)
        if ok(row):
            final["chained_scans_per_s"] = rates
    else:
        final["chained_skipped"] = SKIPPED

    # --- the deployed 15-frame window (bench.py:187-213) ----------------
    if b.remaining() > HEADROOM_S["window15"]:
        row, rates = b.image_row(
            "odometry_scans_per_s_window15", "window15", cfgs["cfg15"], scans,
            "odometry-only at the deployed local_map_size=15 "
            "(launch/liodom.launch:23)")
        put(row)
        if ok(row):
            final["window15_scans_per_s"] = rates
    else:
        final["window15_skipped"] = SKIPPED

    # --- Ouster mode (bench.py:215-249) ---------------------------------
    if b.remaining() > HEADROOM_S["ouster"]:
        oscans = to_device(ouster_scans(cfgs["ocfg"], raw), dev)
        row, rates = b.image_row(
            "ouster_scans_per_s", "ouster", cfgs["ocfg"], oscans,
            "Ouster-mode (lidar_type=1, organized rows, loader-split), "
            "odometry-only")
        put(row)
        if ok(row):
            final["ouster_scans_per_s"] = rates
    else:
        final["ouster_skipped"] = SKIPPED

    # --- fused odometry + mapping (bench.py:252-321) --------------------
    async_pose = None
    if b.remaining() > HEADROOM_S["combined"]:
        runs, hits = b.combined_runs(every_frame=True)
        rates = {m: r.rate for m, r in runs.items()}
        b.poses["combined"] = {m: r.poses for m, r in runs.items()}
        gap = _gap_m(runs["graph"].poses[-1], runs["eager"].poses[-1])
        cap = mcfg.local_map_capacity
        row = _rate_row(
            "combined_scans_per_s_1chip", rates, local_map_hits=hits["graph"],
            eager_local_map_hits=hits["eager"], local_map_capacity=cap,
            lossless=max(hits.values()) <= cap, graph_vs_eager_m=gap,
            partial="odometry+mapping fused, local map every frame")
        b.gate(row, [] if gap <= COMBINED_PARITY_TOL_M else [
            f"graph pose differs from eager by {gap:.3g} m "
            f"(> {COMBINED_PARITY_TOL_M} m)"])
        put(row)
        if ok(row):
            final["combined_scans_per_s"] = rates
        if b.remaining() > HEADROOM_S["combined_async"]:
            aruns, _ = b.combined_runs(every_frame=False)
            b.poses["combined_async"] = {m: r.poses for m, r in aruns.items()}
            async_pose = {m: r.poses[-1] for m, r in aruns.items()}
            agap = _gap_m(async_pose["graph"], async_pose["eager"])
            final["combined_async"] = {m: r.rate for m, r in aruns.items()}
            if agap > COMBINED_PARITY_TOL_M:
                print(f"WARNING: combined async graph pose differs from "
                      f"eager by {agap:.3g} m (> {COMBINED_PARITY_TOL_M} m); "
                      "excluded from the final line", file=sys.stderr,
                      flush=True)
                final["combined_async_parity_failed"] = True
        else:
            final["combined_async_skipped"] = SKIPPED
    else:
        final["combined_skipped"] = SKIPPED

    # --- chained combined (bench.py:323-388) ----------------------------
    if async_pose is not None and b.remaining() > HEADROOM_S[
            "combined_chained"]:
        row, rates, pf = b.combined_chained_row(async_pose, reps)
        put(row)
        if ok(row):
            final["combined_chained_scans_per_s"] = rates
            final["combined_chained_pf_control"] = pf
    else:
        final["combined_chained_skipped"] = SKIPPED

    # --- multi-sequence batched odometry (bench.py:390-428) -------------
    for bsz in batches:
        if b.remaining() <= HEADROOM_S["batched"]:
            final[f"batched_B{bsz}_skipped"] = SKIPPED
            continue
        lanes = [(x.expand((bsz,) + x.shape).contiguous(),
                  c.expand((bsz,) + c.shape).contiguous()) for x, c in scans]
        runs = b.image_runs(f"batched_B{bsz}", cfg, lanes,
                            lambda: init_batch_state(cfg, bsz, device=dev),
                            batch=True)
        del lanes
        agg = {m: bsz * r.rate for m, r in runs.items()}
        e, g = runs["eager"].poses[-1], runs["graph"].poses[-1]
        row = _rate_row(
            f"batched_odometry_scans_per_s_B{bsz}", agg,
            unit="scans/s aggregate",
            x_over_solo=agg["graph"] / solo["graph"],
            eager_x_over_solo=agg["eager"] / solo["eager"],
            graph_vs_eager_m=_gap_m(g, e),
            partial=f"{bsz} sequences per step (batch_image_step: K1, K2 on "
                    "the folded rings, K4)")
        b.gate(row, [] if _equal(g, e) else [
            f"graph final poses differ from eager by {_gap_m(g, e):.3g} m"])
        put(row)
        if ok(row):
            final[f"batched_B{bsz}_scans_per_s"] = agg

    out = final_line(final, time.perf_counter() - t_start, card,
                     build.get("kernel_build_s"))
    emit(out)
    return {"rows": rows, "final": out, "warnings": b.warnings,
            "poses": b.poses}


def final_line(final: dict, wall_s: float, card: str,
               build_s: Optional[float]) -> dict:
    """``bench.py:430-462``'s consolidated line: each rate under its key
    (graph) and ``eager_<key>``, the skip and parity notes as they are."""
    odo = final.get("odometry")        # None when its gate failed
    out = {"metric": "odometry_scans_per_s_1chip",
           "value": odo and odo["graph"], "unit": "scans/s",
           "vs_baseline": odo and odo["graph"] / BASELINE_SCANS_PER_S,
           "eager_value": odo and odo["eager"], "bench_wall_s": wall_s,
           "note": NOTE}
    if odo is None:
        out["parity_failed"] = True
    for key in ("window15_scans_per_s", "chained_scans_per_s",
                "ouster_scans_per_s", "combined_chained_scans_per_s",
                "combined_chained_pf_control"):
        if key in final:
            out[key] = final[key]["graph"]
            out[f"eager_{key}"] = final[key]["eager"]
    for key, v in final.items():
        if key.startswith("batched_B") and key.endswith("_scans_per_s"):
            out[key] = v["graph"]
            out[f"eager_{key}"] = v["eager"]
    if "combined_scans_per_s" in final:
        rates = final["combined_scans_per_s"]
        out["combined_scans_per_s"] = rates["graph"]
        out["eager_combined_scans_per_s"] = rates["eager"]
        out["combined_vs_baseline"] = rates["graph"] / BASELINE_SCANS_PER_S
    if "combined_async" in final and not final.get(
            "combined_async_parity_failed"):
        out["combined_async_scans_per_s"] = final["combined_async"]["graph"]
        out["eager_combined_async_scans_per_s"] = (
            final["combined_async"]["eager"])
    for key, v in final.items():
        if key.endswith("_skipped") or key.endswith("_parity_failed"):
            out[key] = v
    out["card"] = card
    out["build_s"] = build_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
