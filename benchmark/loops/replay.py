"""Closed-loop replay of recorded drives, as ``run_kitti --aot`` runs one.

Set-up renders the route, writes it as KITTI ``.bin`` files (x, y, z,
intensity float32) into a directory of ``TMPDIR``, builds and loads the
kernels and the native loader, and captures the step (``image_step``, or
``combined_image_step`` with the local map refreshed every frame) with
``runtime/aot.get_or_compile``.  The window feeds the cycled list of paths
(the ramp, then the lap again and again) through the port's
``SplitPrefetcher`` (``loader_threads`` native threads), stages each image
with the port's ``Stager``, replays the step, and fetches the poses every
``fetch_every`` frames with ``fetch_poses``; it closes with a fetch.

With ``drive_laps`` > 0 the list is a dataset of drives, each the ramp and
that many laps, replayed one after another: each drive starts from the
empty state (and, with the map, an empty map), as a replay of the next
sequence does, so the map holds one drive and its revisits.  A mapping
configuration that states ``map_reset_frames`` is run only on drives of
that many frames.

The list is sized for ``LIST_RATE`` frames a second; a faster program
finds it reopened over its repeating part (whole laps, or whole drives),
so no rate runs out of frames.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import port
from benchmark.check import Sample
from benchmark.loops.common import (Context, Result, map_record, now,
                                    reservoir, spins, sync)

# frames a second the list of paths is sized for; past it, the list is
# reopened (``Feed``)
LIST_RATE = 600


class Feed:
    """The port's loader over ``head`` and then ``cycle`` again and again:
    a ``SplitPrefetcher`` over ``head + cycle``, and a new one over
    ``cycle`` each time the last runs out."""

    def __init__(self, head: list, cycle: list, cfg, threads: int):
        self.cycle, self.cfg, self.threads = cycle, cfg, threads
        self.reopened = 0
        self._loader = port.prefetcher(head + cycle, cfg, threads)

    def next(self):
        item = self._loader.next()
        if item is None:
            self._loader.close()
            self._loader = port.prefetcher(self.cycle, self.cfg,
                                           self.threads)
            self.reopened += 1
            item = self._loader.next()
            if item is None:
                raise RuntimeError("the loader gave no frame from a fresh "
                                   f"list of {len(self.cycle)} paths")
        return item

    def close(self) -> None:
        self._loader.close()


def write_route(frames, directory: Path) -> list:
    """The ramp and the lap as ``.bin`` files; their paths in route order."""
    paths = []
    for tag, block in [("ramp", frames.ramps[0]), ("lap", frames.lap)]:
        host = block.cpu().numpy()
        for i, pts in enumerate(host):
            rec = np.zeros((len(pts), 4), np.float32)
            rec[:, :3] = pts
            p = directory / f"{tag}_{i:04d}.bin"
            rec.tofile(p)
            paths.append(str(p))
    return paths


def run(ctx: Context) -> Result:
    t = ctx.traffic
    cfg, mcfg, dev = ctx.cfg, ctx.mcfg, ctx.device
    t_in = now()
    frames = spins(ctx)
    sync(ctx.device)
    phases = {"import_s": t_in - ctx.t_process, "render_s": now() - t_in}
    ramp = frames.ramps[0].shape[0]
    lap = frames.lap.shape[0]
    tmp = Path(tempfile.mkdtemp(prefix="route-", dir=os.environ.get("TMPDIR")))
    try:
        t_in = now()
        paths = write_route(frames, tmp)
        phases["write_s"] = now() - t_in
        laps = max(1, math.ceil(ctx.seconds * LIST_RATE / lap))
        drive_laps = t.get("drive_laps", 0)
        if drive_laps:
            drive = paths[:ramp] + paths[ramp:] * drive_laps
            want = ctx.config.get("map_reset_frames")
            if ctx.mapping and want is not None and want != len(drive):
                raise ValueError(f"drives of {len(drive)} frames, but the "
                                 f"configuration resets its map every "
                                 f"{want}")
            head, cycle = [], drive * (laps // drive_laps + 1)
        else:
            head, cycle = paths[:ramp], paths[ramp:] * laps
        ctx.extra_setup = port.prepare(ctx.mapping, dev)
        ctx.extra_setup.update(phases)
        return _window(ctx, frames, head, cycle)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _window(ctx: Context, frames, head: list, cycle: list) -> Result:
    t = ctx.traffic
    cfg, mcfg, dev = ctx.cfg, ctx.mcfg, ctx.device
    fetch_every = t["fetch_every"]
    shape = (cfg.scan_lines, cfg.ring_width, 3)
    state = port.init(cfg, mcfg, dev)
    example = (state, torch.zeros(shape, device=dev),
               torch.zeros(shape[:1], dtype=torch.int32, device=dev))
    t_in = now()
    step = port.captured("bench_replay", port.step_fn(cfg, mcfg), example,
                         f"{cfg}|{mcfg}", port.path_kernels(ctx.mapping))
    stager = port.stager(shape, dev, port.staging_slots(1, (fetch_every,),
                                                        True))
    # one replay and one fetch before the clock: nothing is first done in
    # the window
    _, p0, n0 = step(state, *example[1:])
    port.fetch_poses([(p0.q, p0.t, n0)])
    ctx.extra_setup["capture_s"] = now() - t_in
    loader = Feed(head, cycle, cfg, t["loader_threads"])
    keep = reservoir(ctx)
    tracer = ctx.tracer
    trace_from = t["trace_skip"]
    trace_to = trace_from + t["trace_frames"]
    records, pending, edges, where = [], [], [], []
    init, firsts, ends = state, [], []
    drive = (frames.ramps[0].shape[0] + frames.lap.shape[0] * t["drive_laps"]
             if t.get("drive_laps") else 0)
    lossy = wait = reset = 0.0
    fetched = []                          # host clock at each fetch
    i = 0
    try:
        sync(dev)
        t0 = now()
        ctx.setup_s = t0 - ctx.t_process
        deadline = t0 + ctx.seconds
        while True:
            if i == trace_from:
                tracer.start()
            w0 = now()
            with tracer.label("loader"):
                img, counts, dropped = loader.next()
            with tracer.label("stage"):
                x, c = stager.put(img, counts)
            wait += now() - w0
            lossy += dropped > 0
            with tracer.label("step"):
                new, pose, ne = step(state, x, c)
            pending.append((pose.q, pose.t, ne))
            at = i % drive if drive else i       # the frame of its drive
            slot = keep.slot()
            if slot is not None:
                keep.put(slot, Sample(0, at, state, new, pose.q, pose.t, ne,
                                      (x, c)))
            if i < t["start_frames"]:
                firsts.append(Sample(0, i, state, new, pose.q, pose.t, ne,
                                     (x, c)))
            if tracer.active:
                records.append({"frame": i, "counts": counts,
                                "map": map_record(state, ctx.mapping),
                                "map_after": map_record(new, ctx.mapping)})
            state = new
            i += 1
            if drive and i % drive == 0:
                # the drive's last state: what it held, then the next drive
                ends.append(map_record(state, ctx.mapping, True))
                r0 = now()
                state = port.init(cfg, mcfg, dev)
                reset += now() - r0
            if i == trace_to:
                tracer.stop(len(records), records)
            if i % fetch_every == 0 or (now() >= deadline
                                       and tracer.finished):
                f0 = now()
                with tracer.label("fetch"):
                    mats, ne_h = port.fetch_poses(pending)
                edges.extend(ne_h)
                where.extend(mats[:, :3, 3])
                fetched.append((i, now(), wait, now() - f0))
                pending = []
                if now() >= deadline and tracer.finished:
                    break
        t1 = now()
    finally:
        loader.close()
    if tracer.active:
        tracer.stop(len(records), records)
    seconds = t1 - t0
    diag = {"loader_wait_ms": wait * 1e3 / max(i, 1),
            "reset_ms": reset * 1e3, "drives_reset": len(ends),
            "reopened": loader.reopened,
            **block_times([(0, t0, 0.0, 0.0)] + fetched)}
    if drive:
        diag.update(drive_times([(0, t0)] + [m[:2] for m in fetched], drive,
                                np.asarray(where)))
    return Result(attempted=i, failed=i - len(edges), lossy=int(lossy),
                  end_to_end={"scans_per_s": len(edges) / seconds},
                  samples=keep.samples() + firsts, init=init, start_lane=0,
                  batched=False, frames=frames, loader_wait_s=wait,
                  edge_counts=np.asarray(edges)[:, None],
                  extra={"state": state,
                         "positions": np.asarray(where),
                         "drive_ends": ends, "drive_frames": drive,
                         "window_diag": diag})


def drive_times(marks: list, drive: int, where: np.ndarray) -> dict:
    """Each whole drive's host ms a frame, from the blocks between fetches
    that lie inside it, and the lowest height its poses reached (below
    -1 m the local map takes the ground's level and grows).  ``marks``:
    (frames done, time) at the clock's start and at each fetch."""
    ms, zmin = [], []
    for d in range(len(where) // drive):
        lo, hi = d * drive, (d + 1) * drive
        inside = [(i1 - i0, t1 - t0) for (i0, t0), (i1, t1)
                  in zip(marks, marks[1:]) if lo <= i0 and i1 <= hi]
        n = sum(f for f, _ in inside)
        ms.append(sum(s for _, s in inside) * 1e3 / n if n else None)
        zmin.append(float(where[lo:hi, 2].min()))
    return {"drive_ms": ms, "drive_zmin_m": zmin}


def block_times(marks: list) -> dict:
    """How steady the rate was inside the window: the host clock's ms a
    frame between fetches, as quartiles and extremes over the blocks, and
    for the fastest and the slowest quarter of the blocks the mean ms a
    frame, the loader's and the stager's ms a frame and the fetch's wait
    in ms (a fetch that waits long found the card behind the host).
    ``marks``: (frames done, time, loader wait so far, fetch's seconds) at
    the clock's start and at each fetch."""
    rows = [((t1 - t0) * 1e3 / (i1 - i0), (w1 - w0) * 1e3 / (i1 - i0),
             f1 * 1e3)
            for (i0, t0, w0, _), (i1, t1, w1, f1) in zip(marks, marks[1:])
            if i1 > i0]
    if len(rows) < 8:
        return {}
    rows.sort()
    per = np.asarray(rows)
    q = len(rows) // 4
    return {"block_ms_q": [float(v) for v in np.percentile(
                per[:, 0], [0, 25, 50, 75, 100])],
            "fast_quarter": [float(v) for v in per[:q].mean(0)],
            "slow_quarter": [float(v) for v in per[-q:].mean(0)]}
