"""Many drives replayed at once: ``batch_image_step`` over ``lanes`` lanes,
captured as a graph.

The lanes drive the one route, entering the lap ``lane_gap`` frames
apart, each after a ramp from rest of its own (its own spins and noise);
so at every step each lane holds another frame.  Set-up splits every
distinct spin with the port's loader before the clock.  Each step stages
every lane's image (one ``Stager`` a lane) and replays the step; the poses
are fetched every ``fetch_every`` steps, and the window closes with a
fetch.  The rate is the lanes' frames over the window.  The frames kept
for the check are spread evenly over the lanes: kept slot ``j`` holds a
frame of lane ``j % lanes``, and first frame ``k`` is lane
``start_lane + k``'s, so a fault on some of the lanes shows on as large a
share of the kept frames.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import port
from benchmark.check import Sample
from benchmark.loops.common import (Context, Result, frame_key, host_images,
                                    now, reservoir, spins, sync)


def run(ctx: Context) -> Result:
    t = ctx.traffic
    cfg, dev = ctx.cfg, ctx.device
    lanes, fetch_every = t["lanes"], t["fetch_every"]
    t_in = now()
    frames = spins(ctx, lanes, t["lane_gap"])
    sync(dev)
    phases = {"import_s": t_in - ctx.t_process, "render_s": now() - t_in}
    t_in = now()
    images = host_images(ctx, frames, lanes)
    phases["split_s"] = now() - t_in
    ctx.extra_setup = port.prepare(False, dev)
    ctx.extra_setup.update(phases)
    shape = (cfg.scan_lines, cfg.ring_width, 3)
    state = port.init(cfg, None, dev, lanes)
    batch = port.step_fn(cfg, None, lanes)

    def fn(s, xs, cs):
        return batch(s, torch.stack(xs), torch.stack(cs))

    zeros = tuple(torch.zeros(shape, device=dev) for _ in range(lanes))
    counts0 = tuple(torch.zeros(shape[:1], dtype=torch.int32, device=dev)
                    for _ in range(lanes))
    step = port.captured("bench_fleet", fn, (state, zeros, counts0),
                         f"{cfg}|lanes={lanes}", port.path_kernels(False))
    slots = port.staging_slots(1, (fetch_every,), True)
    stagers = [port.stager(shape, dev, slots) for _ in range(lanes)]
    _, p0, n0 = step(state, zeros, counts0)
    port.fetch_poses([(p0.q, p0.t, n0)])
    keep = reservoir(ctx)
    lane_rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 3]))
    start_lane = int(lane_rng.integers(lanes))
    tracer = ctx.tracer
    trace_from, trace_to = t["trace_skip"], t["trace_skip"] + t["trace_frames"]
    records, pending, edges, firsts, where = [], [], [], [], []
    init = state
    lossy = k = 0
    sync(dev)
    t0 = now()
    ctx.setup_s = t0 - ctx.t_process
    deadline = t0 + ctx.seconds
    while True:
        if k == trace_from:
            tracer.start()
        staged, counts = [], []
        with tracer.label("stage"):
            for lane in range(lanes):
                img, cnt, dropped = images[frame_key(frames, lane, k)]
                lossy += dropped > 0
                staged.append(stagers[lane].put(img, cnt))
                counts.append(cnt)
        xs = tuple(s[0] for s in staged)
        cs = tuple(s[1] for s in staged)
        with tracer.label("step"):
            new, pose, ne = step(state, xs, cs)
        pending.append((pose.q, pose.t, ne))
        slot = keep.slot()
        if slot is not None:
            lane = slot % lanes          # every lane as often as another
            keep.put(slot, Sample(lane, k, state, new, pose.q[lane],
                                  pose.t[lane], ne[lane], staged[lane]))
        if k < t["start_frames"]:
            lane = (start_lane + k) % lanes
            firsts.append(Sample(lane, k, state, new, pose.q[lane],
                                 pose.t[lane], ne[lane], staged[lane]))
        if tracer.active:
            records.append({"frame": k, "lane_counts": counts})
        state = new
        k += 1
        if k == trace_to:
            tracer.stop(len(records), records)
        if k % fetch_every == 0 or (now() >= deadline
                                       and tracer.finished):
            with tracer.label("fetch"):
                mats, ne_h = port.fetch_poses(pending)
            edges.extend(ne_h.reshape(-1, lanes))
            where.extend(mats[:, :3, 3].reshape(-1, lanes, 3))
            pending = []
            if now() >= deadline and tracer.finished:
                break
    seconds = now() - t0
    if tracer.active:
        tracer.stop(len(records), records)
    done = len(edges) * lanes
    return Result(attempted=k * lanes, failed=k * lanes - done,
                  lossy=int(lossy),
                  end_to_end={"scans_per_s": done / seconds},
                  samples=keep.samples() + firsts, init=init,
                  start_lane=start_lane,
                  batched=True, frames=frames,
                  edge_counts=np.asarray(edges),
                  extra={"state": state,
                         "positions": np.asarray(where)[:, start_lane]})
