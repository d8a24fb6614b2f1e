"""The online odometry node, as ``run_stream`` runs it: open loop at the
sensor's rate on the benchmark's own clock.

Set-up renders the route and splits every spin with the port's loader
(``runtime/native.split_velodyne``) before the clock, as ``run_stream``
pre-splits its scans.  In the window a sensor thread offers frame ``j`` at
``t0 + j / rate_hz`` into the port's ``Channel`` of ``queue`` slots with
drop-oldest (``offer_latest``), whatever the engine does; the engine (this
thread) pops it, stages it (``Stager``), steps it eagerly (``image_step``,
as ``run_stream``'s engine does) and fetches the pose at once.  A frame's
latency runs from the moment it was due to the moment its pose is on the
host; a dropped frame misses every limit.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import port
from benchmark.check import Sample
from benchmark.loops.common import (Context, Result, frame_key, host_images,
                                    now, reservoir, spins, sync)

LEAD_S = 0.05       # the first frame is due this long after the clock starts


def run(ctx: Context) -> Result:
    t = ctx.traffic
    cfg, mcfg, dev = ctx.cfg, ctx.mcfg, ctx.device
    t_in = now()
    frames = spins(ctx)
    sync(dev)
    phases = {"import_s": t_in - ctx.t_process, "render_s": now() - t_in}
    t_in = now()
    images = host_images(ctx, frames, 1)
    phases["split_s"] = now() - t_in
    ctx.extra_setup = port.prepare(ctx.mapping, dev)
    ctx.extra_setup.update(phases)
    shape = (cfg.scan_lines, cfg.ring_width, 3)
    step = port.step_fn(cfg, mcfg)
    stager = port.stager(shape, dev, t["queue"] + 3)
    # two warm frames on a throwaway state: libraries loaded, workspaces
    # and the allocator's blocks made, the fetch's copy path used
    warm = port.init(cfg, mcfg, dev)
    for i in range(2):
        img, counts, _ = images[frame_key(frames, 0, i)]
        warm, pose, ne = step(warm, *stager.put(img, counts))
        port.fetch_poses([(pose.q, pose.t, ne)])
    del warm
    state = init = port.init(cfg, mcfg, dev)
    rate = t["rate_hz"]
    due = math.ceil(ctx.seconds * rate)
    ch = port.channel(t["queue"])
    closed, timeout = port.channel_errors()
    keep = reservoir(ctx)
    tracer = ctx.tracer
    trace_from, trace_to = t["trace_skip"], t["trace_skip"] + t["trace_frames"]
    records, firsts, edges, where = [], [], [], []
    latency = np.full(due, math.inf)
    lossy = done = 0
    sync(dev)
    t0 = now() + LEAD_S
    ctx.setup_s = t0 - ctx.t_process

    def sensor():
        for j in range(due):
            wait = t0 + j / rate - now()
            if wait > 0:
                time.sleep(wait)
            ch.offer_latest(j)
        ch.close()

    thread = threading.Thread(target=sensor, name="sensor", daemon=True)
    thread.start()
    try:
        while True:
            try:
                j = ch.pop(timeout=2.0 + 2.0 / rate)
            except (closed, timeout):
                break
            if done == trace_from:
                tracer.start()
            img, counts, dropped = images[frame_key(frames, 0, j)]
            lossy += dropped > 0
            with tracer.label("stage"):
                x, c = stager.put(img, counts)
            with tracer.label("step"):
                new, pose, ne = step(state, x, c)
            with tracer.label("fetch"):
                mats, ne_h = port.fetch_poses([(pose.q, pose.t, ne)])
            latency[j] = now() - (t0 + j / rate)
            edges.append(int(ne_h[0]))
            where.append((j, mats[0, :3, 3]))
            slot = keep.slot()
            if slot is not None:
                keep.put(slot, Sample(0, j, state, new, pose.q, pose.t, ne,
                                      (x, c)))
            if j < t["start_frames"]:
                firsts.append(Sample(0, j, state, new, pose.q, pose.t, ne,
                                     (x, c)))
            if tracer.active:
                records.append({"frame": done, "counts": counts, "map": None,
                                "map_after": None})
            state = new
            done += 1
            if done == trace_to:
                tracer.stop(len(records), records)
    finally:
        thread.join(timeout=ctx.seconds + 10.0)
    if thread.is_alive():
        raise RuntimeError("the sensor thread did not finish")
    if tracer.active:
        tracer.stop(len(records), records)
    p95 = float(np.quantile(latency, 0.95, method="higher")) * 1e3
    return Result(attempted=due, failed=due - done, lossy=int(lossy),
                  end_to_end={"pose_latency_p95_ms": p95},
                  samples=keep.samples() + firsts, init=init, start_lane=0,
                  batched=False, frames=frames,
                  edge_counts=np.asarray(edges)[:, None],
                  extra={"state": state, "positions": where})
