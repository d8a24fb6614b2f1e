"""A kernel's share of its roofline: the least time the card could take
for a launch's work over the time the launch took.

The least time is the larger of the bytes over the HBM's bandwidth and the
operations over the float32 peak, NVIDIA's data sheet for the H100 SXM at
its full 700 W (the card's power limit is printed beside every run's
reading).  The bytes and operations come from ``benchmark/counts/<kernel>.py``,
computed from the traced frames' own inputs (ring counts, edges, window and
map sizes); the times from the profiler's kernel records by name.
"""

from __future__ import annotations

from typing import List, Optional

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def frame_inputs(run) -> List[dict]:
    """The traced frames' inputs, one dict a frame (a list of lanes' in the
    ``lanes`` key of a batched run)."""
    tr, res = run.trace, run.result
    cfg, mcfg = run.cfg, run.mcfg
    edges = res.edge_counts                 # (frames, lanes)
    k_win = cfg.local_map_size
    out = []
    for rec in tr.records:
        f = rec["frame"]
        if f >= len(edges):
            continue
        lane_counts = rec.get("lane_counts", [rec.get("counts")])
        lanes = []
        for lane, counts in enumerate(lane_counts):
            before = edges[max(0, f - k_win):f, lane]
            d = {"counts": counts, "rings": cfg.scan_lines,
                 "ring_width": cfg.ring_width, "regions": cfg.scan_regions,
                 "picks": cfg.edges_per_region + 1,
                 "edge_slots": cfg.max_edges, "edges": int(edges[f, lane]),
                 "window_slots": k_win * cfg.max_edges,
                 "window_points": int(before.sum()), "k": cfg.knn_k,
                 "received": 0, "received_slots": 0}
            if rec.get("map") is not None:
                received, occ0 = (int(v) for v in rec["map"].tolist())
                hits, occ1 = (int(v) for v in rec["map_after"].tolist())
                d.update(received=received, received_slots=(
                    mcfg.local_map_capacity), occupied_before=occ0,
                    occupied_after=occ1, hits=hits,
                    map_slots=mcfg.map_capacity,
                    local_slots=mcfg.local_map_capacity)
            lanes.append(d)
        out.append(lanes[0] if len(lanes) == 1 and "lane_counts" not in rec
                   else {"lanes": lanes})
    return out


def share(run, kernel: str) -> Optional[float]:
    """Percent of the roofline of the kernels ``benchmark/counts/<kernel>
    .py`` counts, over the traced frames; None when the trace holds none of
    its launches or no frame the count can read."""
    if run.trace is None:
        return None
    count = run.spec.count(kernel)
    seconds, launches = run.trace.kernel(count.KERNEL)
    if not launches or seconds <= 0:
        return None
    frames = [f for f in frame_inputs(run) if count.applies(f)]
    if not frames:
        return None
    least = sum(least_s(*count.count(f)) for f in frames)
    # every launch of a frame does that frame's work: launches / frames
    # launches a frame, each held to its frame's least time
    return 100.0 * least * (launches / len(frames)) / seconds
