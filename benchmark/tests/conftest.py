"""Helpers of the benchmark's CPU tests: cells cut to a size a CPU runs in
seconds (the widths of the spin, the ring and the window, the lap, the
capacities, the samples), never used by a benchmark run."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(workload: str):
    from benchmark import spec
    cell = spec.Cell(spec.load_benchmark(ROOT), workload, ROOT)
    c = copy.deepcopy(cell.config)
    c["scene"]["columns"] = 256
    c["odometry"]["ring_width"] = 512
    c["odometry"]["local_map_size"] = 3
    c["route"]["circuit_frames"] = 24
    if c.get("map"):
        c["map"].update(map_capacity=65536, local_map_capacity=8192)
    if "map_reset_frames" in c:
        c["map_reset_frames"] = (c["route"]["ramp_frames"] +
                                 cell.traffic["drive_laps"] *
                                 c["route"]["circuit_frames"])
    cell.config = c
    kept = cell.traffic["samples"] + cell.traffic["start_frames"]
    t = dict(cell.traffic, samples=3, start_frames=3, trace_skip=1,
             trace_frames=2)
    if "lanes" in t:
        # 3 kept frames a lane, so a fault on one lane of the two shows
        t.update(lanes=2, lane_gap=12, samples=6)
    if "rate_hz" in t:
        t.update(rate_hz=2.0)
    cell.traffic = t
    # a count of kept frames allows the same share of the fewer frames
    over = "pose_frames_over"
    if over in cell.limits:
        cell.limits = dict(cell.limits)
        cell.limits[over] = (cell.limits[over] *
                             (t["samples"] + t["start_frames"]) // kept)
    return cell


@pytest.fixture
def cpu_threads():
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)
