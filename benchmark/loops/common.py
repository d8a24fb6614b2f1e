"""What the loops share: the run's context, its result, the route's
spins and the step's warm start."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import port, world
from benchmark.check import Reservoir
from benchmark.trace import Tracer


@dataclass
class Context:
    """A run: the cell's files, the port's configs, the device, the seed,
    the window's length and the process's start on the host clock."""
    config: dict
    traffic: dict
    cfg: object
    mcfg: object
    device: torch.device
    seed: int
    seconds: float
    tracer: Tracer
    t_process: float
    setup_s: float = 0.0            # the process's start to the window's
    extra_setup: dict = field(default_factory=dict)

    @property
    def mapping(self) -> bool:
        return self.mcfg is not None


@dataclass
class Result:
    """What a loop hands back: its counts, its end-to-end readings, the
    frames kept for the check and what the per-layer readers take."""
    attempted: int
    failed: int
    lossy: int
    end_to_end: Dict[str, float]
    samples: list                   # drawn from the seed, then the first
    init: object                    # the program's state before frame 0
    start_lane: int                 # the lane whose drift the log gives
    batched: bool                   # states carry a lane dimension
    frames: world.Frames
    loader_wait_s: float = 0.0
    edge_counts: Optional[np.ndarray] = None   # (frames, lanes)
    extra: dict = field(default_factory=dict)


def spins(ctx: Context, lanes: int = 1, lane_gap: int = 0) -> world.Frames:
    """The route's spins for ``lanes`` lanes, rendered on the device."""
    sc, route = ctx.config["scene"], ctx.config["route"]
    frames, _, _ = world.make_frames(
        ctx.seed, {**route, **sc}, lanes, lane_gap, ctx.device,
        sc["columns"])
    return frames


def host_images(ctx: Context, frames: world.Frames, lanes: int):
    """Every distinct spin of the lanes split by the port's loader on the
    host: ``{("lap", j) | ("ramp", lane, i): (image, counts, dropped)}``."""
    out = {}
    for j in range(frames.lap.shape[0]):
        out[("lap", j)] = port.split(frames.lap[j].cpu().numpy(), ctx.cfg)
    for lane in range(lanes):
        for i in range(frames.ramps[lane].shape[0]):
            out[("ramp", lane, i)] = port.split(
                frames.ramps[lane][i].cpu().numpy(), ctx.cfg)
    return out


def frame_key(frames: world.Frames, lane: int, i: int) -> tuple:
    if i < frames.ramps[lane].shape[0]:
        return ("ramp", lane, i)
    return ("lap", frames.lap_index(lane, i))


def reservoir(ctx: Context) -> Reservoir:
    return Reservoir(ctx.traffic["samples"], ctx.seed)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def now() -> float:
    return time.perf_counter()


def map_record(state, mapping: bool, overflow: bool = False):
    """Device scalars of a mapping state, enqueued without a wait: (rows
    received, occupied slots), and the points the map dropped."""
    if not mapping:
        return None
    o, m = state
    parts = [o.received_valid.sum(), m.valid.sum()]
    if overflow:
        parts.append(m.overflow.to(parts[0].dtype))
    return torch.stack(parts)
