"""The long drive's world and route, rendered on the device from the seed.

The world is the port's ``StreamWorld`` (``core/synth.py``): the plane cut
into ``tile`` x ``tile`` m tiles, each owning ``poles_per_tile`` vertical
poles, with probability ``p_building`` a building and with 0.5 a shed,
drawn from ``numpy.random.default_rng(SeedSequence([world_seed, tx, ty]))``
in ``StreamWorld._tile_objects``'s order, over an infinite ground plane;
objects within ``keepout_m`` of the route are dropped as
``StreamWorld.set_keepout`` drops them.  :func:`render` is a torch copy of
``StreamWorld.render`` that casts a batch of spins at once on any device:
each frame sees the objects of the tiles that overlap the square of
``max_range_m`` about it (``StreamWorld._gather``), and the intersections
run in float32 relative to the sensor, vectorised over frames, rays and
objects.  Every operation is element-wise or a min / max, so a frame's
spin does not depend on the frames rendered beside it: the check renders a
kept frame again alone and gets the spin the files hold.

The route is one drive of ``drive_frames`` frames at ``speed_m`` a frame,
rolled up from rest over ``ramp_frames`` frames as
``core/synth.drive_trajectory`` does, turning ``yaw_rate`` rad a frame with
the sign flipped every ``yaw_flip_frames`` frames, so its heading swings
within a quarter turn and the course never comes back to its own
corridor.  The seed sets the start (position and heading) and the noise,
frame by frame: a spin is a function of (seed, frame).

A spin keeps the rays that return: those hitting something within
``returns_m`` of the sensor, as a Velodyne ``.bin`` holds.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from benchmark import world

# frames and objects cast at once (the (frames, rays, objects) temporaries)
FRAME_CHUNK = 8
OBJECT_CHUNK = 32


@dataclass(frozen=True)
class WorldParams:
    """``StreamWorld``'s arguments."""
    seed: int = 0
    tile: float = 28.0
    poles_per_tile: int = 5
    p_building: float = 0.75
    ground_z: float = -1.8
    max_range: float = 80.0

    @staticmethod
    def of(scene: dict) -> "WorldParams":
        return WorldParams(scene["world_seed"], scene["tile_m"],
                           scene["poles_per_tile"], scene["p_building"],
                           scene["ground_z_m"], scene["max_range_m"])


def tile_objects(wp: WorldParams, tx: int, ty: int, keepout: np.ndarray,
                 clearance: float) -> Tuple[np.ndarray, np.ndarray]:
    """(poles (P, 3: x, y, r), boxes (B, 6: x0, x1, y0, y1, z0, z1)) of one
    tile, ``StreamWorld._tile_objects`` draw for draw, without the objects
    within ``clearance`` of a point of ``keepout`` (N, 2)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([wp.seed, tx & 0xFFFFFFFF, ty & 0xFFFFFFFF]))
    t, x0, y0 = wp.tile, tx * wp.tile, ty * wp.tile
    n = wp.poles_per_tile
    poles = np.column_stack([rng.uniform(x0 + 1.0, x0 + t - 1.0, n),
                             rng.uniform(y0 + 1.0, y0 + t - 1.0, n),
                             rng.uniform(0.15, 0.5, n)])
    boxes = []
    if rng.uniform() < wp.p_building:              # a building
        w, d = rng.uniform(4.0, 10.0, 2)
        bx = rng.uniform(x0 + 2.0, x0 + t - 2.0 - w)
        by = rng.uniform(y0 + 2.0, y0 + t - 2.0 - d)
        h = rng.uniform(3.0, 9.0)
        boxes.append([bx, bx + w, by, by + d, wp.ground_z, wp.ground_z + h])
    if rng.uniform() < 0.5:                        # a shed
        w, d = rng.uniform(1.5, 3.5, 2)
        bx = rng.uniform(x0 + 1.0, x0 + t - 1.0 - w)
        by = rng.uniform(y0 + 1.0, y0 + t - 1.0 - d)
        h = rng.uniform(1.5, 3.0)
        boxes.append([bx, bx + w, by, by + d, wp.ground_z, wp.ground_z + h])
    boxes = np.asarray(boxes) if boxes else np.zeros((0, 6))
    r = clearance
    near = keepout[(keepout[:, 0] >= x0 - r) & (keepout[:, 0] <= x0 + t + r)
                   & (keepout[:, 1] >= y0 - r)
                   & (keepout[:, 1] <= y0 + t + r)]
    if len(near):
        d = np.linalg.norm(poles[:, None, :2] - near[None], axis=-1)
        poles = poles[d.min(axis=1) > r + poles[:, 2]]
        keep = [b for b in boxes
                if not ((near[:, 0] >= b[0] - r) & (near[:, 0] <= b[1] + r)
                        & (near[:, 1] >= b[2] - r)
                        & (near[:, 1] <= b[3] + r)).any()]
        boxes = np.asarray(keep) if keep else np.zeros((0, 6))
    return poles, boxes


def tile_range(wp: WorldParams, o: np.ndarray) -> Tuple[int, int, int, int]:
    """The tiles ``StreamWorld._gather`` reads for a sensor at ``o``:
    (lo_x, hi_x, lo_y, hi_y), inclusive."""
    r = wp.max_range
    return (int(np.floor((o[0] - r) / wp.tile)),
            int(np.floor((o[0] + r) / wp.tile)),
            int(np.floor((o[1] - r) / wp.tile)),
            int(np.floor((o[1] + r) / wp.tile)))


@dataclass
class Objects:
    """Every object of the tiles a route reads, on the device: poles
    (P, 3) and boxes (B, 6) float64, each with its tile (P, 2) / (B, 2)."""
    poles: torch.Tensor
    pole_tile: torch.Tensor
    boxes: torch.Tensor
    box_tile: torch.Tensor

    @staticmethod
    def along(wp: WorldParams, positions: np.ndarray, keepout_xy: np.ndarray,
              clearance: float, device) -> "Objects":
        tiles = set()
        for o in positions:
            lx, hx, ly, hy = tile_range(wp, o)
            tiles.update((tx, ty) for tx in range(lx, hx + 1)
                         for ty in range(ly, hy + 1))
        poles, boxes, pt, bt = [], [], [], []
        for tx, ty in sorted(tiles):
            p, b = tile_objects(wp, tx, ty, keepout_xy, clearance)
            poles.append(p)
            boxes.append(b)
            pt += [(tx, ty)] * len(p)
            bt += [(tx, ty)] * len(b)

        def dev(parts, width, dtype=torch.float64):
            a = np.concatenate(parts) if parts else np.zeros((0, width))
            return torch.as_tensor(np.asarray(a).reshape(-1, width),
                                   dtype=dtype, device=device)
        return Objects(dev(poles, 3), dev([np.asarray(pt)], 2, torch.int64),
                       dev(boxes, 6), dev([np.asarray(bt)], 2, torch.int64))


def _seen(tile: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(F, O): the object's tile lies in frame f's tile range."""
    tx, ty = tile[None, :, 0], tile[None, :, 1]
    return ((tx >= ranges[:, None, 0]) & (tx <= ranges[:, None, 1])
            & (ty >= ranges[:, None, 2]) & (ty <= ranges[:, None, 3]))


def render(wp: WorldParams, objs: Objects, positions: np.ndarray,
           rotations: np.ndarray, width: int, noise: float,
           noise_seeds: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spins from the poses (F, 3) / (F, 3, 3), float64 on the host, on the
    objects' device: ((F, 64 * width, 3) float32 points in the sensor
    frame, ``StreamWorld.render`` ray for ray (1e4 m along a ray that hits
    nothing), plus N(0, noise) per coordinate from a generator seeded with
    ``noise_seeds[f]``; (F, 64 * width) float32 distance to the hit, inf
    where none)."""
    dev = objs.poles.device
    f32 = torch.float32
    dirs_s = world.hdl64_directions(width, dev)                  # (N, 3)
    pos = torch.as_tensor(positions, dtype=torch.float64, device=dev)
    rot = torch.as_tensor(rotations, dtype=torch.float64, device=dev)
    # R @ d for each ray, element-wise (no matrix product: its order would
    # follow the batch's shape)
    dirs = torch.stack([sum(dirs_s[None, :, k] * rot[:, None, j, k]
                            for k in range(3)) for j in range(3)],
                       -1).to(f32)                               # (F, N, 3)
    ranges = torch.as_tensor([tile_range(wp, o) for o in positions],
                             dtype=torch.int64, device=dev)
    inf = torch.tensor(math.inf, dtype=f32, device=dev)
    dz = dirs[..., 2]
    gz = (wp.ground_z - pos[:, 2]).to(f32)[:, None]
    t_best = torch.where(dz < -1e-6, gz / torch.clamp(dz, max=-1e-6), inf)
    # poles: vertical cylinders
    d2x, d2y = dirs[..., 0:1], dirs[..., 1:2]                   # (F, N, 1)
    a = torch.clamp(d2x * d2x + d2y * d2y, min=1e-9)
    seen = _seen(objs.pole_tile, ranges)
    for j in range(0, objs.poles.shape[0], OBJECT_CHUNK):
        p = objs.poles[j:j + OBJECT_CHUNK]
        if not bool(seen[:, j:j + OBJECT_CHUNK].any()):
            continue
        rel = (p[None, :, :2] - pos[:, None, :2]).to(f32)        # (F, P, 2)
        rx, ry = rel[:, None, :, 0], rel[:, None, :, 1]          # (F, 1, P)
        b = -2.0 * (d2x * rx + d2y * ry)                         # (F, N, P)
        c = (rx * rx + ry * ry) - (p[:, 2] ** 2).to(f32)
        disc = torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0))
        t0 = (-b - disc) / (2 * a)
        hit = (disc > 0) & (t0 > 0.1) & seen[:, None, j:j + OBJECT_CHUNK]
        t_best = torch.minimum(t_best,
                               torch.where(hit, t0, inf).amin(-1))
    # buildings: axis-aligned boxes, slab method
    seen = _seen(objs.box_tile, ranges)
    if objs.boxes.shape[0]:
        tiny = torch.copysign(torch.full_like(dirs, 1e-12), dirs)
        inv = 1.0 / torch.where(dirs.abs() < 1e-12, tiny, dirs)  # (F, N, 3)
        for j in range(0, objs.boxes.shape[0], OBJECT_CHUNK):
            bx = objs.boxes[j:j + OBJECT_CHUNK]
            if not bool(seen[:, j:j + OBJECT_CHUNK].any()):
                continue
            lo_c = (bx[None, :, [0, 2, 4]] - pos[:, None]).to(f32)
            hi_c = (bx[None, :, [1, 3, 5]] - pos[:, None]).to(f32)
            lo = lo_c[:, None] * inv[:, :, None]                 # (F, N, B, 3)
            hi = hi_c[:, None] * inv[:, :, None]
            tmin = torch.minimum(lo, hi).amax(-1)
            tmax = torch.maximum(lo, hi).amin(-1)
            hit = ((tmax > tmin) & (tmin > 0.1)
                   & seen[:, None, j:j + OBJECT_CHUNK])
            t_best = torch.minimum(t_best,
                                   torch.where(hit, tmin, inf).amin(-1))
    t_ray = torch.where(torch.isfinite(t_best), t_best,
                        torch.full_like(t_best, 1e4))
    # (t d) R, element-wise in float32
    r32 = rot.to(f32)
    td = t_ray[..., None] * dirs
    pts = torch.stack([sum(td[..., k] * r32[:, None, k, j] for k in range(3))
                       for j in range(3)], -1)
    if noise:
        eps = torch.stack([
            torch.randn(pts.shape[1:], dtype=f32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(s))
            for s in noise_seeds])
        pts = pts + noise * eps
    return pts, t_best


@dataclass(frozen=True)
class Route:
    """One drive: ``frames`` frames at ``speed`` m a frame after a ramp of
    ``ramp_frames`` from rest, turning ``yaw_rate`` rad a frame with the
    sign flipped every ``flip_frames`` frames, from ``start`` (x, y) at
    heading ``heading``."""
    frames: int
    speed: float
    ramp_frames: int
    yaw_rate: float
    flip_frames: int
    start: Tuple[float, float]
    heading: float

    def poses(self) -> Tuple[np.ndarray, np.ndarray]:
        """(positions (F, 3), rotations (F, 3, 3)) of every frame, as
        ``drive_trajectory`` steps: frame i moves ``speed * min(1, i /
        ramp)`` along the heading of frame i - 1."""
        n = self.frames
        i = np.arange(n)
        rate = np.where((i // self.flip_frames) % 2 == 0, self.yaw_rate,
                        -self.yaw_rate)
        yaw = self.heading + np.concatenate([[0.0], np.cumsum(rate[:-1])])
        v = self.speed * np.minimum(1.0, i / max(self.ramp_frames, 1))
        step = np.zeros((n, 3))
        step[1:, 0] = v[1:] * np.cos(yaw[:-1])
        step[1:, 1] = v[1:] * np.sin(yaw[:-1])
        pos = np.cumsum(step, axis=0)
        pos[:, 0] += self.start[0]
        pos[:, 1] += self.start[1]
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.zeros((n, 3, 3))
        rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
        rot[:, 2, 2] = 1.0
        return pos, rot


def route_from_seed(seed: int, route: dict) -> Route:
    """The drive of ``seed``: its start within ``start_box_m`` of the
    origin and its heading, from a stream of its own."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    half = route["start_box_m"] / 2
    x, y = rng.uniform(-half, half, 2)
    return Route(route["drive_frames"], route["speed_m"],
                 route["ramp_frames"], route["yaw_rate"],
                 route["yaw_flip_frames"], (float(x), float(y)),
                 float(rng.uniform(0.0, 2 * math.pi)))


def noise_seed(seed: int, frame: int) -> int:
    """The noise generator's seed of one frame of ``seed``'s drive."""
    return int(np.random.SeedSequence([seed, 2, frame]).generate_state(
        1, np.uint64)[0] & 0x7FFF_FFFF_FFFF_FFFF)


class _Count:
    """A block of ``n`` spins as ``loops/replay._window`` sizes a drive
    (``shape[0]``)."""

    def __init__(self, n: int):
        self.shape = (n,)


class Drive:
    """A rendered drive's frames, as the replay window and the check read
    them: ``ramps[0]`` and ``lap`` give the ramp's and the rest's length
    (one drive of one lap), :meth:`spin` renders a frame on the device
    (the points the drive's file holds), :meth:`truth` its position."""

    def __init__(self, seed: int, config: dict, device):
        sc, rt = config["scene"], config["route"]
        self.seed = seed
        self.wp = WorldParams.of(sc)
        self.width = sc["columns"]
        self.noise = sc["noise_m"]
        self.returns_m = sc["returns_m"]
        self.route = route_from_seed(seed, rt)
        self.positions, self.rotations = self.route.poses()
        self.objects = Objects.along(self.wp, self.positions,
                                     self.positions[:, :2], rt["keepout_m"],
                                     device)
        ramp = rt["ramp_frames"]
        self.ramps = [_Count(ramp)]
        self.lap = _Count(self.route.frames - ramp)
        self.starts = [0]

    def __len__(self) -> int:
        return self.route.frames

    def spins(self, first: int, count: int) -> List[torch.Tensor]:
        """Frames ``first`` .. ``first + count - 1``, each (M, 3) float32
        on the device: the rays that return, in ray order."""
        idx = list(range(first, first + count))
        pts, t = render(self.wp, self.objects, self.positions[idx],
                        self.rotations[idx], self.width, self.noise,
                        [noise_seed(self.seed, i) for i in idx])
        keep = t <= self.returns_m
        return [pts[f][keep[f]] for f in range(len(idx))]

    def spin(self, lane: int, i: int) -> torch.Tensor:
        """Frame ``i`` of the drive (one drive, one lane)."""
        return self.spins(i, 1)[0]

    def truth(self, lane: int, i: int) -> np.ndarray:
        """Frame ``i``'s position in the frame of the drive's first pose."""
        p, r = self.positions, self.rotations
        return r[0].T @ (p[i] - p[0])
