"""The benchmark's scene and route, rendered on the device from the seed.

The scene is the port's ``BoxWorld`` (ground plane at -1.8 m, four walls at
+-60 m, 60 vertical poles), its poles drawn from ``numpy.random.default_rng
(seed)`` in the same order, so a pole layout equals ``BoxWorld(seed)``'s.
:func:`render` is a torch copy of ``BoxWorld.render`` that casts a batch of
spins at once on any device (float64 geometry, float32 points); the noise
comes from a ``torch.Generator`` on that device.

The route is a closed circuit: ``circuit_frames`` poses a lap on a circle
whose circumference is ``circuit_frames * speed``, driven counter-clockwise,
so frame ``j`` and frame ``j + circuit_frames`` are one pose and a replay
can cycle the lap with no jump.  Each lane first rolls ``ramp_frames``
frames up to speed from rest, as ``drive_trajectory`` does (steps of
``speed * i / ramp_frames``), along the same circle.  The seed sets the
noise and the lap's starting phase; the configuration fixes the scene
(``world_seed``), so every seed drives one world.  Poles within
``keepout_m`` (plus their radius) of any pose of the route are removed,
as ``StreamWorld.set_keepout`` does.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

LINES = 64
ELEV_TOP_DEG, ELEV_BOTTOM_DEG = 2.0, -24.3


def hdl64_directions(width: int, device, dtype=torch.float64) -> torch.Tensor:
    """Unit ray directions of a 64-line spin, ring-major: (64 * width, 3),
    ``core/synth.hdl64_directions`` on the device."""
    az = torch.arange(width, dtype=dtype, device=device) * (2 * math.pi
                                                            / width) - math.pi
    elevs = torch.deg2rad(torch.linspace(ELEV_TOP_DEG, ELEV_BOTTOM_DEG, LINES,
                                         dtype=dtype, device=device))
    e, a = torch.meshgrid(elevs, az, indexing="ij")
    d = torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a),
                     torch.sin(e)], dim=-1)
    return d.reshape(-1, 3)


@dataclass(frozen=True)
class Scene:
    """A ``BoxWorld``: poles (P, 2) centres and (P,) radii, walls at
    +-``extent`` on x and y, the ground at ``ground_z``."""
    poles: np.ndarray
    pole_r: np.ndarray
    extent: float = 60.0
    ground_z: float = -1.8

    @staticmethod
    def from_seed(seed: int, extent: float = 60.0, n_poles: int = 60,
                  ground_z: float = -1.8) -> "Scene":
        rng = np.random.default_rng(seed)
        ang = rng.uniform(0, 2 * np.pi, n_poles)
        rad = rng.uniform(8.0, extent * 0.9, n_poles)
        poles = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
        return Scene(poles, rng.uniform(0.15, 0.5, n_poles), extent, ground_z)

    def keep_out(self, path_xy: np.ndarray, clearance: float) -> "Scene":
        """The scene without the poles within ``clearance`` plus their
        radius of any point of ``path_xy`` (N, 2)."""
        d = np.linalg.norm(self.poles[:, None, :] - path_xy[None, :, :2],
                           axis=-1).min(axis=1)
        keep = d > clearance + self.pole_r
        return Scene(self.poles[keep], self.pole_r[keep], self.extent,
                     self.ground_z)


def render(scene: Scene, positions: torch.Tensor, rotations: torch.Tensor,
           width: int, noise: float, generator: torch.Generator,
           chunk: int = 16) -> torch.Tensor:
    """Spins from the poses (F, 3) / (F, 3, 3), float64 on the device:
    (F, 64 * width, 3) float32 points in the sensor frame, each ray's first
    hit on the ground, a wall or a pole (1e4 m along it where none), plus
    N(0, noise) per coordinate drawn from ``generator`` in frame order.
    ``BoxWorld.render`` ray for ray."""
    dev = positions.device
    dirs_s = hdl64_directions(width, dev)
    poles = torch.as_tensor(scene.poles, dtype=torch.float64, device=dev)
    radii = torch.as_tensor(scene.pole_r, dtype=torch.float64, device=dev)
    out = []
    for f0 in range(0, positions.shape[0], chunk):
        o = positions[f0:f0 + chunk][:, None, :]             # (C, 1, 3)
        R = rotations[f0:f0 + chunk]
        dirs = dirs_s[None] @ R.transpose(1, 2)              # (C, N, 3)
        inf = torch.full(dirs.shape[:2], math.inf, dtype=torch.float64,
                         device=dev)
        dz = dirs[..., 2]
        t_best = torch.where(dz < -1e-6, (scene.ground_z - o[..., 2])
                             / torch.clamp(dz, max=-1e-6), inf)
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            da = dirs[..., axis]
            denom = torch.where(da.abs() > 1e-6, da,
                                torch.full_like(da, 1e-6))
            tw = (sign * scene.extent - o[..., axis]) / denom
            hit = (tw > 0.1) & (torch.sign(da) == sign)
            t_best = torch.where(hit, torch.minimum(t_best, tw), t_best)
        d2 = dirs[..., :2]
        a = (d2 * d2).sum(-1)
        for p, r in zip(poles, radii):
            rel = p - o[..., :2]                             # (C, 1, 2)
            b = -2.0 * (d2 * rel).sum(-1)
            c = (rel * rel).sum(-1) - r * r
            disc = b * b - 4 * a * c
            ok = (disc > 0) & (a > 1e-9)
            sq = torch.sqrt(torch.clamp(disc, min=0))
            t0 = (-b - sq) / torch.clamp(2 * a, min=1e-9)
            hit = ok & (t0 > 0.1)
            t_best = torch.where(hit, torch.minimum(t_best, t0), t_best)
        t_best = torch.where(torch.isfinite(t_best), t_best,
                             torch.full_like(t_best, 1e4))
        # the hit relative to the sensor, in the sensor frame
        pts = (t_best[..., None] * dirs) @ R
        if noise:
            pts = pts + noise * torch.randn(pts.shape, dtype=torch.float64,
                                            device=dev, generator=generator)
        out.append(pts.to(torch.float32))
    return torch.cat(out)


@dataclass(frozen=True)
class Route:
    """The circuit of a run: ``speed`` m a frame, ``circuit_frames`` frames
    a lap, ``ramp_frames`` frames from rest, the lap's start at angle
    ``phase`` on a circle about the origin."""
    speed: float
    circuit_frames: int
    ramp_frames: int
    phase: float

    @property
    def radius(self) -> float:
        return self.speed * self.circuit_frames / (2 * math.pi)

    def ramp_arc(self) -> List[float]:
        """Arc lengths of the ramp's frames from the first one: 0, then the
        sums of the steps ``speed * i / ramp_frames`` (i = 1 .. ramp - 1);
        the step after the last ramp frame is a full ``speed``."""
        s, arcs = 0.0, []
        for i in range(self.ramp_frames):
            s += self.speed * i / self.ramp_frames
            arcs.append(s)
        return arcs

    def poses(self, arcs: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
        """(positions (F, 3), rotations (F, 3, 3)) at arc lengths along the
        circle from the lap's start, heading along it (yaw only)."""
        th = self.phase + np.asarray(arcs, np.float64) / self.radius
        pos = np.stack([self.radius * np.cos(th), self.radius * np.sin(th),
                        np.zeros_like(th)], -1)
        yaw = th + math.pi / 2
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.zeros((len(th), 3, 3))
        rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
        rot[:, 2, 2] = 1.0
        return pos, rot

    def lap_arcs(self) -> List[float]:
        """Arc lengths of the lap's frames (``circuit_frames``)."""
        return [self.speed * j for j in range(self.circuit_frames)]

    def lane_ramp_arcs(self, start: int) -> List[float]:
        """Arc lengths of the ramp that rolls from rest into lap frame
        ``start``, a full ``speed`` step after its last frame."""
        arcs = self.ramp_arc()
        base = self.speed * (start - 1) - (arcs[-1] if arcs else 0.0)
        return [base + a for a in arcs]


def route_from_seed(seed: int, speed: float, circuit_frames: int,
                    ramp_frames: int) -> Route:
    """The route of ``seed``: its lap's starting phase from a stream of
    its own, apart from the scene's."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    return Route(speed, circuit_frames, ramp_frames,
                 float(rng.uniform(0.0, 2 * math.pi)))


@dataclass
class Frames:
    """Rendered spins of a run: ``ramps[l]`` (ramp_frames, N, 3) per lane
    and ``lap`` (circuit_frames, N, 3), float32 on the device; the lane
    ``l`` enters the lap at frame ``starts[l]``."""
    ramps: List[torch.Tensor]
    lap: torch.Tensor
    starts: List[int]
    lap_pose: Tuple[np.ndarray, np.ndarray] = None     # (L, 3), (L, 3, 3)
    ramp_poses: List[Tuple[np.ndarray, np.ndarray]] = None

    def spin(self, lane: int, i: int) -> torch.Tensor:
        """Lane ``lane``'s ``i``-th frame (0 = the first ramp frame)."""
        return self.lap[self.lap_index(lane, i)] if i >= len(
            self.ramps[lane]) else self.ramps[lane][i]

    def truth(self, lane: int, i: int) -> np.ndarray:
        """Lane ``lane``'s frame ``i`` position in the frame of its first
        pose (the odometry's frame), from the route."""
        def pose(j):
            if j < len(self.ramps[lane]):
                p, r = self.ramp_poses[lane]
                return p[j], r[j]
            p, r = self.lap_pose
            k = self.lap_index(lane, j)
            return p[k], r[k]
        p0, r0 = pose(0)
        return r0.T @ (pose(i)[0] - p0)

    def lap_index(self, lane: int, i: int) -> int:
        """The lap frame of lane ``lane``'s frame ``i`` past its ramp."""
        return (self.starts[lane] + i - len(self.ramps[lane])) % len(self.lap)


def make_frames(seed: int, route_cfg: dict, lanes: int, lane_gap: int,
                device, width: int) -> Tuple[Frames, Scene, Route]:
    """Render the run's spins on ``device``: the lap once and a ramp for
    each of ``lanes`` lanes, lane ``l`` entering the lap at frame
    ``l * lane_gap``; the noise and the lap's phase from ``seed``, the
    scene from ``route_cfg["world_seed"]``."""
    route = route_from_seed(seed, route_cfg["speed_m"],
                            route_cfg["circuit_frames"],
                            route_cfg["ramp_frames"])
    starts = [(l * lane_gap) % route.circuit_frames for l in range(lanes)]
    lap_pos, lap_rot = route.poses(route.lap_arcs())
    ramp_poses = [route.poses(route.lane_ramp_arcs(s)) for s in starts]
    path = np.concatenate([lap_pos] + [p for p, _ in ramp_poses])
    scene = Scene.from_seed(route_cfg["world_seed"], route_cfg["extent_m"],
                            route_cfg["poles"], route_cfg["ground_z_m"]
                            ).keep_out(path[:, :2], route_cfg["keepout_m"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)

    def spins(pos, rot):
        return render(scene, torch.as_tensor(pos, device=device),
                      torch.as_tensor(rot, device=device), width,
                      route_cfg["noise_m"], gen)

    lap = spins(lap_pos, lap_rot)
    ramps = [spins(p, r) for p, r in ramp_poses]
    return (Frames(ramps, lap, starts, (lap_pos, lap_rot), ramp_poses),
            scene, route)
