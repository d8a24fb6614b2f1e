"""Synthetic LiDAR scene generation (numpy copy of ``liodom_tpu.core.synth``).

Simulates an HDL-64-like scanner in a structured world (ground plane,
building walls, poles) so the pipeline can be run and scored against exact
ground truth without sensor data.  ``chip_smoke.py`` renders its scenes with
it; :class:`StreamWorld`, the unbounded tiled world, carries
``apps/run_stream.py`` and ``apps/run_longcourse.py``.  Renders equal the
JAX package's bit for bit for the same arguments.  :func:`tie_scene` (no
JAX counterpart) makes kNN inputs full of exact ties.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np


def hdl64_directions(width: int = 1800) -> Tuple[np.ndarray, np.ndarray]:
    """Unit ray directions for a 64-ring spin: (64*width, 3) and elevations."""
    az = np.linspace(-np.pi, np.pi, width, endpoint=False)
    elevs = np.deg2rad(np.linspace(2.0, -24.3, 64))
    e, a = np.meshgrid(elevs, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                 axis=-1)
    return d.reshape(-1, 3), elevs


class BoxWorld:
    """Axis-aligned world: ground plane at z, a ring of walls, random poles."""

    def __init__(self, seed: int = 0, extent: float = 60.0, n_poles: int = 60,
                 ground_z: float = -1.8):
        rng = np.random.default_rng(seed)
        self.extent = extent
        self.ground_z = ground_z
        ang = rng.uniform(0, 2 * np.pi, n_poles)
        rad = rng.uniform(8.0, extent * 0.9, n_poles)
        self.poles = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
        self.pole_r = rng.uniform(0.15, 0.5, n_poles)

    def render(self, sensor_xyz: np.ndarray, R: np.ndarray,
               width: int = 1800, noise: float = 0.01,
               seed: int = 0) -> np.ndarray:
        """Ray-cast a scan from pose (R, sensor_xyz). Returns (N, 3) points in
        the SENSOR frame (what the device would output)."""
        dirs_s, _ = hdl64_directions(width)
        dirs_w = dirs_s @ R.T                     # world-frame ray directions
        o = sensor_xyz

        t_best = np.full(len(dirs_w), np.inf)
        # ground plane z = ground_z
        dz = dirs_w[:, 2]
        tg = np.where(dz < -1e-6, (self.ground_z - o[2]) / np.minimum(dz, -1e-6),
                      np.inf)
        t_best = np.minimum(t_best, tg)
        # four walls at +-extent in x and y
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            da = dirs_w[:, axis]
            denom = np.where(np.abs(da) > 1e-6, da, 1e-6)
            tw = (sign * self.extent - o[axis]) / denom
            hit = (tw > 0.1) & (np.sign(da) == sign)
            t_best = np.where(hit, np.minimum(t_best, tw), t_best)
        # poles: infinite vertical cylinders
        d2 = dirs_w[:, :2]
        for (px, py), pr in zip(self.poles, self.pole_r):
            rel = np.array([px, py]) - o[:2]
            a = np.sum(d2 * d2, -1)
            b = -2.0 * (d2 @ rel)
            c = rel @ rel - pr * pr
            disc = b * b - 4 * a * c
            ok = (disc > 0) & (a > 1e-9)
            sq = np.sqrt(np.maximum(disc, 0))
            t0 = (-b - sq) / np.maximum(2 * a, 1e-9)
            hit = ok & (t0 > 0.1)
            t_best = np.where(hit, np.minimum(t_best, t0), t_best)

        t_best = np.where(np.isfinite(t_best), t_best, 1e4)
        pts_w = o[None, :] + t_best[:, None] * dirs_w
        # back to sensor frame
        pts_s = (pts_w - o[None, :]) @ R
        rng = np.random.default_rng(seed)
        pts_s = pts_s + rng.normal(size=pts_s.shape) * noise
        return pts_s.astype(np.float32)


class StreamWorld:
    """Unbounded procedurally-tiled world — the long-trajectory stand-in for
    KITTI-scale sequences (the finite :class:`BoxWorld` ends at
    ~frame 115; the reference's whole evaluation protocol is thousands of
    frames of map growth, stats.cc:75-95).

    Geometry is a pure deterministic function of ``(seed, tile)``: each
    ``tile x tile`` metre cell of the XY plane owns a few poles and
    (sometimes) an axis-aligned building box, generated from a
    ``SeedSequence([seed, tx, ty])`` stream the moment a render needs them.
    The world therefore extends for ±2^31 tiles in every direction, never
    repeats, and every renderer sees the same scene — no state, no growth.

    Buildings give the scene the planar structure BoxWorld's arena walls
    provided (edge features at wall corners + strong XY constraints); the
    infinite ground plane pins z exactly as before.
    """

    def __init__(self, seed: int = 0, tile: float = 28.0,
                 poles_per_tile: int = 5, p_building: float = 0.75,
                 ground_z: float = -1.8, max_range: float = 80.0):
        # densities calibrated to BoxWorld's near-field feature richness
        # (~0.0065 poles/m^2): the edge solver weights NEAR points highest
        # (w = 1.01 - d_norm, factors.hpp:89-98), so sparse close-range
        # geometry starves it — 2 poles/tile measured RPE@1 ~0.7 m on CPU
        # controls vs ~0.1 m at 5/tile + 2 boxes
        self.seed = seed
        self.tile = tile
        self.poles_per_tile = poles_per_tile
        self.p_building = p_building
        self.ground_z = ground_z
        self.max_range = max_range
        self._cache: dict = {}
        # render workers share one world (run_longcourse/run_stream thread
        # pools); generation is deterministic so duplicate work is harmless,
        # but dict eviction racing an insert is not — guard the cache
        self._cache_lock = threading.Lock()
        self._keepout: np.ndarray | None = None
        self._keepout_r = 3.0
        # bumped by set_keepout: a tile generated under an older keepout is
        # returned to its caller but never cached
        self._generation = 0

    def set_keepout(self, path_xy: np.ndarray, clearance: float = 3.0
                    ) -> None:
        """Register the vehicle trajectory: tile objects within
        ``clearance`` of any path point are dropped at generation time.

        Without this, object placement knows nothing about the course and
        the vehicle statistically transits buildings/poles on long drives
        (the box slab test needs tmin > 0.1, so walls seen from INSIDE are
        invisible — physically inconsistent see-through frames).  The
        world stays deterministic given (seed, path); every renderer of a
        course must register the same path.  Clears the tile cache; a tile
        whose generation began before this call is not cached, so every
        cached tile is the one a fresh world with this keepout makes."""
        keepout = np.asarray(path_xy, np.float64)[:, :2]
        with self._cache_lock:
            self._keepout = keepout
            self._keepout_r = float(clearance)
            self._generation += 1
            self._cache.clear()

    @staticmethod
    def _path_near(p: np.ndarray, x0, y0, x1, y1) -> np.ndarray:
        """Keep-out path points of ``p`` within the [x0, x1] x [y0, y1]
        bbox."""
        m = ((p[:, 0] >= x0) & (p[:, 0] <= x1)
             & (p[:, 1] >= y0) & (p[:, 1] <= y1))
        return p[m]

    def _tile_objects(self, tx: int, ty: int):
        """(poles (P, 3: x, y, r), boxes (B, 6: x0, x1, y0, y1, z0, z1)) of
        one tile — cached; identical for every renderer of this world.  The
        keepout is read under the cache lock with the generation it belongs
        to, and the tile is cached only if no ``set_keepout`` ran since."""
        key = (tx, ty)
        with self._cache_lock:
            hit = self._cache.get(key)
            keepout, r, generation = (self._keepout, self._keepout_r,
                                      self._generation)
        if hit is not None:
            return hit
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, tx & 0xFFFFFFFF,
                                    ty & 0xFFFFFFFF]))
        t, x0, y0 = self.tile, tx * self.tile, ty * self.tile
        poles = np.column_stack([
            rng.uniform(x0 + 1.0, x0 + t - 1.0, self.poles_per_tile),
            rng.uniform(y0 + 1.0, y0 + t - 1.0, self.poles_per_tile),
            rng.uniform(0.15, 0.5, self.poles_per_tile)])
        blist = []
        if rng.uniform() < self.p_building:      # a building
            w, d = rng.uniform(4.0, 10.0, 2)
            bx = rng.uniform(x0 + 2.0, x0 + t - 2.0 - w)
            by = rng.uniform(y0 + 2.0, y0 + t - 2.0 - d)
            h = rng.uniform(3.0, 9.0)
            blist.append([bx, bx + w, by, by + d,
                          self.ground_z, self.ground_z + h])
        if rng.uniform() < 0.5:                  # a shed / kiosk
            w, d = rng.uniform(1.5, 3.5, 2)
            bx = rng.uniform(x0 + 1.0, x0 + t - 1.0 - w)
            by = rng.uniform(y0 + 1.0, y0 + t - 1.0 - d)
            h = rng.uniform(1.5, 3.0)
            blist.append([bx, bx + w, by, by + d,
                          self.ground_z, self.ground_z + h])
        boxes = (np.asarray(blist) if blist else np.zeros((0, 6)))
        if keepout is not None:
            near = self._path_near(keepout, x0 - r, y0 - r, x0 + t + r,
                                   y0 + t + r)
            if len(near):
                d = np.linalg.norm(
                    poles[:, None, :2] - near[None, :, :], axis=-1)
                poles = poles[d.min(axis=1) > (r + poles[:, 2])]
                keep = []
                for b in boxes:
                    inside = ((near[:, 0] >= b[0] - r)
                              & (near[:, 0] <= b[1] + r)
                              & (near[:, 1] >= b[2] - r)
                              & (near[:, 1] <= b[3] + r))
                    if not inside.any():
                        keep.append(b)
                boxes = (np.asarray(keep) if keep else np.zeros((0, 6)))
        with self._cache_lock:
            if generation == self._generation:
                self._cache[key] = (poles, boxes)
                # bound the cache (long runs walk far): drop oldest tiles
                if len(self._cache) > 4096:
                    self._cache.pop(next(iter(self._cache)))
        return poles, boxes

    def _gather(self, o: np.ndarray):
        """All objects within max_range of the sensor at ``o``."""
        r = self.max_range
        lo_x = int(np.floor((o[0] - r) / self.tile))
        hi_x = int(np.floor((o[0] + r) / self.tile))
        lo_y = int(np.floor((o[1] - r) / self.tile))
        hi_y = int(np.floor((o[1] + r) / self.tile))
        poles, boxes = [], []
        for tx in range(lo_x, hi_x + 1):
            for ty in range(lo_y, hi_y + 1):
                p, b = self._tile_objects(tx, ty)
                poles.append(p)
                boxes.append(b)
        return np.concatenate(poles), np.concatenate(boxes)

    def render(self, sensor_xyz: np.ndarray, R: np.ndarray,
               width: int = 1800, noise: float = 0.01,
               seed: int = 0) -> np.ndarray:
        """Ray-cast a scan from pose (R, sensor_xyz); same contract as
        :meth:`BoxWorld.render` — (N, 3) float32 points, sensor frame."""
        dirs_s, _ = hdl64_directions(width)
        o = np.asarray(sensor_xyz, np.float64)
        # float32 throughout the intersection math: the (P, N) temporaries
        # are memory-bandwidth-bound (measured 1.85 s/frame in f64 -> ~2x
        # in f32); worst-case f32 error at 100 m range is ~1e-3 m, far
        # below the 1e-2 m sensor noise.  Rays are cast RELATIVE to the
        # sensor (origin 0), which also removes large-coordinate
        # cancellation on long courses.
        dirs_w = (dirs_s @ R.T).astype(np.float32)
        poles, boxes = self._gather(o)

        t_best = np.full(len(dirs_w), np.inf, np.float32)
        dz = dirs_w[:, 2]
        tg = np.where(dz < -1e-6,
                      np.float32(self.ground_z - o[2])
                      / np.minimum(dz, -1e-6), np.inf)
        t_best = np.minimum(t_best, tg)

        # poles: vertical cylinders, vectorized over poles x rays (chunked
        # to keep the (p, N) temporaries cache-sized)
        d2 = dirs_w[:, :2]                                   # (N, 2)
        a = np.maximum(np.sum(d2 * d2, -1), 1e-9)            # (N,)
        rel_all = (poles[:, :2] - o[None, :2]).astype(np.float32)
        pr2_all = (poles[:, 2] ** 2).astype(np.float32)
        for j in range(0, len(poles), 16):
            rel = rel_all[j:j + 16, None, :]                 # (p, 1, 2)
            b = -2.0 * np.sum(d2[None] * rel, -1)            # (p, N)
            c = np.sum(rel * rel, -1) - pr2_all[j:j + 16, None]
            disc = b * b - 4 * a[None] * c
            np.sqrt(np.maximum(disc, 0, out=disc), out=disc)
            t0 = (-b - disc) / (2 * a[None])
            t0 = np.where((disc > 0) & (t0 > 0.1), t0, np.inf)
            t_best = np.minimum(t_best, t0.min(axis=0))

        # buildings: axis-aligned boxes, slab method vectorized over boxes
        # (chunked to bound the (b, N, 3) temporaries)
        if len(boxes):
            inv = 1.0 / np.where(np.abs(dirs_w) < 1e-12,
                                 np.copysign(np.float32(1e-12), dirs_w),
                                 dirs_w)
            bmin = (boxes[:, (0, 2, 4)] - o[None]).astype(np.float32)
            bmax = (boxes[:, (1, 3, 5)] - o[None]).astype(np.float32)
            for j in range(0, len(boxes), 8):
                lo = bmin[j:j + 8, None, :] * inv[None]
                hi = bmax[j:j + 8, None, :] * inv[None]
                tmin = np.minimum(lo, hi).max(axis=-1)      # (b, N)
                tmax = np.maximum(lo, hi).min(axis=-1)
                t = np.where((tmax > tmin) & (tmin > 0.1), tmin, np.inf)
                t_best = np.minimum(t_best, t.min(axis=0))

        t_best = np.where(np.isfinite(t_best), t_best, np.float32(1e4))
        pts_s = (t_best[:, None] * dirs_w) @ R.astype(np.float32)
        rng = np.random.default_rng(seed)
        pts_s = pts_s + rng.normal(size=pts_s.shape) * noise
        return pts_s.astype(np.float32)


def drive_trajectory(n_frames: int, speed: float = 1.0,
                     yaw_rate: float = 0.01,
                     accel_frames: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """A gently curving trajectory accelerating from rest (vehicles start at
    rest — the constant-velocity predictor, like the reference's, needs
    motion to build gradually, laser_odometry.cc:148-150).
    Returns (positions (F, 3), yaws (F,))."""
    yaws = np.cumsum(np.full(n_frames, yaw_rate)) - yaw_rate
    pos = np.zeros((n_frames, 3))
    for i in range(1, n_frames):
        v = speed * min(1.0, i / max(accel_frames, 1))
        pos[i] = pos[i - 1] + v * np.array(
            [np.cos(yaws[i - 1]), np.sin(yaws[i - 1]), 0.0])
    return pos, yaws


def yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) — the tf/URDF fixed-axis RPY
    convention the reference uses (laser_odometry.cc:422-425)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def quat_from_matrix_np(R: np.ndarray) -> np.ndarray:
    """wxyz quaternion from a rotation matrix (numpy, ground-truth side)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def drive_trajectory_6dof(n_frames: int, speed: float = 1.0,
                          yaw_rate: float = 0.03, accel_frames: int = 4,
                          roll_amp: float = 0.05, pitch_amp: float = 0.04,
                          z_amp: float = 0.3, period: float = 40.0,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rotation-rich 6-DoF course: the yaw drive of :func:`drive_trajectory`
    plus sinusoidal roll/pitch excitation and z undulation — the scenario the
    planar course cannot score (roll/pitch drift, z motion, IMU override).

    Returns (positions (F, 3), rotations (F, 3, 3), quats wxyz (F, 4))."""
    yaws = np.cumsum(np.full(n_frames, yaw_rate)) - yaw_rate
    i = np.arange(n_frames)
    rolls = roll_amp * np.sin(2 * np.pi * i / period)
    pitches = pitch_amp * np.sin(2 * np.pi * i / (0.7 * period) + 1.0)
    zs = z_amp * np.sin(2 * np.pi * i / (1.3 * period))
    pos = np.zeros((n_frames, 3))
    for f in range(1, n_frames):
        v = speed * min(1.0, f / max(accel_frames, 1))
        pos[f] = pos[f - 1] + v * np.array(
            [np.cos(yaws[f - 1]), np.sin(yaws[f - 1]), 0.0])
    pos[:, 2] = zs
    rots = np.stack([rpy_matrix(rolls[f], pitches[f], yaws[f])
                     for f in range(n_frames)])
    quats = np.stack([quat_from_matrix_np(rots[f]) for f in range(n_frames)])
    return pos, rots, quats


def tie_scene(seed: int, e: int, m: int, lattice: float = 0.05
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """kNN inputs whose answer rests on the tie order: queries and refs on a
    ``lattice`` grid in three 2.4 m clusters 8 m apart, refs repeating m / 3
    lattice sites, queries on ref sites and next to them, ~10 % of either
    side invalid, so many distances in a row are exactly equal.

    Returns (query (e, 3), query mask (e,), ref (m, 3), ref mask (m,))."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0, 0.0], [8.0, 0.0, 0.0], [0.0, 8.0, 0.0]])
    half = int(1.2 / lattice)
    c = centers[rng.integers(0, len(centers), m // 3)]
    off = rng.integers(-half, half + 1, (m // 3, 3)) * [1, 1, 0.25]
    base = c + np.round(off) * lattice
    r = base[rng.integers(0, len(base), m)]
    q = r[rng.integers(0, m, e)] + rng.integers(-1, 2, (e, 3)) * lattice
    return (q.astype(np.float32), rng.random(e) > 0.1,
            r.astype(np.float32), rng.random(m) > 0.1)
