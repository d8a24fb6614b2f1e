"""Synthetic LiDAR scene generation (numpy copy of ``liodom_tpu.core.synth``).

Simulates an HDL-64-like scanner in a structured world (ground plane,
building walls, poles) so the pipeline can be run and scored against exact
ground truth without sensor data.  ``chip_smoke.py`` renders its scenes with
it.  The unbounded ``StreamWorld`` is not part of this slice.
:func:`tie_scene` (no JAX counterpart) makes kNN inputs full of exact ties.
"""

from __future__ import annotations

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
