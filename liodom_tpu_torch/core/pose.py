"""SE(3) / quaternion math on torch tensors (port of ``liodom_tpu.core.pose``).

A pose is a pair ``(q, t)`` with ``q`` a unit quaternion stored **wxyz** and
``t`` a 3-vector, ``x_world = R(q) @ x_local + t`` — the reference's
``Eigen::Isometry3d`` plus Ceres quaternion parameter block
(laser_odometry.cc:186-227).  Every function broadcasts over leading batch
dimensions and keeps the dtype and device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Pose(NamedTuple):
    """Rigid transform: ``x_world = R(q) @ x_local + t``. q is wxyz."""

    q: torch.Tensor  # (..., 4) unit quaternion, wxyz
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, batch: Tuple[int, ...] = (),
                 device=None) -> "Pose":
        q = torch.zeros(batch + (4,), dtype=dtype, device=device)
        # fill_, not `q[..., 0] = 1.0`: a Python scalar assigned into a
        # CUDA tensor is copied from the host, which synchronises
        q.select(-1, 0).fill_(1.0)
        t = torch.zeros(batch + (3,), dtype=dtype, device=device)
        return Pose(q, t)

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        R = quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                             device=top.device)
        bottom.select(-1, 3).fill_(1.0)
        return torch.cat([top, bottom], dim=-2)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz storage."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), in the
    2-cross-product form."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> wxyz quaternion. Branch-free Shepperd
    (selects the numerically best of four candidate constructions)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    qw2 = m00 + m11 + m22
    qx2 = m00 - m11 - m22
    qy2 = m11 - m00 - m22
    qz2 = m22 - m00 - m11

    def scale(c):
        return torch.sqrt(torch.clamp(1.0 + c, min=1e-12)) * 2.0

    s = scale(qw2)
    cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s], dim=-1)
    s = scale(qx2)
    cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s], dim=-1)
    s = scale(qy2)
    cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s], dim=-1)
    s = scale(qz2)
    cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s], dim=-1)

    cands = torch.stack([cw, cx, cy, cz], dim=-2)          # (..., 4, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """axis-angle 3-vector -> wxyz quaternion, Taylor-safe at phi = 0."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0,
                            torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, sinc_half * phi], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> axis-angle 3-vector (magnitude in [0, pi])."""
    q = torch.where(q[..., :1] < 0, -q, q)  # take the short arc
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        theta / torch.clamp(vn, min=1e-12))
    return scale[..., None] * v


def compose(a: Pose, b: Pose) -> Pose:
    """a then b applied innermost: x -> a(b(x)) (matrix product A @ B)."""
    return Pose(quat_normalize(quat_mul(a.q, b.q)),
                quat_rotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(qi, -quat_rotate(qi, p.t))


def transform(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points (..., 3)."""
    q = p.q[..., None, :] if pts.ndim > p.q.ndim else p.q
    t = p.t[..., None, :] if pts.ndim > p.t.ndim else p.t
    return quat_rotate(q, pts) + t


def retract(p: Pose, delta: torch.Tensor) -> Pose:
    """Apply a 6-dim tangent update ``delta = (dtheta, dt)``: left
    exponential on the rotation (Ceres' quaternion local parameterisation,
    laser_odometry.cc:202), additive on the translation."""
    dq = so3_exp_quat(delta[..., :3])
    return Pose(quat_normalize(quat_mul(dq, p.q)), p.t + delta[..., 3:])


def rpy_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (tf::Matrix3x3::getRPY) from a wxyz quaternion
    (laser_odometry.cc:157-168, 422-425)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rpy_from_quat` (tf::Matrix3x3::setRPY)."""
    half = 0.5 * rpy
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def kitti_row(p: Pose) -> torch.Tensor:
    """Flattened 3x4 row-major pose row (KITTI poses.txt, stats.cc:75-95)."""
    return p.matrix()[..., :3, :].reshape(p.q.shape[:-1] + (12,))

