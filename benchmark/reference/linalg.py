"""Matrix products at a stated precision, and the pose algebra on them."""

from __future__ import annotations

from typing import NamedTuple

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) on TF32's 10-bit
    mantissa, as a tensor core rounds its operands."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 with TF32 off; with ``precision="tf32"`` the
    operands are first rounded to TF32 (the products and sums stay
    float32)."""
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "float32":
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return torch.matmul(a, b)


class Pose(NamedTuple):
    """``x_world = R(q) x + t``; q a unit quaternion, wxyz."""
    q: torch.Tensor
    t: torch.Tensor


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix of wxyz quaternions (..., 4)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def rotate(q: torch.Tensor, v: torch.Tensor, precision: str) -> torch.Tensor:
    """R(q) v for points v (N, 3): one matrix product."""
    return mm(v, rotation(q).transpose(-1, -2), precision)


def transform(p: Pose, pts: torch.Tensor, precision: str) -> torch.Tensor:
    return rotate(p.q, pts, precision) + p.t


def compose(a: Pose, b: Pose, precision: str) -> Pose:
    """``a`` after ``b``."""
    return Pose(normalize(quat_mul(a.q, b.q)),
                rotate(a.q, b.t[None], precision)[0] + a.t)


def inverse(p: Pose, precision: str) -> Pose:
    qi = quat_conj(p.q)
    return Pose(qi, -rotate(qi, p.t[None], precision)[0])


def exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) to a wxyz quaternion."""
    th2 = (phi * phi).sum()
    if float(th2) < 1e-12:
        return torch.cat([(1.0 - th2 / 8.0)[None], (0.5 - th2 / 48.0) * phi])
    th = torch.sqrt(th2)
    return torch.cat([torch.cos(th / 2)[None], torch.sin(th / 2) / th * phi])


def retract(p: Pose, delta: torch.Tensor) -> Pose:
    """Left update on the rotation, additive on the translation (Ceres'
    quaternion parameterisation, laser_odometry.cc:202)."""
    return Pose(normalize(quat_mul(exp_quat(delta[:3]), p.q)),
                p.t + delta[3:])


def angle_between(qa: torch.Tensor, qb: torch.Tensor) -> float:
    """Rotation angle (rad) between two unit quaternions: of ``qa^-1 qb``,
    ``2 atan2(|xyz|, |w|)`` in float64, accurate for small angles."""
    r = quat_mul(quat_conj(qa.double()), qb.double())
    return float(2.0 * torch.atan2(torch.linalg.norm(r[1:]), r[0].abs()))
