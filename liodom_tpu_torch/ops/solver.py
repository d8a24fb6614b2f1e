"""Pose solver: weighted point-to-line residuals + Huber Levenberg-Marquardt.

Port of ``liodom_tpu/ops/solver.py``, which replaces the reference's Ceres
stack (factors.hpp + laser_odometry.cc:196-228: autodiff
``Point2LineFactor``, HuberLoss(0.2), quaternion parameterisation, 4 LM
iterations):

* the residual and its analytic Jacobian w.r.t. the 6-dim SE(3) tangent
  (left-multiplicative quaternion retraction) are batched over all
  correspondences;
* Huber is applied as IRLS weights;
* every function takes leading batch dimensions (``batch_image_step``
  solves B independent poses at once);
* the normal equations reduce to a 6x6 system, solved by
  ``torch.linalg.solve_ex`` (no error check, so no wait on the device);
* accept/reject and the damping update are tensor selects, so the whole
  solve is enqueued without a host synchronisation.

The residual follows factors.hpp:71-105, including the distance weight
``w = 1.01 - d_norm`` whose dependence on ``t`` enters the Jacobian.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.pose import Pose


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def point_to_line_residual(pose: Pose, cp: torch.Tensor, lpa: torch.Tensor,
                           lpb: torch.Tensor, min_range: float,
                           max_range: float) -> torch.Tensor:
    """Point2LineFactor residual (factors.hpp:71-105), batched over (..., 3):
    r = w (lp - lpa) x (lp - lpb) / |lpa - lpb|,  lp = R cp + t,
    w = 1.01 - (|(cp - t)_xy| - min) / (max - min)."""
    lp = se3.quat_rotate(pose.q, cp) + pose.t
    nu = se3.cross(lp - lpa, lp - lpb)
    de_norm = torch.clamp(torch.linalg.norm(lpa - lpb, dim=-1, keepdim=True),
                          min=1e-12)
    cp_l = cp - pose.t
    d = torch.sqrt(cp_l[..., 0] ** 2 + cp_l[..., 1] ** 2)
    w = 1.01 - (d - min_range) / (max_range - min_range)
    return w[..., None] * nu / de_norm


def point_to_line_jacobian(pose: Pose, cp: torch.Tensor, lpa: torch.Tensor,
                           lpb: torch.Tensor, min_range: float,
                           max_range: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual + analytic Jacobian w.r.t. the tangent (dtheta, dt).

    Retraction q' = exp(dtheta) q, t' = t + dt:
    d lp / d dtheta = -skew(R cp);  d lp / d dt = I;
    d nu / d lp = skew(lpb - lpa);
    d w / d dt = +(cp - t)_xy / (|(cp - t)_xy| (max - min))  (z component 0).
    Returns (residual (..., 3), J (..., 3, 6))."""
    u = se3.quat_rotate(pose.q, cp)            # R cp
    lp = u + pose.t
    nu = se3.cross(lp - lpa, lp - lpb)
    de_norm = torch.clamp(torch.linalg.norm(lpa - lpb, dim=-1, keepdim=True),
                          min=1e-12)
    f = nu / de_norm                           # (..., 3)

    cp_l = cp - pose.t
    d = torch.sqrt(torch.clamp(cp_l[..., 0] ** 2 + cp_l[..., 1] ** 2,
                               min=1e-12))
    inv_span = 1.0 / (max_range - min_range)
    w = (1.01 - (d - min_range) * inv_span)[..., None]    # (..., 1)

    r = w * f
    df_dlp = _skew(lpb - lpa) / de_norm[..., None]         # (..., 3, 3)
    dr_dtheta = w[..., None] * (df_dlp @ (-_skew(u)))
    dw_dt = torch.stack([cp_l[..., 0] / d * inv_span,
                         cp_l[..., 1] / d * inv_span,
                         torch.zeros_like(d)], dim=-1)      # (..., 3)
    dr_dt = w[..., None] * df_dlp + f[..., :, None] * dw_dt[..., None, :]
    return r, torch.cat([dr_dtheta, dr_dt], dim=-1)


def point_to_point_residual(pose: Pose, cp: torch.Tensor,
                            mp: torch.Tensor) -> torch.Tensor:
    """Point2PointFactor residual (factors.hpp:29-61): ``R cp + t - mp``.
    The reference declares it but never adds it; kept for parity."""
    return se3.quat_rotate(pose.q, cp) + pose.t - mp


def point_to_point_jacobian(pose: Pose, cp: torch.Tensor, mp: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual + Jacobian of the point-to-point factor (same retraction)."""
    u = se3.quat_rotate(pose.q, cp)
    r = u + pose.t - mp
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(
        r.shape[:-1] + (3, 3))
    return r, torch.cat([-_skew(u), eye], dim=-1)


def huber_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight rho'(s) for Ceres HuberLoss(delta): 1 inside, delta/sqrt(s)
    outside (laser_odometry.cc:201)."""
    s = torch.clamp(sq_norm, min=1e-20)
    return torch.where(s <= delta * delta, torch.ones_like(s),
                       delta / torch.sqrt(s))


def huber_cost(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """rho(s) for HuberLoss: s inside, 2 delta sqrt(s) - delta^2 outside."""
    d2 = delta * delta
    return torch.where(sq_norm <= d2, sq_norm,
                       2.0 * delta * torch.sqrt(torch.clamp(sq_norm, min=0.0))
                       - d2)


class NormalEquations(NamedTuple):
    JtJ: torch.Tensor   # (..., 6, 6)
    Jtr: torch.Tensor   # (..., 6)
    cost: torch.Tensor  # (...) robust cost 0.5 * sum rho(|r|^2)


def _per_point(pose: Pose) -> Pose:
    """A pose (..., 4)/(..., 3) broadcast over the points (..., E, 3)."""
    return Pose(pose.q[..., None, :], pose.t[..., None, :])


def build_normal_equations(pose: Pose, cp: torch.Tensor, lpa: torch.Tensor,
                           lpb: torch.Tensor, valid: torch.Tensor,
                           min_range: float, max_range: float,
                           huber_delta: float) -> NormalEquations:
    """Huber-weighted Gauss-Newton normal equations over all correspondences
    (plain sums over residual blocks): pose (...,), cp (..., E, 3)."""
    r, J = point_to_line_jacobian(_per_point(pose), cp, lpa, lpb, min_range,
                                  max_range)
    s = (r * r).sum(dim=-1)
    v = valid.to(r.dtype)
    wi = huber_weight(s, huber_delta) * v
    # products, then plain sums over the E*3 rows: as a matrix product with
    # a batch dimension (6 x 3E times 3E x 6) cuBLAS ran it as a 0.28 ms
    # small-N kernel on the card, slower than the whole solve around it
    Jw = J * wi[..., None, None]
    JtJ = (Jw[..., :, None] * J[..., None, :]).sum(dim=(-4, -3))
    Jtr = (Jw * r[..., None]).sum(dim=(-3, -2))
    cost = 0.5 * (huber_cost(s, huber_delta) * v).sum(dim=-1)
    return NormalEquations(JtJ, Jtr, cost)


def robust_cost(pose: Pose, cp, lpa, lpb, valid, min_range, max_range,
                huber_delta) -> torch.Tensor:
    r = point_to_line_residual(_per_point(pose), cp, lpa, lpb, min_range,
                               max_range)
    s = (r * r).sum(dim=-1)
    return 0.5 * (huber_cost(s, huber_delta) * valid.to(r.dtype)).sum(dim=-1)


def lm_solve(pose0: Pose, cp: torch.Tensor, lpa: torch.Tensor,
             lpb: torch.Tensor, valid: torch.Tensor, *, min_range: float,
             max_range: float, huber_delta: float = 0.2, iters: int = 4,
             init_lambda: float = 1e-4) -> Pose:
    """Levenberg-Marquardt on the SE(3) tangent: ``iters`` damped steps
    (laser_odometry.cc:214) with correspondences fixed; a step is kept when
    it lowers the robust cost (lambda x 0.5), else dropped (lambda x 4).
    A batch of poses (B, 4)/(B, 3) with correspondences (B, E, ...) is B
    independent solves, each with its own damping and accept."""
    dtype, dev = pose0.t.dtype, pose0.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    q, t = pose0.q, pose0.t
    lam = torch.full(t.shape[:-1], init_lambda, dtype=dtype, device=dev)
    cost = build_normal_equations(pose0, cp, lpa, lpb, valid, min_range,
                                  max_range, huber_delta).cost
    for _ in range(iters):
        pose = Pose(q, t)
        ne = build_normal_equations(pose, cp, lpa, lpb, valid, min_range,
                                    max_range, huber_delta)
        # damped system: (JtJ + lam * diag(JtJ) + eps I) delta = -Jtr
        diag = torch.diag_embed(torch.diagonal(ne.JtJ, dim1=-2, dim2=-1))
        damped = ne.JtJ + lam[..., None, None] * diag + 1e-8 * eye6
        delta = torch.linalg.solve_ex(damped, -ne.Jtr[..., None])[0][..., 0]
        cand = se3.retract(pose, delta)
        new_cost = robust_cost(cand, cp, lpa, lpb, valid, min_range,
                               max_range, huber_delta)
        accept = new_cost < cost
        q = torch.where(accept[..., None], cand.q, q)
        t = torch.where(accept[..., None], cand.t, t)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return Pose(q, t)
