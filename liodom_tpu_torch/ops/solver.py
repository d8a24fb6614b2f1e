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
  solve is enqueued without a host synchronisation;
* with a process group the correspondences may be split over its members,
  whose sums are all-reduced (the JAX package's ``axis_name`` psum).

:func:`lm_solve` dispatches: CUDA tensors launch ``csrc/lm_solve.cu``
(:func:`lm_solve_cuda`, every round of every lane in one launch); CPU
tensors and a call with a process group take :func:`lm_solve_plain`.

The residual follows factors.hpp:71-105, including the distance weight
``w = 1.01 - d_norm`` whose dependence on ``t`` enters the Jacobian.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from liodom_tpu_torch import kernels
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


def _all_reduce_equations(ne: NormalEquations, group) -> NormalEquations:
    """JtJ, Jtr and cost summed over ``group`` (the JAX package's psum of
    each, ``solver.py:192-198``), packed into one collective."""
    flat = torch.cat([ne.JtJ.flatten(-2), ne.Jtr, ne.cost[..., None]], -1)
    dist.all_reduce(flat, group=group)
    return NormalEquations(flat[..., :36].unflatten(-1, (6, 6)),
                           flat[..., 36:42], flat[..., 42])


def lm_solve_plain(pose0: Pose, cp: torch.Tensor, lpa: torch.Tensor,
                   lpb: torch.Tensor, valid: torch.Tensor, *, min_range: float,
                   max_range: float, huber_delta: float = 0.2, iters: int = 4,
                   init_lambda: float = 1e-4, group=None) -> Pose:
    """Levenberg-Marquardt on the SE(3) tangent: ``iters`` damped steps
    (laser_odometry.cc:214) with correspondences fixed; a step is kept when
    it lowers the robust cost (lambda x 0.5), else dropped (lambda x 4).
    A batch of poses (B, 4)/(B, 3) with correspondences (B, E, ...) is B
    independent solves, each with its own damping and accept.

    ``group``: a ``torch.distributed`` process group over which the
    correspondences are split (the edge-sharded multi-card solve): the
    normal equations, the costs and each candidate's cost are summed over it
    (``solver.py:186-213``), so every member takes the same steps."""
    dtype, dev = pose0.t.dtype, pose0.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    q, t = pose0.q, pose0.t
    lam = torch.full(t.shape[:-1], init_lambda, dtype=dtype, device=dev)
    ne = build_normal_equations(pose0, cp, lpa, lpb, valid, min_range,
                                max_range, huber_delta)
    if group is not None:
        ne = _all_reduce_equations(ne, group)
    cost = ne.cost
    for _ in range(iters):
        pose = Pose(q, t)
        ne = build_normal_equations(pose, cp, lpa, lpb, valid, min_range,
                                    max_range, huber_delta)
        if group is not None:
            ne = _all_reduce_equations(ne, group)
        # damped system: (JtJ + lam * diag(JtJ) + eps I) delta = -Jtr
        diag = torch.diag_embed(torch.diagonal(ne.JtJ, dim1=-2, dim2=-1))
        damped = ne.JtJ + lam[..., None, None] * diag + 1e-8 * eye6
        delta = torch.linalg.solve_ex(damped, -ne.Jtr[..., None])[0][..., 0]
        cand = se3.retract(pose, delta)
        new_cost = robust_cost(cand, cp, lpa, lpb, valid, min_range,
                               max_range, huber_delta)
        if group is not None:
            dist.all_reduce(new_cost, group=group)
        accept = new_cost < cost
        q = torch.where(accept[..., None], cand.q, q)
        t = torch.where(accept[..., None], cand.t, t)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return Pose(q, t)


_SIG = [("liodom_lm_solve", [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                    ctypes.c_void_p]
         + [ctypes.c_int] * 3 + [ctypes.c_float] * 7
         + [ctypes.c_void_p] * 3),
        ("liodom_lm_solve_shape", [ctypes.c_int, ctypes.c_void_p])]


def _row_stride(x: torch.Tensor):
    """The floats between the rows of ``x`` (..., E, 3) when they are 3
    floats each at one stride of at least 3, the leading dimensions packed
    over them (the line fit's ``near[..., 0, :]`` of a contiguous (..., E,
    k, 3) is, at 3 k); else None."""
    dims = list(zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])))
    stride = next((step for size, step in dims if size > 1), 3)
    want = stride
    for size, step in dims:
        if size > 1 and step != want:
            return None
        want *= size
    return stride if x.stride(-1) == 1 and stride >= 3 else None


def _check_solve_args(pose0: Pose, cp, lpa, lpb, valid) -> None:
    """What ``csrc/lm_solve.cu`` takes: float32 poses ``(..., 4)`` /
    ``(..., 3)``, float32 ``cp``, ``lpa``, ``lpb`` ``(..., E, 3)`` and a
    bool ``valid`` ``(..., E)`` with the poses' leading dimensions, on one
    CUDA device; the poses, ``cp`` and ``valid`` contiguous, ``lpa`` and
    ``lpb`` rows of one stride (the kNN's neighbours in place); raises on
    anything else."""
    q0, t0 = pose0
    floats = (q0, t0, cp, lpa, lpb)
    if any(x.dtype != torch.float32 for x in floats) or \
            valid.dtype != torch.bool:
        raise TypeError("lm_solve_cuda takes float32 poses and "
                        "correspondences and a bool valid, got "
                        f"{[x.dtype for x in floats + (valid,)]}")
    lead = t0.shape[:-1]
    if (t0.shape[-1:] != (3,) or q0.shape != lead + (4,)
            or cp.ndim != len(lead) + 2 or cp.shape[:-2] != lead
            or cp.shape[-1] != 3 or lpa.shape != cp.shape
            or lpb.shape != cp.shape or valid.shape != cp.shape[:-1]):
        raise ValueError(
            f"lm_solve_cuda shapes: q {tuple(q0.shape)}, t {tuple(t0.shape)}, "
            f"cp {tuple(cp.shape)}, lpa {tuple(lpa.shape)}, lpb "
            f"{tuple(lpb.shape)}, valid {tuple(valid.shape)}")
    stride = _row_stride(lpa)
    if not (all(x.is_contiguous() for x in (q0, t0, cp, valid))
            and stride is not None and _row_stride(lpb) == stride):
        raise ValueError("lm_solve_cuda needs contiguous poses, cp and "
                         "valid, and lpa and lpb as rows of one stride")
    if not (t0.is_cuda and all(x.device == t0.device
                               for x in floats + (valid,))):
        raise ValueError("lm_solve_cuda needs every tensor on one CUDA "
                         "device")


def lm_solve_cuda(pose0: Pose, cp: torch.Tensor, lpa: torch.Tensor,
                  lpb: torch.Tensor, valid: torch.Tensor, *, min_range: float,
                  max_range: float, huber_delta: float = 0.2, iters: int = 4,
                  init_lambda: float = 1e-4) -> Pose:
    """:func:`lm_solve_plain` in one launch of ``csrc/lm_solve.cu`` (one
    thread-block cluster a lane, every round on the card): the same
    float32 expressions, the sums over edges in another, fixed order, so
    the same inputs give the same bits on every run.  On the current
    stream, without a host synchronisation; the pose is new tensors."""
    _check_solve_args(pose0, cp, lpa, lpb, valid)
    q0, t0 = pose0
    q = torch.empty_like(q0)
    t = torch.empty_like(t0)
    b, e = t0.numel() // 3, cp.shape[-2]
    if b == 0:
        return Pose(q, t)
    span = max_range - min_range
    lib = kernels.load("lm_solve", _SIG)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_lm_solve(
            q0.data_ptr(), t0.data_ptr(), cp.data_ptr(), lpa.data_ptr(),
            lpb.data_ptr(), _row_stride(lpa), valid.data_ptr(), b, e, iters,
            init_lambda, min_range, 1.0 / span, span, huber_delta,
            huber_delta * huber_delta, 2.0 * huber_delta, q.data_ptr(),
            t.data_ptr(), stream)
    kernels.check(err, "liodom_lm_solve")
    lm_solve_cuda.launches += 1
    return Pose(q, t)


lm_solve_cuda.launches = 0


def lm_solve_shape(e: int) -> dict:
    """The built kernel's launch for ``e`` edges a lane: blocks in a lane's
    cluster, threads a block, a block's share of the edges, the edges it
    keeps in shared memory, its dynamic shared memory in bytes."""
    lib = kernels.load("lm_solve", _SIG)
    out = (ctypes.c_int * 5)()
    kernels.check(lib.liodom_lm_solve_shape(e, ctypes.addressof(out)),
                  "liodom_lm_solve_shape")
    return dict(zip(("cluster", "threads", "share", "cached", "smem_bytes"),
                    out))


def lm_solve(pose0: Pose, cp: torch.Tensor, lpa: torch.Tensor,
             lpb: torch.Tensor, valid: torch.Tensor, *, min_range: float,
             max_range: float, huber_delta: float = 0.2, iters: int = 4,
             init_lambda: float = 1e-4, group=None) -> Pose:
    """The LM solve of :func:`lm_solve_plain` on the tensors' device: on
    CUDA one launch of ``csrc/lm_solve.cu``; on the CPU, and with a
    ``group`` (whose sums are all-reduced between rounds, which no kernel
    can wait for), the plain version."""
    kw = dict(min_range=min_range, max_range=max_range,
              huber_delta=huber_delta, iters=iters, init_lambda=init_lambda)
    if group is not None:
        return lm_solve_plain(pose0, cp, lpa, lpb, valid, group=group, **kw)
    if pose0.t.is_cuda:
        return lm_solve_cuda(pose0, cp, lpa, lpb, valid, **kw)
    kernels.require_cpu(pose0.t, "lm_solve")
    return lm_solve_plain(pose0, cp, lpa, lpb, valid, **kw)
