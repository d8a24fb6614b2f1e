"""One odometry frame: the exact 5-NN in the matching map, the line test,
the Huber LM solve and the sliding window (plain PyTorch)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import features
from benchmark.reference.linalg import (Pose, compose, inverse, mm, retract,
                                        rotation, transform)


class Params(NamedTuple):
    """What a frame's solve and selection read of the configuration."""
    scan_lines: int
    scan_regions: int
    edges_per_region: int
    smoothness_threshold: float
    neighbor_gap_sq: float
    local_map_size: int
    knn_k: int
    knn_max_sq_dist: float
    eig_ratio: float
    min_line_sep: float
    outer_iters: int
    inner_iters: int
    huber_delta: float
    min_range: float
    max_range: float
    ring_width: int

    @staticmethod
    def of(config: dict) -> "Params":
        return Params(**{k: config[k] for k in Params._fields})

    @property
    def edge_slots(self) -> int:
        return self.scan_lines * self.scan_regions * (
            self.edges_per_region + 1)


class Window(NamedTuple):
    """The last ``window`` frames' edges at their solved poses."""
    xyz: torch.Tensor        # (K, E, 3)
    valid: torch.Tensor      # (K, E)
    next_slot: int
    nframes: int


class State(NamedTuple):
    window: Window
    odom: Pose
    prev: Pose
    received_xyz: torch.Tensor    # (M, 3) the local map received last
    received_valid: torch.Tensor  # (M,)


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, block: int = 512
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest refs of each query by brute force: (d2 (E, k)
    ascending, index (E, k)); equal distances in ref order.  d2 is
    ``dx*dx + dy*dy + dz*dz`` left to right."""
    d2s, ids = [], []
    for q0 in range(0, query.shape[0], block):
        diff = query[q0:q0 + block, None, :] - ref[None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
              + diff[..., 2] * diff[..., 2])
        top = torch.topk(d2, min(k + 4, d2.shape[1]), dim=1, largest=False)
        # order the candidates by (d2, index): ties go to the lower ref
        key = torch.sort(top.indices, dim=1).values
        kd = torch.gather(d2, 1, key)
        order = torch.sort(kd, dim=1, stable=True).indices[:, :k]
        ids.append(torch.gather(key, 1, order))
        d2s.append(torch.gather(kd, 1, order))
    return torch.cat(d2s), torch.cat(ids)


def sym3_eigenvalues(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric (..., 3, 3), closed form."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p = torch.sqrt(torch.clamp(((a00 - q) ** 2 + (a11 - q) ** 2
                                + (a22 - q) ** 2 + 2.0 * p1) / 6.0, min=0.0))
    sp = torch.where(p > 0, p, torch.ones_like(p))
    b00, b11, b22 = (a00 - q) / sp, (a11 - q) / sp, (a22 - q) / sp
    b01, b02, b12 = a01 / sp, a02 / sp, a12 / sp
    det = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    eigs = torch.stack([lo, 3.0 * q - hi - lo, hi], -1)
    return torch.where((p > 0)[..., None], eigs, q[..., None].expand_as(eigs))


def lines(edges_w: torch.Tensor, emask: torch.Tensor, map_xyz: torch.Tensor,
          prm: Params, precision: str
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The line under each edge (laser_odometry.cc:318-357): its k nearest
    map points; kept when the k-th is within ``knn_max_sq_dist``, the
    neighbourhood's largest scatter eigenvalue exceeds ``eig_ratio`` times
    the middle one and the two nearest are ``min_line_sep`` apart.
    Returns (the nearest, the second nearest, kept)."""
    k = prm.knn_k
    d2, idx = knn(edges_w, map_xyz, k)
    near = map_xyz[idx]                                   # (E, k, 3)
    zm = near - near.mean(dim=1, keepdim=True)
    cov = mm(zm.transpose(1, 2), zm, precision)
    eig = sym3_eigenvalues(cov)
    sep = ((near[:, 0] - near[:, 1]) ** 2).sum(-1)
    ok = (emask & (d2[:, k - 1] < prm.knn_max_sq_dist)
          & (eig[:, 2] > prm.eig_ratio * eig[:, 1])
          & (sep > prm.min_line_sep ** 2))
    return near[:, 0], near[:, 1], ok


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _huber(s: torch.Tensor, delta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho(s), rho'(s)) of HuberLoss(delta) at squared norms s."""
    inside = s <= delta * delta
    root = torch.sqrt(torch.clamp(s, min=1e-20))
    return (torch.where(inside, s, 2.0 * delta * root - delta * delta),
            torch.where(inside, torch.ones_like(s), delta / root))


def _residuals(pose: Pose, cp, lpa, lpb, prm: Params, precision: str,
               jacobian: bool):
    """Point2LineFactor (factors.hpp:71-105): r = w (lp - a) x (lp - b) /
    |a - b|, lp = R cp + t, w = 1.01 - (|(cp - t)_xy| - min) / (max -
    min); with ``jacobian`` also dr/d(dtheta, dt) (E, 3, 6)."""
    u = mm(cp, rotation(pose.q).T, precision)
    lp = u + pose.t
    norm = torch.clamp(torch.linalg.norm(lpa - lpb, dim=-1, keepdim=True),
                       min=1e-12)
    f = torch.linalg.cross(lp - lpa, lp - lpb, dim=-1) / norm
    rel = cp - pose.t
    d = torch.sqrt(torch.clamp(rel[:, 0] ** 2 + rel[:, 1] ** 2, min=1e-12))
    span = prm.max_range - prm.min_range
    w = (1.01 - (d - prm.min_range) / span)[:, None]
    r = w * f
    if not jacobian:
        return r, None
    dfdl = _skew(lpb - lpa) / norm[..., None]
    dtheta = w[..., None] * mm(dfdl, -_skew(u), precision)
    dwdt = torch.stack([rel[:, 0] / d / span, rel[:, 1] / d / span,
                        torch.zeros_like(d)], -1)
    dt = w[..., None] * dfdl + f[:, :, None] * dwdt[:, None, :]
    return r, torch.cat([dtheta, dt], -1)


def _cost(pose, cp, lpa, lpb, ok, prm, precision) -> torch.Tensor:
    r, _ = _residuals(pose, cp, lpa, lpb, prm, precision, False)
    rho, _ = _huber((r * r).sum(-1), prm.huber_delta)
    return 0.5 * (rho * ok).sum()


def lm_solve(pose: Pose, cp, lpa, lpb, ok, prm: Params, precision: str
             ) -> Pose:
    """``inner_iters`` damped Gauss-Newton steps with IRLS Huber weights,
    each kept when it lowers the robust cost (damping x 0.5) and dropped
    otherwise (x 4), from damping 1e-4 (laser_odometry.cc:196-228)."""
    okf = ok.to(cp.dtype)
    lam = 1e-4
    cost = _cost(pose, cp, lpa, lpb, okf, prm, precision)
    eye = torch.eye(6, dtype=cp.dtype, device=cp.device)
    for _ in range(prm.inner_iters):
        r, jac = _residuals(pose, cp, lpa, lpb, prm, precision, True)
        _, wt = _huber((r * r).sum(-1), prm.huber_delta)
        wt = wt * okf
        jf = jac.reshape(-1, 6)
        jw = (jac * wt[:, None, None]).reshape(-1, 6)
        jtj = mm(jw.T, jf, precision)
        jtr = mm(jw.T, r.reshape(-1, 1), precision)[:, 0]
        damped = jtj + lam * torch.diag(torch.diagonal(jtj)) + 1e-8 * eye
        delta = torch.linalg.solve(damped, -jtr)
        cand = retract(pose, delta)
        new_cost = _cost(cand, cp, lpa, lpb, okf, prm, precision)
        if bool(new_cost < cost):
            pose, cost, lam = cand, new_cost, lam * 0.5
        else:
            lam = lam * 4.0
    return pose


def matching_map(state: State) -> torch.Tensor:
    """The window's live edges and the received local map's rows."""
    w = state.window
    live = w.valid & (torch.arange(w.xyz.shape[0], device=w.xyz.device)
                      < w.nframes)[:, None]
    pts = w.xyz[live]
    if state.received_xyz.shape[0]:
        pts = torch.cat([pts, state.received_xyz[state.received_valid]])
    return pts


def frame_edges(raw: torch.Tensor, prm: Params
                ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, int]:
    """A spin's edge slots (E, 3) on its device, their mask, the split's
    counts (64,) and the points it dropped past the ring width."""
    img, counts, dropped = features.split_velodyne(
        raw.cpu().numpy(), prm.ring_width, prm.min_range, prm.max_range)
    dev = raw.device
    xyz = torch.as_tensor(img, device=dev)
    cnt = torch.as_tensor(counts, device=dev)
    sm = features.smoothness(xyz, cnt)
    ex, ev = features.select_edges(xyz, cnt, sm, prm.scan_regions,
                                   prm.edges_per_region,
                                   prm.smoothness_threshold,
                                   prm.neighbor_gap_sq)
    return ex, ev, counts, dropped


def solve(state: State, exyz: torch.Tensor, evalid: torch.Tensor,
          prm: Params, precision: str) -> Pose:
    """The frame's pose: the constant-velocity prediction
    (laser_odometry.cc:148-150), then ``outer_iters`` x (the lines under
    the edges at the current pose, the LM solve)."""
    pose = compose(state.odom, compose(inverse(state.prev, precision),
                                       state.odom, precision), precision)
    map_xyz = matching_map(state)
    cp = exyz[evalid]
    for _ in range(prm.outer_iters):
        if map_xyz.shape[0] == 0 or cp.shape[0] == 0:
            break
        lpa, lpb, ok = lines(transform(pose, cp, precision),
                             torch.ones(cp.shape[0], dtype=torch.bool,
                                        device=cp.device),
                             map_xyz, prm, precision)
        pose = lm_solve(pose, cp, lpa, lpb, ok, prm, precision)
    return pose


def push(window: Window, edges_w: torch.Tensor, evalid: torch.Tensor
         ) -> Window:
    """The frame's edges, valid ones first in slot order, into the
    oldest slot (LocalMapManager::addPointCloud, laser_odometry.cc:34-60).
    """
    k, e = window.valid.shape
    order = torch.argsort((~evalid).to(torch.uint8), stable=True)
    v = evalid[order]
    x = torch.where(v[:, None], edges_w[order], torch.zeros_like(edges_w))
    xyz, valid = window.xyz.clone(), window.valid.clone()
    xyz[window.next_slot], valid[window.next_slot] = x, v
    return Window(xyz, valid, (window.next_slot + 1) % k,
                  min(window.nframes + 1, k))


def step(state: State, raw: torch.Tensor, prm: Params, precision: str,
         received: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """A whole frame from a raw spin: (next state, pose, edges count, split
    counts).  ``received``: the local map handed over after this frame."""
    ex, ev, counts, _ = frame_edges(raw, prm)
    pose = solve(state, ex, ev, prm, precision)
    window = push(state.window, transform(pose, ex, precision), ev)
    rx, rv = received if received is not None else (state.received_xyz,
                                                     state.received_valid)
    return (State(window, pose, state.odom, rx, rv), pose, int(ev.sum()),
            counts)


def init_state(prm: Params, edge_slots: int, device,
               received_rows: int = 0) -> State:
    ident = Pose(torch.tensor([1.0, 0, 0, 0], device=device),
                 torch.zeros(3, device=device))
    k = prm.local_map_size
    return State(Window(torch.zeros((k, edge_slots, 3), device=device),
                        torch.zeros((k, edge_slots), dtype=torch.bool,
                                    device=device), 0, 0),
                 ident, ident, torch.zeros((received_rows, 3), device=device),
                 torch.zeros(received_rows, dtype=torch.bool, device=device))
