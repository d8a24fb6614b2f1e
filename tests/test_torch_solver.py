"""Port parity: the point-to-line solver.

Residuals, Jacobians, Huber weights and costs, normal equations and the
4-iteration LM solve go through ``liodom_tpu.ops.solver`` and its port on
the same float32 inputs (1e-5: float32 reassociation of 6x6 sums over a
few hundred rows).  The LM solve is also held against the float64 oracle
``golden_lm_solve`` (tests/golden.py), at the float32 scale of the solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.pose import Pose as JPose
from liodom_tpu.ops import solver as JS

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.ops import solver as S

from golden import GoldenPose, golden_lm_solve

torch.set_num_threads(1)

MIN_R, MAX_R = 3.0, 75.0


def _problem(seed=0, n=300, noise=0.02):
    """Edges seen from a known pose, matched to lines through their true
    world positions, plus a perturbed starting pose."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(5, 60, n)
    cp = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                   rng.uniform(-2, 4, n)], -1).astype(np.float32)
    q_true = np.array([0.995, 0.02, -0.03, 0.09])
    q_true /= np.linalg.norm(q_true)
    t_true = np.array([1.2, -0.4, 0.1])
    gp = GoldenPose(q_true, t_true)
    world = gp.transform(cp.astype(np.float64))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    off = rng.normal(size=(n, 3)) * noise
    lpa = (world + off + 0.3 * d).astype(np.float32)
    lpb = (world + off - 0.4 * d).astype(np.float32)
    valid = rng.random(n) > 0.1
    q0 = np.array([1.0, 0.0, 0.0, 0.05], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = np.array([1.0, -0.2, 0.0], np.float32)
    return dict(cp=cp, lpa=lpa, lpb=lpb, valid=valid, q=q0.astype(np.float32),
                t=t0)


def _both(p):
    j = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return (JPose(j["q"], j["t"]), j), (Pose(t["q"], t["t"]), t)


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_and_jacobian_match_jax(seed):
    (jp, j), (tp, t) = _both(_problem(seed))
    want_r = JS.point_to_line_residual(jp, j["cp"], j["lpa"], j["lpb"],
                                       MIN_R, MAX_R)
    got_r = S.point_to_line_residual(tp, t["cp"], t["lpa"], t["lpb"],
                                     MIN_R, MAX_R)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-5,
                               atol=1e-5)
    wr, wJ = JS.point_to_line_jacobian(jp, j["cp"], j["lpa"], j["lpb"],
                                       MIN_R, MAX_R)
    gr, gJ = S.point_to_line_jacobian(tp, t["cp"], t["lpa"], t["lpb"],
                                      MIN_R, MAX_R)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gJ.numpy(), np.asarray(wJ), rtol=1e-5,
                               atol=1e-5)


def test_point_to_point_matches_jax():
    (jp, j), (tp, t) = _both(_problem(2))
    wr, wJ = JS.point_to_point_jacobian(jp, j["cp"], j["lpa"])
    gr, gJ = S.point_to_point_jacobian(tp, t["cp"], t["lpa"])
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)
    np.testing.assert_allclose(gJ.numpy(), np.asarray(wJ), atol=1e-5)
    np.testing.assert_allclose(
        S.point_to_point_residual(tp, t["cp"], t["lpa"]).numpy(),
        np.asarray(JS.point_to_point_residual(jp, j["cp"], j["lpa"])),
        atol=1e-5)


def test_huber_matches_jax():
    s = np.concatenate([np.linspace(0, 0.1, 50), np.logspace(-3, 3, 50),
                        [0.04, 0.0]]).astype(np.float32)
    for fj, ft in ((JS.huber_weight, S.huber_weight),
                   (JS.huber_cost, S.huber_cost)):
        np.testing.assert_allclose(ft(torch.from_numpy(s), 0.2).numpy(),
                                   np.asarray(fj(jnp.asarray(s), 0.2)),
                                   rtol=1e-6, atol=1e-7)


def test_normal_equations_match_jax():
    (jp, j), (tp, t) = _both(_problem(3))
    want = JS.build_normal_equations(jp, j["cp"], j["lpa"], j["lpb"],
                                     j["valid"], MIN_R, MAX_R, 0.2)
    got = S.build_normal_equations(tp, t["cp"], t["lpa"], t["lpb"],
                                   t["valid"], MIN_R, MAX_R, 0.2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    np.testing.assert_allclose(
        S.robust_cost(tp, t["cp"], t["lpa"], t["lpb"], t["valid"], MIN_R,
                      MAX_R, 0.2).numpy(),
        np.asarray(JS.robust_cost(jp, j["cp"], j["lpa"], j["lpb"],
                                  j["valid"], MIN_R, MAX_R, 0.2)),
        rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_lm_solve_matches_jax_and_golden(seed):
    p = _problem(seed)
    (jp, j), (tp, t) = _both(p)
    want = JS.lm_solve(jp, j["cp"], j["lpa"], j["lpb"], j["valid"],
                       min_range=MIN_R, max_range=MAX_R)
    got = S.lm_solve(tp, t["cp"], t["lpa"], t["lpb"], t["valid"],
                     min_range=MIN_R, max_range=MAX_R)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-5)
    v = p["valid"]
    g = golden_lm_solve(GoldenPose(p["q"], p["t"]), p["cp"][v], p["lpa"][v],
                        p["lpb"][v], min_range=MIN_R, max_range=MAX_R)
    sign = np.sign(np.dot(g.q, got.q.numpy()))
    np.testing.assert_allclose(got.q.numpy() * sign, g.q, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), g.t, atol=1e-3)
    # the solve moved the pose (the comparison is not vacuous)
    assert np.linalg.norm(got.t.numpy() - p["t"]) > 0.05


def test_lm_solve_without_correspondences_holds_the_pose():
    p = _problem(5)
    p["valid"][:] = False
    _, (tp, t) = _both(p)
    got = S.lm_solve(tp, t["cp"], t["lpa"], t["lpb"], t["valid"],
                     min_range=MIN_R, max_range=MAX_R)
    np.testing.assert_array_equal(got.q.numpy(), p["q"])
    np.testing.assert_array_equal(got.t.numpy(), p["t"])


# ---- csrc/lm_solve.cu: the dispatch, the wrapper's checks, its arithmetic

def _lane(seed=1, n=300):
    p = _problem(seed, n)
    _, (tp, t) = _both(p)
    return tp, t["cp"], t["lpa"], t["lpb"], t["valid"]


@pytest.mark.parametrize("case, error, match", [
    ("float64", TypeError, "float32"),
    ("int valid", TypeError, "bool"),
    ("short q", ValueError, "shapes"),
    ("lpb rows", ValueError, "shapes"),
    ("valid rows", ValueError, "shapes"),
    ("strided cp", ValueError, "contiguous"),
    ("lpa and lpb apart", ValueError, "one stride"),
    ("overlapping rows", ValueError, "one stride"),
    ("cpu", ValueError, "CUDA"),
])
def test_lm_solve_cuda_refuses_what_the_kernel_does_not_take(case, error,
                                                            match):
    """Every check raises before anything is launched; the CPU tensors of
    the last case pass every other check, and so do lpa and lpb as the
    rows of one (E, k, 3) tensor (the line fit's neighbours in place)."""
    pose, cp, lpa, lpb, valid = _lane()
    if case == "float64":
        cp = cp.double()
    elif case == "int valid":
        valid = valid.int()
    elif case == "short q":
        pose = Pose(pose.q[:3], pose.t)
    elif case == "lpb rows":
        lpb = lpb[:-1]
    elif case == "valid rows":
        valid = valid[None]
    elif case == "strided cp":
        cp = torch.cat([cp, cp], -1)[:, ::2]
    elif case == "lpa and lpb apart":
        lpa = torch.stack([lpa, lpb], -2)[..., 0, :]
    elif case == "overlapping rows":
        flat = lpa.flatten()
        lpa = flat.as_strided(lpa.shape, (2, 1))
        lpb = flat.as_strided(lpb.shape, (2, 1))
    elif case == "cpu":
        near = torch.stack([lpa, lpb, lpa, lpb, lpa], -2)
        lpa, lpb = near[..., 0, :], near[..., 1, :]
    before = S.kernels.launch_counts()
    with pytest.raises(error, match=match):
        S.lm_solve_cuda(pose, cp, lpa, lpb, valid, min_range=MIN_R,
                        max_range=MAX_R)
    assert S.kernels.launch_counts() == before


def test_lm_solve_takes_the_plain_version_on_the_cpu_and_with_a_group(
        monkeypatch):
    """CPU tensors, and a call with a process group (the edge-sharded
    solve, here one member whose all-reduce is the identity), take
    ``lm_solve_plain``: the same bits, no launch."""
    def refuse(*a, **k):
        raise AssertionError("lm_solve_cuda called")

    pose, cp, lpa, lpb, valid = _lane()
    kw = dict(min_range=MIN_R, max_range=MAX_R)
    want = S.lm_solve_plain(pose, cp, lpa, lpb, valid, **kw)
    before = S.kernels.launch_counts()
    monkeypatch.setattr(S, "lm_solve_cuda", refuse)
    got = S.lm_solve(pose, cp, lpa, lpb, valid, **kw)
    assert torch.equal(got.q, want.q) and torch.equal(got.t, want.t)
    reduced = []
    monkeypatch.setattr(S.dist, "all_reduce",
                        lambda x, group=None: reduced.append(group))
    group = object()
    got = S.lm_solve(pose, cp, lpa, lpb, valid, group=group, **kw)
    assert torch.equal(got.q, want.q) and torch.equal(got.t, want.t)
    assert reduced and all(g is group for g in reduced)
    monkeypatch.undo()
    assert S.kernels.launch_counts() == before
    with pytest.raises(ValueError, match="no kernel"):
        S.lm_solve(Pose(pose.q.to("meta"), pose.t.to("meta")), cp, lpa, lpb,
                   valid, **kw)


def test_path_kernels_build_and_load_lm_solve():
    from liodom_tpu_torch import kernels
    from liodom_tpu_torch.runtime import device_io as DIO
    assert "lm_solve" in kernels.SOURCES
    for mapping in (False, True):
        assert "lm_solve" in DIO.path_kernels(mapping)
        # the sharded steps' solve all-reduces between rounds: plain
        assert "lm_solve" not in DIO.path_kernels(mapping, sharded=True)


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def _model_rows(pose, cp, lpa, lpb):
    """The kernel's residual and Jacobian rows: its pose-independent terms
    (de_norm, g = (lpb - lpa) / de_norm) and df_dlp (-skew(u)) with the
    zero terms left out."""
    dvec = lpa - lpb
    de = torch.clamp(torch.sqrt((dvec[:, 0] * dvec[:, 0] + dvec[:, 1]
                                 * dvec[:, 1]) + dvec[:, 2] * dvec[:, 2]),
                     min=1e-12)
    g0, g1, g2 = ((lpb - lpa) / de[:, None]).unbind(-1)
    u = se3.quat_rotate(pose.q, cp)
    ux, uy, uz = u.unbind(-1)
    nu = se3.cross(u + pose.t - lpa, u + pose.t - lpb)
    f = nu / de[:, None]
    cl = cp - pose.t
    d = torch.sqrt(torch.clamp(cl[:, 0] * cl[:, 0] + cl[:, 1] * cl[:, 1],
                               min=1e-12))
    inv_span = _f(1.0 / (MAX_R - MIN_R))
    w = _f(1.01) - (d - _f(MIN_R)) * inv_span
    dwx, dwy = cl[:, 0] / d * inv_span, cl[:, 1] / d * inv_span
    fx, fy, fz = f.unbind(-1)
    z = torch.zeros_like(w)
    J = torch.stack([
        torch.stack([w * (g2 * uz + g1 * uy), w * -(g1 * ux), w * -(g2 * ux),
                     fx * dwx, w * -g2 + fx * dwy, w * g1 + fx * z], -1),
        torch.stack([w * -(g0 * uy), w * (g2 * uz + g0 * ux), w * -(g2 * uy),
                     w * g2 + fy * dwx, fy * dwy, w * -g0 + fy * z], -1),
        torch.stack([w * -(g0 * uz), w * -(g1 * uz), w * (g1 * uy + g0 * ux),
                     w * -g1 + fz * dwx, w * g0 + fz * dwy, fz * z], -1),
    ], -2)
    return w[:, None] * f, J, nu, de, cl


def _model_solve(ne, lam):
    """The kernel's 6 x 6 solve: LU with partial pivoting (the first
    largest |pivot|), the right-hand side eliminated with the rows, back
    substitution column by column."""
    a = [[ne[0][i, j] for j in range(6)] + [-ne[1][i]] for i in range(6)]
    for i in range(6):
        a[i][i] = (a[i][i] + lam * a[i][i]) + _f(1e-8)
    for c in range(6):
        p = max(range(c, 6), key=lambda i: (abs(float(a[i][c])), -i))
        a[c], a[p] = a[p], a[c]
        for i in range(c + 1, 6):
            m = a[i][c] / a[c][c]
            for j in range(c + 1, 7):
                a[i][j] = a[i][j] - m * a[c][j]
    x = [None] * 6
    for j in range(5, -1, -1):
        x[j] = a[j][6] / a[j][j]
        for i in range(j):
            a[i][6] = a[i][6] - x[j] * a[i][j]
    return torch.stack(x)


def _kernel_model(pose, cp, lpa, lpb, valid, iters=4):
    """``csrc/lm_solve.cu``'s rounds for one lane in float32: one pass at
    pose0 (the equations and build_normal_equations' cost), then each
    round solves, retracts and makes one pass at the candidate for its
    robust cost and equations, kept on accept; returns the pose and each
    round's accept."""
    v = valid.float()
    d2 = _f(0.2 * 0.2)

    def cost_of(s):
        return torch.where(s <= d2, s, _f(2.0 * 0.2) * torch.sqrt(
            torch.clamp(s, min=0.0)) - d2)

    def pass_at(p, first):
        r, J, nu, de, cl = _model_rows(p, cp, lpa, lpb)
        s = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
        sc = torch.clamp(s, min=1e-20)
        wi = torch.where(sc <= d2, torch.ones_like(sc),
                         _f(0.2) / torch.sqrt(sc)) * v
        Jw = J * wi[:, None, None]
        JtJ = (Jw[:, :, :, None] * J[:, :, None, :]).sum((0, 1))
        JtJ = torch.triu(JtJ) + torch.triu(JtJ, 1).T   # the upper triangle
        Jtr = (Jw * r[:, :, None]).sum((0, 1))
        if first:
            return JtJ, Jtr, (cost_of(s) * v).sum()
        dc = torch.sqrt(cl[:, 0] * cl[:, 0] + cl[:, 1] * cl[:, 1])
        wc = _f(1.01) - (dc - _f(MIN_R)) / _f(MAX_R - MIN_R)
        rc = (wc[:, None] * nu) / de[:, None]
        sr = (rc[:, 0] * rc[:, 0] + rc[:, 1] * rc[:, 1]) + rc[:, 2] * rc[:, 2]
        return JtJ, Jtr, (cost_of(sr) * v).sum()

    kept, lam, accepts = pass_at(pose, True), _f(1e-4), []
    for _ in range(iters):
        delta = _model_solve(kept, lam)
        cand = se3.retract(pose, delta)
        got = pass_at(cand, False)
        accepts.append(bool(got[2] < kept[2]))
        if accepts[-1]:
            pose, kept, lam = cand, got, lam * 0.5
        else:
            lam = lam * 4.0
    return pose, accepts


def _plain_accepts(pose, cp, lpa, lpb, valid, iters=4):
    """Each round's accept of ``lm_solve_plain``: whether ``iters = n``
    moved the pose from ``iters = n - 1``."""
    kw = dict(min_range=MIN_R, max_range=MAX_R)
    out = [S.lm_solve_plain(pose, cp, lpa, lpb, valid, iters=n, **kw)
           for n in range(iters + 1)]
    return [not (torch.equal(a.q, b.q) and torch.equal(a.t, b.t))
            for a, b in zip(out, out[1:])], out[-1]


def test_kernel_rows_match_the_plain_jacobian():
    pose, cp, lpa, lpb, _ = _lane(2)
    r, J, *_ = _model_rows(pose, cp, lpa, lpb)
    wr, wJ = S.point_to_line_jacobian(Pose(pose.q[None], pose.t[None]), cp,
                                      lpa, lpb, MIN_R, MAX_R)
    # de_norm as (dx^2 + dy^2) + dz^2, which torch.linalg.norm on the CPU
    # rounds otherwise now and then: an ulp or two
    np.testing.assert_allclose(r.numpy(), wr.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(J.numpy(), wJ.numpy(), rtol=1e-6,
                               atol=1e-6 * float(wJ.abs().max()))


@pytest.mark.parametrize("seed, accepts", [
    (0, [True, True, True, True]),
    (2, [True, True, False, False]),     # a round after a rejected one
    (3, [True, True, True, False]),
])
def test_kernel_rounds_match_the_plain_solve(seed, accepts):
    """One pass a round (the equations kept on accept, kept as they were on
    reject) takes the plain version's steps: the same accepts, poses within
    float32 reassociation of the sums."""
    lane = _lane(seed)
    want_acc, want = _plain_accepts(*lane)
    got, got_acc = _kernel_model(*lane)
    assert want_acc == accepts and got_acc == accepts
    np.testing.assert_allclose(got.q.numpy(), want.q.numpy(), atol=2e-6)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=2e-5)


def test_kernel_model_without_correspondences_holds_the_pose():
    pose, cp, lpa, lpb, valid = _lane(5)
    got, acc = _kernel_model(pose, cp, lpa, lpb, torch.zeros_like(valid))
    assert acc == [False] * 4
    assert torch.equal(got.q, pose.q) and torch.equal(got.t, pose.t)


def test_every_step_hands_lm_solve_what_the_kernel_takes(monkeypatch):
    """The solo, IMU, batched, chained and combined steps call ``lm_solve``
    with float32, contiguous tensors of the kernel's shapes: on the CPU
    every check of ``lm_solve_cuda`` but the device's passes."""
    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.core.frame import RawScan
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             yaw_matrix)
    from liodom_tpu_torch.mapping import service as MS
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.ops import features as F
    from liodom_tpu_torch.parallel.sharded import init_batch_state

    cfg = LiodomConfig(max_points=16384, ring_width=256, local_map_size=3)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(3, speed=0.8, yaw_rate=0.02)
    imgs = [F.split_scan(RawScan.from_points(torch.from_numpy(
        world.render(pos[f], yaw_matrix(yaws[f]), width=256, noise=0.005,
                     seed=f)), cfg.max_points, device="cpu"), cfg)
        for f in range(3)]
    seen = []
    real = P.lm_solve

    def checked(pose, cp, lpa, lpb, valid, **kw):
        with pytest.raises(ValueError, match="CUDA device"):
            S._check_solve_args(pose, cp, lpa, lpb, valid)
        seen.append(tuple(cp.shape))
        return real(pose, cp, lpa, lpb, valid, **kw)

    monkeypatch.setattr(P, "lm_solve", checked)
    state = P.init_state(cfg, device="cpu")
    for im in imgs:
        state, _, _ = P.image_step(state, im.xyz, im.count, cfg)
    icfg = cfg.replace(use_imu=True)
    P.image_step(P.set_imu(P.init_state(icfg, device="cpu"),
                           np.array([0.99, 0.1, 0.0, 0.0], np.float32)),
                 imgs[0].xyz, imgs[0].count, icfg)
    xs = torch.stack([im.xyz for im in imgs])
    cs = torch.stack([im.count for im in imgs])
    P.batch_image_step(init_batch_state(cfg, 3, device="cpu"), xs, cs, cfg)
    P.chained_image_step(P.init_state(cfg, device="cpu"), xs, cs, cfg)
    ccfg = cfg.replace(mapping=True)
    odom, m = MS.init_combined(ccfg, MapConfig(map_capacity=65536,
                                               local_map_capacity=4096),
                               device="cpu")
    MS.combined_image_step(odom, m, imgs[0].xyz, imgs[0].count, ccfg,
                           MapConfig(map_capacity=65536,
                                     local_map_capacity=4096))
    e = seen[0][-2]
    assert len(seen) == 2 * (3 + 1 + 1 + 3 + 1)
    assert (3, e, 3) in seen and all(s[-2:] == (e, 3) for s in seen)
