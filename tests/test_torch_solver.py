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
