"""Port parity: liodom_tpu_torch.core.pose against liodom_tpu.core.pose.

The same float32 inputs, made with numpy from a seed, go through the JAX
function and its PyTorch port; every output agrees to 1e-6 (float32
reassociation of a few operations on unit quaternions and O(10) m vectors).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core import pose as jse3
from liodom_tpu_torch.core import pose as tse3

torch.set_num_threads(1)

TOL = 1e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    q = _quats(rng, n)
    q2 = _quats(rng, n)
    t = (rng.normal(size=(n, 3)) * 10).astype(np.float32)
    t2 = (rng.normal(size=(n, 3)) * 10).astype(np.float32)
    v = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    pts = (rng.normal(size=(n, 7, 3)) * 20).astype(np.float32)
    # rotation vectors: large, small and exactly zero angles
    phi = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    phi[: n // 4] *= 1e-5
    phi[0] = 0.0
    delta = np.concatenate([phi, t / 10], axis=-1).astype(np.float32)
    rpy = (rng.uniform(-1.0, 1.0, size=(n, 3))
           * np.array([np.pi, 0.45 * np.pi, np.pi])).astype(np.float32)
    return dict(q=q, q2=q2, t=t, t2=t2, v=v, pts=pts, phi=phi, delta=delta,
                rpy=rpy)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


CASES = {
    "quat_normalize": lambda m, a: m.quat_normalize(a["q"] * 3.0),
    "quat_mul": lambda m, a: m.quat_mul(a["q"], a["q2"]),
    "quat_conj": lambda m, a: m.quat_conj(a["q"]),
    "quat_rotate": lambda m, a: m.quat_rotate(a["q"], a["v"]),
    "quat_to_matrix": lambda m, a: m.quat_to_matrix(a["q"]),
    "matrix_to_quat": lambda m, a: m.matrix_to_quat(m.quat_to_matrix(a["q"])),
    "so3_exp_quat": lambda m, a: m.so3_exp_quat(a["phi"]),
    "so3_log": lambda m, a: m.so3_log(a["q"]),
    "compose_q": lambda m, a: m.compose(m.Pose(a["q"], a["t"]),
                                        m.Pose(a["q2"], a["t2"])).q,
    "compose_t": lambda m, a: m.compose(m.Pose(a["q"], a["t"]),
                                        m.Pose(a["q2"], a["t2"])).t,
    "inverse": lambda m, a: m.inverse(m.Pose(a["q"], a["t"])).t,
    "transform_points": lambda m, a: m.transform(m.Pose(a["q"], a["t"]),
                                                 a["pts"]),
    "transform_vector": lambda m, a: m.transform(m.Pose(a["q"], a["t"]),
                                                 a["v"]),
    "retract_q": lambda m, a: m.retract(m.Pose(a["q"], a["t"]),
                                        a["delta"]).q,
    "retract_t": lambda m, a: m.retract(m.Pose(a["q"], a["t"]),
                                        a["delta"]).t,
    "rpy_from_quat": lambda m, a: m.rpy_from_quat(a["q"]),
    "quat_from_rpy": lambda m, a: m.quat_from_rpy(a["rpy"]),
    "pose_matrix": lambda m, a: m.Pose(a["q"], a["t"]).matrix(),
    "kitti_row": lambda m, a: m.kitti_row(m.Pose(a["q"], a["t"])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pose_function_matches_jax(name):
    a = _inputs()
    want = np.asarray(CASES[name](jse3, {k: _j(v) for k, v in a.items()}))
    got = CASES[name](tse3, {k: _t(v) for k, v in a.items()}).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_identity_and_batch_shapes():
    p = tse3.Pose.identity(batch=(2, 3))
    j = jse3.Pose.identity(batch=(2, 3))
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(j.t))
    np.testing.assert_array_equal(p.matrix().numpy(), np.asarray(j.matrix()))


def test_rpy_roundtrip_is_identity():
    a = _inputs(seed=3)
    q = tse3.quat_from_rpy(_t(a["rpy"]))
    np.testing.assert_allclose(tse3.rpy_from_quat(q).numpy(), a["rpy"],
                               atol=2e-5)
