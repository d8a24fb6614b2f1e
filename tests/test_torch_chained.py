"""Port parity: ``chained_image_step``, K frames per call.

At the sizes of ``tests/test_chained.py`` (6 frames, ring width 256, a
3-frame window), with and without per-frame IMU quaternions: poses
bit-identical to the port's own per-frame loop (the chained step makes the
same calls in the same order), which is the 1e-4 m bar JAX holds between
its chained step and its loop; and within the port's parity bar of 1 cm and
1e-3 rad of JAX ``chained_image_step``, with equal edge counts.  The port
and JAX sum the solver's normal equations and costs in another order, and
on this sparse course an LM step whose cost change sits at float32 noise is
accepted by one and rejected by the other: from the same state and the same
correspondences the two ``lm_solve`` differ by 1.5e-4 m on frame 2, and the
chained poses by up to 1.2 mm.  ``cfg.use_imu`` without ``imu_quats``
raises, as in JAX.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import pipeline as P

from test_torch_odometry import _quat_angle

torch.set_num_threads(1)

N_FRAMES = 6
KW = dict(max_points=16384, ring_width=256, local_map_size=3)


@functools.lru_cache(maxsize=1)
def _images():
    """The course of test_chained.py (BoxWorld 0, 0.8 m/frame, 0.02
    rad/frame, 256 columns, 5 mm noise) as stacked numpy ring images, and
    random unit IMU quaternions (seed 3)."""
    jcfg = JConfig(**KW)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.02)
    imgs, cnts = [], []
    for f in range(N_FRAMES):
        scan = world.render(pos[f], yaw_matrix(yaws[f]), width=256,
                            noise=0.005, seed=f)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        imgs.append(np.asarray(img.xyz))
        cnts.append(np.asarray(img.count))
    quats = np.random.default_rng(3).normal(size=(N_FRAMES, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return np.stack(imgs), np.stack(cnts), quats.astype(np.float32)


def _per_frame(cfg, imgs, cnts, quats=None):
    state = P.init_state(cfg, device="cpu")
    ts = []
    for f in range(N_FRAMES):
        if quats is not None:
            state = P.set_imu(state, quats[f])
        state, pose, _ = P.image_step(state, imgs[f], cnts[f], cfg)
        ts.append(pose.t)
    return state, torch.stack(ts)


@pytest.mark.parametrize("use_imu", [False, True])
def test_chained_image_step_matches_jax_and_the_loop(use_imu):
    imgs, cnts, quats = _images()
    jcfg = JConfig(**KW, use_imu=use_imu)
    cfg = LiodomConfig(**KW, use_imu=use_imu)
    jq = jnp.asarray(quats) if use_imu else None
    _, jposes, jedges = JP.chained_image_step(
        JP.init_state(jcfg), jnp.asarray(imgs), jnp.asarray(cnts), jcfg,
        imu_quats=jq)
    ti, tc = torch.from_numpy(imgs), torch.from_numpy(cnts)
    tq = torch.from_numpy(quats) if use_imu else None
    state, poses, nedges = P.chained_image_step(
        P.init_state(cfg, device="cpu"), ti, tc, cfg, imu_quats=tq)
    assert poses.t.shape == (N_FRAMES, 3) and poses.q.shape == (N_FRAMES, 4)
    np.testing.assert_array_equal(nedges.numpy(), np.asarray(jedges))
    err = np.linalg.norm(poses.t.numpy() - np.asarray(jposes.t), axis=1)
    assert err.max() < 0.01, err
    for f in range(N_FRAMES):
        assert _quat_angle(poses.q[f].numpy(), np.asarray(jposes.q[f])) < 1e-3
    loop_state, loop_t = _per_frame(cfg, ti, tc, tq)
    assert torch.equal(poses.t, loop_t)
    assert int(state.window.nframes) == int(loop_state.window.nframes) == 3
    if use_imu:
        np.testing.assert_array_equal(state.imu_ori.numpy(), quats[-1])


def test_chained_state_resumes():
    """Two chunks of K/2 equal one chunk of K: the returned state carries
    the window, the poses and the IMU reading across."""
    imgs, cnts, _ = _images()
    cfg = LiodomConfig(**KW)
    ti, tc = torch.from_numpy(imgs), torch.from_numpy(cnts)
    _, whole, _ = P.chained_image_step(P.init_state(cfg, device="cpu"), ti,
                                       tc, cfg)
    h = N_FRAMES // 2
    state, first, _ = P.chained_image_step(P.init_state(cfg, device="cpu"),
                                           ti[:h], tc[:h], cfg)
    _, second, _ = P.chained_image_step(state, ti[h:], tc[h:], cfg)
    assert torch.equal(torch.cat([first.t, second.t]), whole.t)


def test_chained_use_imu_needs_quats():
    imgs, cnts, _ = _images()
    cfg = LiodomConfig(**KW, use_imu=True)
    with pytest.raises(ValueError, match="imu_quats"):
        P.chained_image_step(P.init_state(cfg, device="cpu"),
                             torch.from_numpy(imgs), torch.from_numpy(cnts),
                             cfg)
