"""Port parity of the odometry layer: the sliding window, the engine state,
the IMU override, a 6-frame planar course and a step taken from a
mid-course JAX state carried across with ``state_from_numpy``.

Integer and boolean state (window validity, write pointer, frame count,
edge counts) must be equal; poses within 1 cm and 1e-3 rad of JAX
``image_step`` (float32 reassociation in the solver's sums).
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core import pose as jse3
from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.odometry import local_map as JL
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF

from liodom_tpu_torch import convert
from liodom_tpu_torch.core import pose as tse3
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import local_map as L
from liodom_tpu_torch.odometry import pipeline as P

from golden import golden_quat_conj, golden_quat_mul

torch.set_num_threads(1)

N_PLANAR = 6
CARRY_AT = 3   # the JAX state after this frame seeds the port


def _quat_angle(qa, qb):
    d = golden_quat_mul(golden_quat_conj(np.asarray(qa, np.float64)),
                        np.asarray(qb, np.float64))
    return 2.0 * np.arccos(np.clip(abs(d[0]), -1.0, 1.0))


@functools.lru_cache(maxsize=1)
def _planar_course():
    """The planar course of test_pipeline_golden.py (BoxWorld 3, 1 m/frame,
    0.02 rad/frame, 720 columns, 5 mm noise), through JAX: ring images,
    per-frame poses and edge counts, and the state after CARRY_AT."""
    jcfg = JConfig(local_map_size=5, ring_width=2048)
    world = BoxWorld(seed=3)
    pos, yaws = drive_trajectory(N_PLANAR, speed=1.0, yaw_rate=0.02)
    state = JP.init_state(jcfg)
    imgs, poses, edges, carried = [], [], [], None
    for i in range(N_PLANAR):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=720,
                            noise=0.005, seed=100 + i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        state, pose, n = JP.image_step(state, img.xyz, img.count, jcfg)
        imgs.append((np.array(img.xyz), np.array(img.count)))
        poses.append((np.array(pose.q), np.array(pose.t)))
        edges.append(int(n))
        if i == CARRY_AT:
            carried = jax.tree_util.tree_map(np.array, state)
    return imgs, poses, edges, carried


def _cfg():
    return LiodomConfig(local_map_size=5, ring_width=2048)


def _step(state, img):
    return P.image_step(state, torch.from_numpy(img[0]),
                        torch.from_numpy(img[1]), _cfg())


def test_planar_course_tracks_jax():
    imgs, poses, edges, _ = _planar_course()
    state = P.init_state(_cfg(), device="cpu")
    for i, img in enumerate(imgs):
        state, pose, n = _step(state, img)
        assert int(n) == edges[i], f"frame {i}"
        assert np.linalg.norm(pose.t.numpy() - poses[i][1]) < 0.01
        assert _quat_angle(pose.q.numpy(), poses[i][0]) < 1e-3
    assert np.linalg.norm(poses[-1][1]) > 2.0   # the course moved


@pytest.mark.parametrize("form", ["tuple", "dict"])
def test_step_from_carried_jax_state(form):
    imgs, poses, edges, carried = _planar_course()
    if form == "dict":
        (wx, wv, slot, nf), odom, prev, rx, rv, imu = carried
        carried = dict(window_xyz=wx, window_valid=wv, next_slot=slot,
                       nframes=nf, odom_q=odom[0], odom_t=odom[1],
                       prev_q=prev[0], prev_t=prev[1], received_xyz=rx,
                       received_valid=rv, imu_ori=imu)
    state = convert.state_from_numpy(carried, device="cpu")
    assert int(state.window.nframes) == CARRY_AT + 1
    state, pose, n = _step(state, imgs[CARRY_AT + 1])
    want_q, want_t = poses[CARRY_AT + 1]
    assert int(n) == edges[CARRY_AT + 1]
    assert np.linalg.norm(pose.t.numpy() - want_t) < 0.01
    assert _quat_angle(pose.q.numpy(), want_q) < 1e-3
    p = convert.pose_from_numpy(want_q, want_t, device="cpu")
    np.testing.assert_array_equal(p.q.numpy(), want_q)


def _frames(seed, k=3, e=50):
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(e, 3)) * 10).astype(np.float32),
             rng.random(e) > 0.4) for _ in range(k)]


def test_window_push_and_flatten_exact():
    jw = JL.WindowState.create(3, 50)
    tw = L.WindowState.create(3, 50)
    for i, (xyz, valid) in enumerate(_frames(7, k=5)):   # wraps around
        xyz = np.where(valid[:, None], xyz, 0.0).astype(np.float32)
        jw = JL.push(jw, jnp.asarray(xyz), jnp.asarray(valid))
        tw = L.push(tw, torch.from_numpy(xyz), torch.from_numpy(valid))
        np.testing.assert_array_equal(tw.xyz.numpy(), np.asarray(jw.xyz))
        np.testing.assert_array_equal(tw.valid.numpy(), np.asarray(jw.valid))
        assert int(tw.next_slot) == int(jw.next_slot)
        assert int(tw.nframes) == int(jw.nframes)
        for a, b in zip(L.flatten(tw), JL.flatten(jw)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_push_leaves_the_input_state_untouched():
    tw = L.WindowState.create(2, 50)
    (xyz, valid), = _frames(8, k=1)
    before = tw.xyz.clone()
    L.push(tw, torch.from_numpy(xyz), torch.from_numpy(valid))
    assert torch.equal(tw.xyz, before) and int(tw.nframes) == 0


def test_init_state_matches_jax():
    for kw in ({}, {"mapping": True}):
        jcfg, cfg = JConfig(**kw), LiodomConfig(**kw)
        js = jax.tree_util.tree_leaves(JP.init_state(jcfg, 16))
        ts = jax.tree_util.tree_leaves(P.init_state(cfg, 16, device="cpu"))
        assert len(js) == len(ts)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_imu_override_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    imu = rng.normal(size=4).astype(np.float32)
    imu /= np.linalg.norm(imu)
    qlb = np.array([0.99, 0.05, -0.02, 0.1], np.float32)
    qlb /= np.linalg.norm(qlb)
    t, tlb = (rng.normal(size=3).astype(np.float32) for _ in range(2))
    want = JP._imu_override(jse3.Pose(jnp.asarray(q), jnp.asarray(t)),
                            jnp.asarray(imu),
                            jse3.Pose(jnp.asarray(qlb), jnp.asarray(tlb)))
    got = P._imu_override(tse3.Pose(torch.from_numpy(q), torch.from_numpy(t)),
                          torch.from_numpy(imu),
                          tse3.Pose(torch.from_numpy(qlb),
                                    torch.from_numpy(tlb)))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-5)
    s = P.set_imu(P.init_state(_cfg(), device="cpu"), imu)
    np.testing.assert_array_equal(s.imu_ori.numpy(), imu)


def test_filter_local_map_is_not_ported_yet():
    cfg = LiodomConfig(ring_width=256, filter_local_map=True)
    state = P.init_state(cfg, device="cpu")
    img = torch.zeros((64, 256, 3)), torch.zeros(64, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.image_step(state, *img, cfg)


def test_received_map_joins_the_matching_map():
    cfg = LiodomConfig(ring_width=256, mapping=True)
    state = P.init_state(cfg, 8, device="cpu")
    xyz = np.arange(24, dtype=np.float32).reshape(8, 3)
    valid = np.arange(8) % 2 == 0
    state = P.set_received_map(state, xyz, valid)
    m, mv = P._matching_map(state, cfg)
    assert m.shape == (cfg.local_map_capacity + 8, 3)
    np.testing.assert_array_equal(m[-8:].numpy(), xyz)
    np.testing.assert_array_equal(mv[-8:].numpy(), valid)
