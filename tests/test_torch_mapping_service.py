"""Port parity of the fused odometry + mapping step
(``liodom_tpu_torch/mapping/service.py``) against
``liodom_tpu/mapping/service.py``, on the CPU at a small size (ring width
256, a 16,384-slot map with 20 m cells).

The ring images come from the JAX ``split_scan`` and go to both engines.
Per frame, at local-map cadences 1 and 2: poses within 1 cm and 1e-3 rad,
equal edge counts, equal map overflow, equal local-map hit counts at the
pose and equal received-map validity.  Then the port against itself: the
chained form equals the per-frame loop, the received-map capacity changes
nothing while the neighbourhood fits, ``MappingService`` publishes what the
JAX service does, and a mid-course JAX state carried across with
``convert`` continues as JAX does.
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.frame import RingImage as JRingImage
from liodom_tpu.core.pose import Pose as JPose
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.mapping import grid as JG
from liodom_tpu.mapping import service as JS
from liodom_tpu.ops import features as JF

from liodom_tpu_torch import convert
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S

from golden import golden_quat_conj, golden_quat_mul
from test_torch_grid import assert_map_equal

torch.set_num_threads(1)

N_FRAMES = 6
CFG_KW = dict(max_points=16384, ring_width=256, local_map_size=3,
              mapping=True)
MCFG_KW = dict(voxel_xysize=20.0, voxel_zsize=25.0, resolution=0.4,
               map_capacity=16384, local_map_capacity=4096)
JCFG, CFG = JConfig(**CFG_KW), LiodomConfig(**CFG_KW)
JMCFG, MCFG = JMapConfig(**MCFG_KW), MapConfig(**MCFG_KW)


def _quat_angle(qa, qb):
    d = golden_quat_mul(golden_quat_conj(np.asarray(qa, np.float64)),
                        np.asarray(qb, np.float64))
    return 2.0 * np.arccos(np.clip(abs(d[0]), -1.0, 1.0))


@functools.lru_cache(maxsize=1)
def _images():
    """The course of tests/test_mapping_service.py (BoxWorld 0, 40 m
    extent, 0.8 m/frame), split into ring images by JAX."""
    world = BoxWorld(seed=0, extent=40.0, n_poles=30)
    pos, yaws = drive_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.01)
    out = []
    for i in range(N_FRAMES):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=256,
                            noise=0.005, seed=i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 JCFG.max_points), JCFG)
        out.append((np.array(img.xyz), np.array(img.count)))
    return out


def _timg(img):
    return torch.from_numpy(img[0]), torch.from_numpy(img[1])


@functools.lru_cache(maxsize=2)
def _jax_course(every):
    """JAX combined_image_step over the course: per frame the pose, edge
    count, overflow, hit count at the pose and received validity, and the
    states after each frame as numpy."""
    odom, m = JS.init_combined(JCFG, JMCFG)
    rows, states = [], []
    for i, img in enumerate(_images()):
        odom, m, pose, ne = JS.combined_image_step(
            odom, m, jnp.asarray(img[0]), jnp.asarray(img[1]), JCFG, JMCFG,
            step=i, local_map_every=every)
        _, _, n_hits = JG.get_local_map(m, pose.t, JMCFG,
                                        capacity=JMCFG.local_map_capacity)
        rows.append((np.array(pose.q), np.array(pose.t), int(ne),
                     int(m.overflow), int(n_hits),
                     np.array(odom.received_valid)))
        states.append((jax.tree_util.tree_map(np.array, odom),
                       [np.array(a) for a in m]))
    return rows, states


@pytest.mark.parametrize("every", [1, 2])
def test_combined_image_step_tracks_jax(every):
    """Free-running over the course.  The poses differ by float32 rounding
    (1.5 mm at most here), which moves a few edge points across a 0.4 m
    leaf boundary, so the map and the hit count at the pose may differ by a
    couple of leaves: at most 2 of ~1,000 here, bounded at 0.5 %.  The
    exact integer parity of the map half is the next test's."""
    want, _ = _jax_course(every)
    odom, m = S.init_combined(CFG, MCFG, device="cpu")
    for i, img in enumerate(_images()):
        odom, m, pose, ne = S.combined_image_step(
            odom, m, *_timg(img), CFG, MCFG, step=i, local_map_every=every)
        q, t, jne, jovf, jhits, jrecv = want[i]
        _, _, n_hits = G.get_local_map(m, pose.t, MCFG,
                                       capacity=MCFG.local_map_capacity)
        assert int(ne) == jne > 100, f"frame {i}"
        assert np.linalg.norm(pose.t.numpy() - t) < 0.01, f"frame {i}"
        assert _quat_angle(pose.q.numpy(), q) < 1e-3, f"frame {i}"
        assert int(m.overflow) == jovf
        assert jhits > 100
        assert abs(int(n_hits) - jhits) <= 0.005 * jhits, f"frame {i}"
        assert abs(int(odom.received_valid.sum()) - int(jrecv.sum())) <= \
            0.005 * jhits, f"frame {i}"
    assert int(m.valid.sum()) > 500 and G.count_cells(m) >= 1


def _np_pose(q, t):
    return (JPose(jnp.asarray(q), jnp.asarray(t)),
            Pose(torch.from_numpy(q), torch.from_numpy(t)))


@pytest.mark.parametrize("every", [1, 2])
def test_map_half_of_the_combined_step_is_exact(every):
    """Each frame of the course from the same inputs on both sides: the
    JAX map before the frame (carried across), the frame's edges and the
    pose JAX solved.  The update and the local-map refresh at the frame's
    cadence then agree exactly: codes, keys, validity, overflow, hit count,
    received rows and their validity; centroids to 1e-5 m."""
    want, states = _jax_course(every)
    jm = JG.init_map(MCFG.map_capacity)
    jodom, _ = JS.init_combined(JCFG, JMCFG)
    for i, img in enumerate(_images()):
        jimg = JRingImage(jnp.asarray(img[0]), jnp.asarray(img[1]))
        edges = JF.select_edges(jimg, JF.smoothness(jimg, JCFG), JCFG)
        ex, ev = np.array(edges.xyz), np.array(edges.valid)
        jpose, tpose = _np_pose(*want[i][:2])
        tm = convert.map_state_from_numpy([np.array(a) for a in jm],
                                          device="cpu")
        todom = convert.state_from_numpy(
            jax.tree_util.tree_map(np.array, jodom), device="cpu")
        jm = JG.update_map(jm, edges.xyz, edges.valid, jpose, JMCFG)
        tm = G.update_map(tm, torch.from_numpy(ex), torch.from_numpy(ev),
                          tpose, MCFG)
        assert_map_equal(tm, jm)
        jnext = JS._refresh_local_map(jodom, jm, jpose, JMCFG, i, every)
        tnext = S._refresh_local_map(todom, tm, tpose, MCFG, i, every)
        np.testing.assert_array_equal(tnext.received_valid.numpy(),
                                      np.asarray(jnext.received_valid))
        np.testing.assert_allclose(tnext.received_xyz.numpy(),
                                   np.asarray(jnext.received_xyz), atol=1e-5,
                                   rtol=0)
        _, _, jn = JG.get_local_map(jm, jpose.t, JMCFG,
                                    capacity=JMCFG.local_map_capacity)
        _, _, tn = G.get_local_map(tm, tpose.t, MCFG,
                                   capacity=MCFG.local_map_capacity)
        assert int(tn) == int(jn) > 100
        if every > 1 and i % every:
            assert tnext.received_xyz is todom.received_xyz   # kept as it was
        # the next frame starts from the JAX course's own states
        jodom = jax.tree_util.tree_map(jnp.asarray, states[i][0])
        jm = JG.MapState(*[jnp.asarray(a) for a in states[i][1]])


def test_chained_equals_the_per_frame_loop():
    imgs = _images()[:4]
    xs = torch.stack([torch.from_numpy(im[0]) for im in imgs])
    cs = torch.stack([torch.from_numpy(im[1]) for im in imgs])
    o1, m1 = S.init_combined(CFG, MCFG, device="cpu")
    o2, m2 = S.init_combined(CFG, MCFG, device="cpu")
    step0 = 5       # the cadence counter carries across chunks
    ts, nes = [], []
    for i, img in enumerate(imgs):
        o1, m1, p, ne = S.combined_image_step(o1, m1, *_timg(img), CFG, MCFG,
                                              step=step0 + i,
                                              local_map_every=2)
        ts.append(p.t)
        nes.append(ne)
    o2, m2, poses, n_edges = S.chained_combined_image_step(
        o2, m2, xs, cs, CFG, MCFG, step0=step0, local_map_every=2)
    assert torch.equal(poses.t, torch.stack(ts))
    assert torch.equal(n_edges, torch.stack(nes))
    assert torch.equal(m1.code, m2.code) and torch.equal(m1.xyz, m2.xyz)
    assert torch.equal(o1.received_xyz, o2.received_xyz)
    with pytest.raises(ValueError, match="imu_quats"):
        S.chained_combined_image_step(o2, m2, xs, cs,
                                      CFG.replace(use_imu=True), MCFG)


def test_local_map_capacity_invariance():
    """A smaller received-map buffer changes nothing while the neighbourhood
    fits it: the pose trajectory is bit-equal (the property behind the
    bench's 16,384-row buffer, tests/test_mapping_service.py)."""
    traj = {}
    for cap in (2048, 4096):
        mcfg = MCFG.replace(local_map_capacity=cap)
        odom, m = S.init_combined(CFG, mcfg, device="cpu")
        poses = []
        for i, img in enumerate(_images()):
            odom, m, pose, _ = S.combined_image_step(odom, m, *_timg(img),
                                                     CFG, mcfg)
            poses.append(pose.t.numpy())
            _, _, n_hits = G.get_local_map(m, pose.t, mcfg, capacity=cap)
            assert int(n_hits) <= 2048, f"frame {i}: the premise broke"
        traj[cap] = np.concatenate(poses)
    np.testing.assert_array_equal(traj[2048], traj[4096])


def test_mapping_service_matches_jax_service():
    rng = np.random.default_rng(4)
    jsvc = JS.MappingService(JMCFG)
    svc = S.MappingService(MCFG, device="cpu")
    for i in range(3):
        pts = (rng.normal(size=(800, 3)) * 15).astype(np.float32)
        valid = rng.random(800) > 0.2
        q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        t = np.array([0.8 * i, 0.1 * i, 0.0], np.float32)
        jsvc.update(jnp.asarray(pts), jnp.asarray(valid),
                    JPose(jnp.asarray(q), jnp.asarray(t)), now=float(i))
        svc.update(pts, valid, Pose(torch.from_numpy(q), torch.from_numpy(t)),
                   now=float(i))
    jxyz, jvalid = jsvc.full_map(now=3.0)
    xyz, valid = svc.full_map(now=3.0)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(xyz, jxyz, atol=1e-5, rtol=0)
    assert valid.sum() > 500
    pos = np.array([1.6, 0.2, 0.0], np.float32)
    lx, lv = svc.local_map(pos)
    jlx, jlv = jsvc.local_map(pos)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_allclose(lx.numpy(), np.asarray(jlx), atol=1e-5)
    small = S.MappingService(MCFG.replace(local_map_capacity=16),
                             device="cpu")
    small.state = svc.state
    assert small.local_map_overflow(pos) == int(lv.sum()) - 16 > 0
    assert small.local_map_with_overflow(pos)[2] == int(lv.sum()) - 16
    assert svc.local_map_overflow(pos) == 0
    assert svc.entropy() == jsvc.entropy()
    # latched republish: stale after 5 s
    assert svc.maybe_republish(now=100.0) is not None
    assert svc.maybe_republish(now=101.0) is None


def test_combined_continues_from_carried_jax_state():
    """The JAX odometry and map states after frame 2, as numpy, seed the
    port; its next frames track JAX's."""
    want, states = _jax_course(1)
    np_odom, np_map = states[2]
    odom = convert.state_from_numpy(np_odom, device="cpu")
    m = convert.map_state_from_numpy(np_map, device="cpu")
    assert int(m.valid.sum()) == int(np_map[2].sum()) > 500
    for i, img in enumerate(_images()[3:], start=3):
        odom, m, pose, ne = S.combined_image_step(odom, m, *_timg(img), CFG,
                                                  MCFG)
        q, t, jne, jovf, jhits, jrecv = want[i]
        assert int(ne) == jne
        assert np.linalg.norm(pose.t.numpy() - t) < 0.01
        assert _quat_angle(pose.q.numpy(), q) < 1e-3
        assert int(m.overflow) == jovf
        # the leaf-boundary bound of test_combined_image_step_tracks_jax
        assert abs(int(odom.received_valid.sum()) - int(jrecv.sum())) <= \
            0.005 * jhits


def test_init_combined_needs_mapping_and_matches_jax():
    with pytest.raises(ValueError):
        S.init_combined(CFG.replace(mapping=False), MCFG, device="cpu")
    odom, m = S.init_combined(CFG, MCFG, device="cpu")
    jodom, jm = JS.init_combined(JCFG, JMCFG)
    assert odom.received_xyz.shape == jodom.received_xyz.shape
    assert torch.equal(m.code, torch.full((MCFG.map_capacity,), G.EMPTY))
    assert m.xyz.shape == jm.xyz.shape and int(m.overflow) == 0
