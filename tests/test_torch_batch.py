"""Port parity: ``batch_image_step`` (B independent sequences in one step),
``init_batch_state`` and a batched JAX state carried across.

At the sizes of ``tests/test_batch.py`` (B = 2 distinct drives, 3 frames,
ring width 512, a 2-frame window): each lane within 1 cm and 1e-3 rad of
JAX ``batch_image_step`` with equal edge counts, and within 5e-4 m of the
port's own solo ``image_step`` on that lane (the bar of test_batch.py: the
batched solver sums in another order).  The batched stages (ring-folded
features, window, solver) are held against their solo forms lane by lane.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF
from liodom_tpu.parallel import sharded as JS

from liodom_tpu_torch import convert
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.odometry import local_map as L
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import solver as S
from liodom_tpu_torch.parallel.sharded import init_batch_state

from test_torch_odometry import _quat_angle

torch.set_num_threads(1)

N_FRAMES, BATCH = 3, 2
KW = dict(ring_width=512, scan_lines=64, local_map_size=2, max_points=32768)


def _cfg():
    return LiodomConfig(**KW)


@functools.lru_cache(maxsize=1)
def _course():
    """Ring images of B distinct drives (BoxWorld seed s, yaw rate 0.02 (s +
    1) rad/frame, as test_batch.py), and JAX batch_image_step over them:
    poses, edge counts and the batched state after frame 1 as numpy."""
    jcfg = JConfig(**KW)
    imgs = np.zeros((N_FRAMES, BATCH, 64, 512, 3), np.float32)
    cnts = np.zeros((N_FRAMES, BATCH, 64), np.int32)
    for s in range(BATCH):
        world = BoxWorld(seed=s)
        pos, yaws = drive_trajectory(N_FRAMES, speed=0.8,
                                     yaw_rate=0.02 * (s + 1))
        for f in range(N_FRAMES):
            pts = world.render(pos[f], yaw_matrix(yaws[f]), width=400,
                               noise=0.005, seed=s * 100 + f)
            img = JF.split_scan(JRawScan.from_points(jnp.asarray(pts),
                                                     jcfg.max_points), jcfg)
            imgs[f, s], cnts[f, s] = np.asarray(img.xyz), np.asarray(img.count)
    states = JS.init_batch_state(jcfg, BATCH)
    poses, edges, carried = [], [], None
    for f in range(N_FRAMES):
        states, pose, ne = JP.batch_image_step(
            states, jnp.asarray(imgs[f]), jnp.asarray(cnts[f]), jcfg)
        poses.append((np.array(pose.q), np.array(pose.t)))
        edges.append(np.array(ne))
        if f == 1:
            carried = jax.tree_util.tree_map(np.array, states)
    return imgs, cnts, poses, edges, carried


def _batch_drive(states, first=0):
    imgs, cnts, _, _, _ = _course()
    out = []
    for f in range(first, N_FRAMES):
        states, pose, ne = P.batch_image_step(
            states, torch.from_numpy(imgs[f]), torch.from_numpy(cnts[f]),
            _cfg())
        out.append((pose, ne))
    return states, out


def test_batch_image_step_tracks_jax():
    _, _, poses, edges, _ = _course()
    states, out = _batch_drive(init_batch_state(_cfg(), BATCH, device="cpu"))
    assert states.window.next_slot.shape == (BATCH,)
    for f, (pose, ne) in enumerate(out):
        assert pose.t.shape == (BATCH, 3) and ne.shape == (BATCH,)
        np.testing.assert_array_equal(ne.numpy(), edges[f])
        for s in range(BATCH):
            assert np.linalg.norm(pose.t[s].numpy() - poses[f][1][s]) < 0.01
            assert _quat_angle(pose.q[s].numpy(), poses[f][0][s]) < 1e-3
    # the lanes are distinct drives, so a swapped lane would show
    assert np.linalg.norm(poses[-1][1][0] - poses[-1][1][1]) > 0.01


def test_batch_matches_solo_per_lane():
    imgs, cnts, _, _, _ = _course()
    _, out = _batch_drive(init_batch_state(_cfg(), BATCH, device="cpu"))
    for s in range(BATCH):
        state = P.init_state(_cfg(), device="cpu")
        for f in range(N_FRAMES):
            state, pose, ne = P.image_step(state, torch.from_numpy(imgs[f, s]),
                                           torch.from_numpy(cnts[f, s]),
                                           _cfg())
            assert int(ne) == int(out[f][1][s])
            np.testing.assert_allclose(out[f][0].t[s].numpy(),
                                       pose.t.numpy(), rtol=0, atol=5e-4)


def test_init_batch_state_matches_jax():
    for kw in ({}, {"mapping": True}):
        js = jax.tree_util.tree_leaves(JS.init_batch_state(JConfig(**kw), 3))
        ts = jax.tree_util.tree_leaves(
            init_batch_state(LiodomConfig(**kw), 3, device="cpu"))
        assert len(js) == len(ts)
        for a, b in zip(ts, js):
            assert a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_step_from_carried_batched_jax_state():
    _, _, poses, edges, carried = _course()
    state = convert.state_from_numpy(carried, device="cpu")
    assert state.window.xyz.shape == (BATCH, 2, 64 * 88, 3)
    assert state.received_xyz.shape == (BATCH, 0, 3)
    np.testing.assert_array_equal(state.window.nframes.numpy(), [2, 2])
    _, out = _batch_drive(state, first=2)
    pose, ne = out[0]
    np.testing.assert_array_equal(ne.numpy(), edges[2])
    for s in range(BATCH):
        assert np.linalg.norm(pose.t[s].numpy() - poses[2][1][s]) < 0.01


def test_batched_stages_match_solo():
    imgs, cnts, _, _, _ = _course()
    cfg = _cfg()
    img = RingImage(torch.from_numpy(imgs[0]), torch.from_numpy(cnts[0]))
    sm = F.smoothness(img, cfg)
    ec = F.select_edges(img, sm, cfg)
    assert sm.shape == (BATCH, 64, 512) and ec.valid.shape == (BATCH, 64 * 88)
    rng = np.random.default_rng(4)
    win = L.WindowState.create(2, ec.valid.shape[1])
    bwin = init_batch_state(cfg, BATCH, device="cpu").window
    for s in range(BATCH):
        lane = RingImage(img.xyz[s], img.count[s])
        sm_s = F.smoothness(lane, cfg)
        ec_s = F.select_edges(lane, sm_s, cfg)
        assert torch.equal(sm[s], sm_s)
        assert torch.equal(ec.xyz[s], ec_s.xyz)
        assert torch.equal(ec.valid[s], ec_s.valid)
    # window: lanes at different write pointers
    wins = [win, L.push(win, ec.xyz[1], ec.valid[1])]
    bwin = bwin._replace(
        xyz=torch.stack([w.xyz for w in wins]),
        valid=torch.stack([w.valid for w in wins]),
        next_slot=torch.stack([w.next_slot for w in wins]),
        nframes=torch.stack([w.nframes for w in wins]))
    for _ in range(3):
        pts = torch.from_numpy(rng.normal(size=(BATCH, ec.valid.shape[1], 3))
                               .astype(np.float32))
        ok = torch.from_numpy(rng.random((BATCH, ec.valid.shape[1])) > 0.5)
        bwin = L.push(bwin, pts, ok)
        wins = [L.push(w, pts[s], ok[s]) for s, w in enumerate(wins)]
        flat = L.flatten(bwin)
        for s, w in enumerate(wins):
            for a, b in zip(bwin, w):
                assert torch.equal(a[s], b)
            for a, b in zip(flat, L.flatten(w)):
                assert torch.equal(a[s], b)
    # solver: lanes solved together equal lanes solved alone
    cp = torch.from_numpy(rng.normal(size=(BATCH, 400, 3)).astype(np.float32)
                          * 10)
    d = torch.from_numpy(rng.normal(size=(BATCH, 400, 3)).astype(np.float32))
    lpa = cp + torch.tensor([0.1, -0.05, 0.02]) + 0.01 * d
    lpb = lpa + d
    valid = torch.from_numpy(rng.random((BATCH, 400)) > 0.2)
    pose0 = Pose.identity(batch=(BATCH,))
    kw = dict(min_range=3.0, max_range=75.0)
    got = S.lm_solve(pose0, cp, lpa, lpb, valid, **kw)
    for s in range(BATCH):
        want = S.lm_solve(Pose.identity(), cp[s], lpa[s], lpb[s], valid[s],
                          **kw)
        np.testing.assert_allclose(got.t[s].numpy(), want.t.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.q[s].numpy(), want.q.numpy(),
                                   rtol=0, atol=1e-6)
        assert float(want.t.norm()) > 0.05     # the solve moved the pose


def test_batch_image_step_rejects_bad_shapes():
    cfg = LiodomConfig(ring_width=256)
    states = init_batch_state(cfg, 2, device="cpu")
    xyz = torch.zeros((3, 64, 256, 3))
    with pytest.raises(ValueError, match="batch_image_step"):
        P.batch_image_step(states, xyz, torch.zeros((3, 64),
                                                    dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="batch_image_step"):
        P.batch_image_step(P.init_state(cfg, device="cpu"), xyz[:1],
                           torch.zeros((1, 64), dtype=torch.int32), cfg)
