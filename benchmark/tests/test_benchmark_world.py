"""The device renderer against the port's NumPy ``BoxWorld.render``, and the
route's shape."""

import math

import numpy as np
import pytest
import torch

from benchmark import world


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_render_equals_boxworld(seed):
    from liodom_tpu_torch.core.synth import BoxWorld, yaw_matrix
    bw = BoxWorld(seed=seed)
    scene = world.Scene.from_seed(seed)
    np.testing.assert_array_equal(scene.poles, bw.poles)
    pos = np.array([[3.0, -2.0, 0.0], [-10.5, 20.0, 0.3]])
    rot = np.stack([yaw_matrix(0.3), yaw_matrix(-2.0)])
    got = world.render(scene, torch.as_tensor(pos), torch.as_tensor(rot), 96,
                       0.0, torch.Generator())
    for f in range(2):
        want = bw.render(pos[f], rot[f], width=96, noise=0.0)
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=2e-5)


def test_noise_is_seeded_and_sized():
    scene = world.Scene.from_seed(3)
    pos = torch.zeros((1, 3), dtype=torch.float64)
    rot = torch.eye(3, dtype=torch.float64)[None]
    clean = world.render(scene, pos, rot, 64, 0.0, torch.Generator())
    a = world.render(scene, pos, rot, 64, 0.01,
                     torch.Generator().manual_seed(5))
    b = world.render(scene, pos, rot, 64, 0.01,
                     torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    std = float((a - clean).std())
    assert 0.009 < std < 0.011


def test_route_closes_and_ramps():
    r = world.route_from_seed(11, 1.2, 176, 4)
    assert r.radius == pytest.approx(211.2 / (2 * math.pi))
    pos, rot = r.poses([0.0, 1.2 * 176])
    np.testing.assert_allclose(pos[0], pos[1], atol=1e-9)
    np.testing.assert_allclose(rot[0], rot[1], atol=1e-9)
    arcs = r.lane_ramp_arcs(22)
    steps = np.diff(arcs + [1.2 * 22])
    np.testing.assert_allclose(steps, [0.3, 0.6, 0.9, 1.2])
    chord = np.linalg.norm(np.diff(r.poses(r.lap_arcs()[:2])[0], axis=0))
    assert chord == pytest.approx(1.2, rel=1e-3)


def test_keepout_and_frames():
    route = {"speed_m": 1.2, "circuit_frames": 12, "ramp_frames": 4,
             "keepout_m": 3.0, "extent_m": 60.0, "poles": 60,
             "ground_z_m": -1.8, "noise_m": 0.01, "world_seed": 5}
    frames, scene, r = world.make_frames(5, route, 2, 6, "cpu", 32)
    assert frames.lap.shape == (12, 64 * 32, 3)
    assert [x.shape[0] for x in frames.ramps] == [4, 4]
    assert frames.starts == [0, 6]
    lap_pos, _ = r.poses(r.lap_arcs())
    d = np.linalg.norm(scene.poles[:, None] - lap_pos[None, :, :2], axis=-1)
    assert (d.min(axis=1) > 3.0 + scene.pole_r).all()
    assert torch.equal(frames.spin(1, 4), frames.lap[6])
    assert torch.equal(frames.spin(1, 4 + 12), frames.lap[6])
    assert torch.equal(frames.spin(0, 2), frames.ramps[0][2])
