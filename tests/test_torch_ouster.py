"""Port parity of ``full_step`` with ``lidar_type`` 1: the Ouster launch
configuration (``liodom_tpu/core/presets.py:ouster_preset(128)``: 128
rings, a 15-frame window, ring width 4,096), fed 128 x 2,048 organised
clouds that JAX's ``organized_from_unorganized`` makes from BoxWorld spins
(the row is the ring).

Over 6 frames: equal edge counts, poses within 1 cm and 1e-3 rad of JAX
``full_step``; the port's ``full_step`` equals its ``image_step`` on the
image ``split_scan_ouster`` makes.
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import torch

from liodom_tpu.core.io import organized_from_unorganized
from liodom_tpu.core.presets import ouster_preset
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.odometry import pipeline as JP

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import features as F

from test_torch_odometry import _quat_angle

torch.set_num_threads(1)

N_FRAMES = 6
ROWS, COLS = 128, 2048


def _configs():
    jcfg, _ = ouster_preset(ROWS)
    return jcfg, LiodomConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=1)
def _clouds():
    world = BoxWorld(seed=3)
    pos, yaws = drive_trajectory(N_FRAMES, speed=1.0, yaw_rate=0.02)
    return [organized_from_unorganized(
        world.render(pos[i], yaw_matrix(yaws[i]), width=720, noise=0.005,
                     seed=100 + i), ROWS, COLS) for i in range(N_FRAMES)]


def test_ouster_full_step_tracks_jax():
    jcfg, cfg = _configs()
    assert (cfg.lidar_type, cfg.scan_lines, cfg.local_map_size,
            cfg.ring_width) == (1, ROWS, 15, 4096)
    jstate, state = JP.init_state(jcfg), P.init_state(cfg, device="cpu")
    unused = torch.zeros(1, dtype=torch.bool)
    for i, cloud in enumerate(_clouds()):
        jstate, jpose, jn = JP.full_step(jstate, jnp.asarray(cloud),
                                         jnp.zeros(1, bool), jcfg)
        state, pose, n_e = P.full_step(state, torch.from_numpy(cloud), unused,
                                       cfg)
        assert int(n_e) == int(jn) > 100, f"frame {i}"
        assert np.linalg.norm(pose.t.numpy() - np.asarray(jpose.t)) < 0.01
        assert _quat_angle(pose.q.numpy(), np.asarray(jpose.q)) < 1e-3
    assert np.linalg.norm(pose.t.numpy()) > 2.0     # the course moved


def test_ouster_full_step_is_image_step_on_the_split():
    _, cfg = _configs()
    a = b = P.init_state(cfg, device="cpu")
    unused = torch.zeros(1, dtype=torch.bool)
    for cloud in _clouds()[:2]:
        xyz = torch.from_numpy(cloud)
        a, pa, na = P.full_step(a, xyz, unused, cfg)
        img = F.split_scan_ouster(xyz, cfg)
        b, pb, nb = P.image_step(b, img.xyz, img.count, cfg)
        assert torch.equal(pa.q, pb.q) and torch.equal(pa.t, pb.t)
        assert int(na) == int(nb)
