"""Port parity of ``combined_step`` (odometry + mapping from a raw scan)
against ``liodom_tpu/mapping/service.py:combined_step``, on the CPU at the
small size and on the course of test_torch_mapping_service.py.

Each frame's raw scan goes to both; the port splits it itself.  Per frame,
at local-map cadences 1 and 2: poses within 1 cm and 1e-3 rad, equal edge
counts, equal map overflow, and the local-map hit count at the pose and
the received map's valid rows within 0.5 % of JAX's (the leaf-boundary
bound that file holds ``combined_image_step`` to).  Then the port against
itself: ``combined_step`` is ``combined_image_step`` on the image
``split_scan`` makes, bit for bit.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.mapping import grid as JG
from liodom_tpu.mapping import service as JS

from liodom_tpu_torch import mapping
from liodom_tpu_torch.core.frame import RawScan
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S
from liodom_tpu_torch.ops import features as F

from test_torch_mapping_service import (CFG, JCFG, JMCFG, MCFG, N_FRAMES,
                                        _quat_angle)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def _scans():
    world = BoxWorld(seed=0, extent=40.0, n_poles=30)
    pos, yaws = drive_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.01)
    return [world.render(pos[i], yaw_matrix(yaws[i]), width=256,
                         noise=0.005, seed=i) for i in range(N_FRAMES)]


def _raw(scan):
    return RawScan.from_points(torch.from_numpy(scan), CFG.max_points,
                               device="cpu")


@pytest.mark.parametrize("every", [1, 2])
def test_combined_step_tracks_jax(every):
    jodom, jm = JS.init_combined(JCFG, JMCFG)
    odom, m = S.init_combined(CFG, MCFG, device="cpu")
    for i, scan in enumerate(_scans()):
        jraw = JRawScan.from_points(jnp.asarray(scan), JCFG.max_points)
        jodom, jm, jpose, jne = JS.combined_step(
            jodom, jm, jraw.xyz, jraw.valid, JCFG, JMCFG, step=i,
            local_map_every=every)
        raw = _raw(scan)
        odom, m, pose, ne = S.combined_step(odom, m, raw.xyz, raw.valid, CFG,
                                            MCFG, step=i,
                                            local_map_every=every)
        _, _, jhits = JG.get_local_map(jm, jpose.t, JMCFG,
                                       capacity=JMCFG.local_map_capacity)
        _, _, n_hits = G.get_local_map(m, pose.t, MCFG,
                                       capacity=MCFG.local_map_capacity)
        jhits = int(jhits)
        assert int(ne) == int(jne) > 100, f"frame {i}"
        assert np.linalg.norm(pose.t.numpy() - np.asarray(jpose.t)) < 0.01
        assert _quat_angle(pose.q.numpy(), np.asarray(jpose.q)) < 1e-3
        assert int(m.overflow) == int(jm.overflow)
        assert jhits > 100
        assert abs(int(n_hits) - jhits) <= 0.005 * jhits, f"frame {i}"
        assert abs(int(odom.received_valid.sum())
                   - int(np.asarray(jodom.received_valid).sum())) <= \
            0.005 * jhits, f"frame {i}"
    assert int(m.valid.sum()) > 500


def test_combined_step_is_combined_image_step_on_the_split():
    a_odom, a_map = S.init_combined(CFG, MCFG, device="cpu")
    b_odom, b_map = a_odom, a_map
    for i, scan in enumerate(_scans()[:4]):
        raw = _raw(scan)
        a_odom, a_map, pa, na = mapping.combined_step(
            a_odom, a_map, raw.xyz, raw.valid, CFG, MCFG, step=i,
            local_map_every=2)
        img = F.split_scan(raw, CFG)
        b_odom, b_map, pb, nb = S.combined_image_step(
            b_odom, b_map, img.xyz, img.count, CFG, MCFG, step=i,
            local_map_every=2)
        assert torch.equal(pa.t, pb.t) and torch.equal(pa.q, pb.q)
        assert int(na) == int(nb)
        assert torch.equal(a_map.code, b_map.code)
        assert torch.equal(a_map.xyz, b_map.xyz)
        assert torch.equal(a_odom.received_xyz, b_odom.received_xyz)
    with pytest.raises(ValueError, match="odometry on"):
        S.combined_step(a_odom, a_map, raw.xyz.to("meta"), raw.valid, CFG,
                        MCFG)
