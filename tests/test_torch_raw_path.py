"""Port parity of the raw-scan front end's stages: the Ouster split, the
port's copy of ``organized_from_unorganized`` and ``extract_features``.

* ``organized_from_unorganized`` (``core/organize.py``) equal to
  ``liodom_tpu/core/io.py``'s on the same spin;
* ``split_scan_ouster``: counts and image bit-exact to JAX's on organised
  clouds that JAX's helper makes from BoxWorld spins (128 and 64 rows), and
  on random organised clouds with NaN, too-near and too-far points and rows
  that overflow the ring width (the row is the ring: no angle to round);
* ``extract_features``: edge slots and validity bit-exact to JAX's
  ``extract_features`` on the same raw scan (split, K1, K2).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.io import organized_from_unorganized as j_organize
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.ops import features as JF

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan
from liodom_tpu_torch.core.organize import organized_from_unorganized
from liodom_tpu_torch.ops import features as F

from test_features import synth_scan

torch.set_num_threads(1)


def _spin(width=720, seed=0, noise=0.01):
    world = BoxWorld(seed=seed)
    pos, yaws = drive_trajectory(3, speed=1.2, yaw_rate=0.01)
    return world.render(pos[2], yaw_matrix(yaws[2]), width=width, noise=noise,
                        seed=7)


@pytest.mark.parametrize("rings,width", [(128, 2048), (64, 1024)])
def test_organized_from_unorganized_matches_jax(rings, width):
    spin = _spin()
    got = organized_from_unorganized(spin, rings, width)
    want = j_organize(spin, rings, width)
    assert got.dtype == want.dtype and got.shape == (rings, width, 3)
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got).sum(-1) > 0).sum() > 0.9 * len(spin)


def _organised_clouds():
    rng = np.random.default_rng(4)
    noisy = synth_scan(rng, 16 * 200).reshape(16, 200, 3).astype(np.float32)
    noisy[3, 7] = np.nan
    noisy[3, 8] = [np.inf, 0.0, 1.0]
    noisy[5, 9] = [1.0, 0.0, 0.0]           # too near
    noisy[6, 0] = [90.0, 0.0, 0.0]          # too far
    noisy[0, :] = 0.0                       # an empty row
    return {
        "boxworld_128x2048": (j_organize(_spin(), 128, 2048),
                              dict(scan_lines=128, ring_width=4096)),
        "boxworld_64x1024": (j_organize(_spin(seed=2), 64, 1024),
                             dict(scan_lines=64, ring_width=1024)),
        "nan_and_range": (noisy, dict(scan_lines=16, ring_width=256)),
        "rows_overflow": (noisy, dict(scan_lines=16, ring_width=64)),
        "fewer_rows": (noisy[:12], dict(scan_lines=16, ring_width=256)),
    }


@pytest.mark.parametrize("case", sorted(_organised_clouds()))
def test_split_scan_ouster_matches_jax(case):
    cloud, kw = _organised_clouds()[case]
    jcfg = JConfig(lidar_type=1, **kw)
    cfg = LiodomConfig(lidar_type=1, **kw)
    want = JF.split_scan_ouster(jnp.asarray(cloud), jcfg)
    got = F.split_scan_ouster(torch.from_numpy(cloud), cfg)
    assert got.count.dtype == torch.int32
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int(got.count.sum()) > 0


def test_split_scan_ouster_refuses_more_rows_than_lines():
    cfg = LiodomConfig(lidar_type=1, scan_lines=16, ring_width=64)
    with pytest.raises(ValueError, match="17 rows"):
        F.split_scan_ouster(torch.zeros((17, 8, 3)), cfg)


def _raw_scans():
    rng = np.random.default_rng(11)
    pts = synth_scan(rng, 6000).astype(np.float32)
    pts[10] = np.nan
    pts[20] = [0.5, 0.5, 0.0]
    pts[30] = [200.0, 0.0, 0.0]
    return {"box": (_spin(width=900).astype(np.float32), 2048),
            "random": (pts, 512), "overflowing": (pts, 96)}


@pytest.mark.parametrize("case", sorted(_raw_scans()))
def test_extract_features_matches_jax(case):
    pts, ring_width = _raw_scans()[case]
    jcfg = JConfig(max_points=65536, ring_width=ring_width)
    cfg = LiodomConfig(max_points=65536, ring_width=ring_width)
    want = JF.extract_features(JRawScan.from_points(jnp.asarray(pts),
                                                    jcfg.max_points), jcfg)
    got = F.extract_features(RawScan.from_points(torch.from_numpy(pts),
                                                 cfg.max_points,
                                                 device="cpu"), cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int(got.valid.sum()) > 0
