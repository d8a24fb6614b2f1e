"""Port parity: the loader stage, K1 (smoothness) and K2 (edge selection).

* ``split_scan``: ring counts equal, ring xyz equal except where a float32
  ``atan`` last-ulp difference moves a point across a ring boundary; at
  most ``MAX_MOVED`` image cells (ring, column) may then differ per scan
  (measured 0 on these scans).
* K1 plain version against ``smoothness_pallas(interpret=True)`` and the
  XLA ``features.smoothness``: 1e-6 relative to the plane's largest value
  (the plain version and the CUDA kernel round every tap on its own; XLA on
  the CPU contracts and reorders them).
* K2 plain version against ``select_edges_pallas(interpret=True)`` and
  ``select_edges_xla``: bit-exact edges and validity, every side fed the
  same smoothness plane (a last-ulp difference there could flip a pick at
  the 0.1 threshold).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan, RingImage as JRing
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.ops import features as JF
from liodom_tpu.ops.select_pallas import select_edges_pallas
from liodom_tpu.ops.smoothness_pallas import smoothness_pallas

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import select_pallas as SEL
from liodom_tpu_torch.ops import smoothness_pallas as SM

from test_features import synth_scan

torch.set_num_threads(1)

MAX_MOVED = 8   # image cells allowed to differ per scan after a ring flip


def _box_scan(i=2, width=560, noise=0.01):
    world = BoxWorld(seed=3)
    pos, yaws = drive_trajectory(4, speed=1.0, yaw_rate=0.02)
    return world.render(pos[i % 4], yaw_matrix(yaws[i % 4]), width=width,
                        noise=noise, seed=100 + i)


def _scans():
    rng = np.random.default_rng(11)
    pts = synth_scan(rng, 6000)
    pts[10] = np.nan
    pts[20] = [0.5, 0.5, 0.0]
    pts[30] = [200.0, 0.0, 0.0]
    return {"box": (_box_scan(), 2048), "random": (pts, 512),
            "overflow": (synth_scan(np.random.default_rng(12), 6000), 64)}


def _jax_image(pts, ring_width):
    jcfg = JConfig(max_points=65536, ring_width=ring_width)
    raw = JRawScan.from_points(jnp.asarray(pts, jnp.float32), jcfg.max_points)
    img = JF.split_scan(raw, jcfg)
    return jcfg, np.array(img.xyz), np.array(img.count)


@pytest.mark.parametrize("case", ["box", "random", "overflow"])
def test_split_scan_matches_jax(case):
    pts, ring_width = _scans()[case]
    jcfg, jxyz, jcount = _jax_image(pts, ring_width)
    cfg = LiodomConfig(max_points=65536, ring_width=ring_width)
    raw = RawScan.from_points(torch.from_numpy(pts.astype(np.float32)),
                              cfg.max_points)
    img = F.split_scan(raw, cfg)
    np.testing.assert_array_equal(img.count.numpy(), jcount)
    moved = int((img.xyz.numpy() != jxyz).any(axis=-1).sum())
    assert moved <= MAX_MOVED, f"{moved} image cells differ"
    assert int(F.split_overflow(raw, cfg)) == int(
        JF.split_overflow(JRawScan.from_points(
            jnp.asarray(pts, jnp.float32), jcfg.max_points), jcfg))


def _images():
    out = []
    for case, (pts, ring_width) in _scans().items():
        if case == "overflow":
            continue
        jcfg, jxyz, jcount = _jax_image(pts, ring_width)
        out.append((case, jcfg, jxyz, jcount))
    # hand-made rows: short rings, a ring at exactly the width, duplicates
    rng = np.random.default_rng(5)
    xyz = (rng.normal(size=(64, 256, 3)) * 5).astype(np.float32)
    xyz[3, 100:140] = xyz[3, 100]            # a run of duplicate points
    count = rng.integers(0, 257, size=64).astype(np.int32)
    count[:4] = [256, 0, 11, 91]
    for r in range(64):
        xyz[r, count[r]:] = 0.0
    out.append(("rows", JConfig(ring_width=256), xyz, count))
    return out


@pytest.mark.parametrize("idx", range(3))
def test_smoothness_plain_matches_jax(idx):
    case, jcfg, xyz, count = _images()[idx]
    want_pallas = np.asarray(smoothness_pallas(jnp.asarray(xyz),
                                               jnp.asarray(count),
                                               interpret=True))
    want_xla = np.asarray(JF.smoothness(JRing(jnp.asarray(xyz),
                                              jnp.asarray(count)), jcfg))
    got = SM.smoothness_plain(torch.from_numpy(xyz),
                              torch.from_numpy(count)).numpy()
    # XLA on the CPU contracts and reorders the tap sums, so an element
    # whose taps cancel moves by more than 1e-6 of itself; the bound is
    # 1e-6 of the plane's largest value
    scale = max(float(np.abs(want_xla).max()), 1e-12)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(got, want_xla, rtol=1e-6, atol=1e-6 * scale)
    # the dispatcher takes the plain version for a CPU tensor
    disp = F.smoothness(RingImage(torch.from_numpy(xyz),
                                  torch.from_numpy(count)), LiodomConfig())
    np.testing.assert_array_equal(disp.numpy(), got)


@pytest.mark.parametrize("idx", range(3))
def test_select_plain_bit_exact_vs_jax(idx):
    case, jcfg, xyz, count = _images()[idx]
    jimg = JRing(jnp.asarray(xyz), jnp.asarray(count))
    sm = np.asarray(JF.smoothness(jimg, jcfg))
    want_p = select_edges_pallas(jimg, jnp.asarray(sm), jcfg, interpret=True)
    want_x = JF.select_edges_xla(jimg, jnp.asarray(sm), jcfg)
    cfg = LiodomConfig(ring_width=jcfg.ring_width)
    got = SEL.select_edges_plain(
        RingImage(torch.from_numpy(xyz), torch.from_numpy(count)),
        torch.from_numpy(sm), cfg)
    for want in (want_p, want_x):
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int(got.valid.sum()) > 0


def test_reach_plane_matches_jax():
    from liodom_tpu.ops.select_pallas import _reach_plane as j_reach
    for case, jcfg, xyz, count in _images():
        want = np.asarray(j_reach(jnp.asarray(xyz), jcfg.neighbor_gap_sq))
        got = SEL._reach_plane(torch.from_numpy(xyz),
                               jcfg.neighbor_gap_sq).numpy()
        np.testing.assert_array_equal(got, want, err_msg=case)


def test_select_empty_scan():
    cfg = LiodomConfig(ring_width=256)
    img = RingImage(torch.zeros((64, 256, 3)),
                    torch.zeros(64, dtype=torch.int32))
    ec = F.select_edges(img, F.smoothness(img, cfg), cfg)
    assert ec.xyz.shape == (cfg.max_edges, 3)
    assert int(ec.valid.sum()) == 0
    assert torch.isfinite(ec.xyz).all()
