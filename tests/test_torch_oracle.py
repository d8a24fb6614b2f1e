"""The port's stages against the float64 oracles of ``tests/golden.py``,
each as the JAX package's own test holds JAX to it:

* ``split_scan`` against ``golden_ring_split`` (test_features.py:32,51):
  per-ring counts equal and the ring's points in input order, within
  1e-5 m; a ring that overflows the width keeps its first points and does
  not shift later rings;
* ``split_scan_ouster`` against the organised cloud row by row
  (test_features.py:59);
* plain K1 against ``golden_smoothness`` (test_features.py:93: rtol 2e-4,
  atol 1e-3), also at a width of 1,801 and with counts 0, <= 10 and the
  full width;
* plain K2 against ``golden_select_edges`` fed the same float32
  smoothness (test_features.py:110-163): the picks per ring in order, the
  budget of edges_per_region + 1 picks a region;
* the solver residual against ``golden_point_to_line_residual``
  (test_solver.py:31: rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import select_pallas as SEL
from liodom_tpu_torch.ops import smoothness_pallas as SM
from liodom_tpu_torch.ops import solver as SO

from golden import (golden_point_to_line_residual, golden_ring_split,
                    golden_select_edges, golden_smoothness)
from test_features import _structured_ring, synth_scan

torch.set_num_threads(1)


def _split(pts, cfg):
    raw = RawScan.from_points(torch.from_numpy(pts.astype(np.float32)),
                              cfg.max_points, device="cpu")
    return F.split_scan(raw, cfg)


def test_ring_split_matches_golden():
    rng = np.random.default_rng(0)
    cfg = LiodomConfig(max_points=8192, ring_width=512)
    pts = synth_scan(rng, 4000)
    pts[10] = np.nan
    pts[20] = [0.5, 0.5, 0.0]
    pts[30] = [200.0, 0.0, 0.0]
    img = _split(pts, cfg)
    golden = golden_ring_split(pts, cfg.scan_lines, cfg.min_range,
                               cfg.max_range)
    counts = img.count.numpy()
    for rid in range(cfg.scan_lines):
        assert counts[rid] == len(golden[rid]), rid
        np.testing.assert_allclose(img.xyz[rid, :counts[rid]].numpy(),
                                   pts[golden[rid]], atol=1e-5)
    assert not img.xyz.numpy()[np.arange(512)[None, :]
                               >= counts[:, None]].any()


def test_ring_split_width_overflow_truncates():
    rng = np.random.default_rng(1)
    cfg = LiodomConfig(max_points=8192, ring_width=8)
    pts = synth_scan(rng, 2000)
    img = _split(pts, cfg)
    counts = img.count.numpy()
    golden = golden_ring_split(pts, cfg.scan_lines, cfg.min_range,
                               cfg.max_range)
    for rid in range(cfg.scan_lines):
        keep = golden[rid][:8]
        assert counts[rid] == len(keep)
        np.testing.assert_allclose(img.xyz[rid, :len(keep)].numpy(),
                                   pts[keep], atol=1e-5)
    raw = RawScan.from_points(torch.from_numpy(pts.astype(np.float32)),
                              cfg.max_points, device="cpu")
    assert int(F.split_overflow(raw, cfg)) == sum(
        max(len(g) - 8, 0) for g in golden)


def test_ouster_split_matches_the_rows():
    rng = np.random.default_rng(2)
    cfg = LiodomConfig(lidar_type=1, scan_lines=16, ring_width=256)
    h, w = 16, 128
    organized = synth_scan(rng, h * w).reshape(h, w, 3)
    organized[3, 7] = np.nan
    organized[5, 9] = [1.0, 0.0, 0.0]  # too close
    img = F.split_scan_ouster(torch.from_numpy(organized.astype(np.float32)),
                              cfg)
    for row in range(h):
        keep = [p for p in organized[row] if np.isfinite(p).all()
                and cfg.min_range <= np.hypot(p[0], p[1]) <= cfg.max_range]
        assert int(img.count[row]) == len(keep)
        np.testing.assert_allclose(img.xyz[row, :len(keep)].numpy(),
                                   np.array(keep), atol=1e-5)


@pytest.mark.parametrize("width,counts", [
    (128, (100,)),
    (1801, (1801, 1500, 0, 10, 11, 7)),
    (256, (256, 0, 0, 0)),
])
def test_plain_smoothness_matches_golden(width, counts):
    rng = np.random.default_rng(3)
    xyz = np.zeros((len(counts), width, 3), np.float32)
    for r, n in enumerate(counts):
        xyz[r, :n] = synth_scan(rng, n)
    got = SM.smoothness_plain(torch.from_numpy(xyz),
                              torch.tensor(counts, dtype=torch.int32)).numpy()
    for r, n in enumerate(counts):
        want = golden_smoothness(xyz[r, :n])
        np.testing.assert_allclose(got[r, :n], want, rtol=2e-4, atol=1e-3)
        assert not got[r, n:].any()
        assert not got[r, :min(5, n)].any()


def _structured_image(cfg):
    rng = np.random.default_rng(4)
    xyz = np.zeros((cfg.scan_lines, cfg.ring_width, 3), np.float32)
    counts = np.zeros(cfg.scan_lines, np.int32)
    for rid, n in enumerate([200, 150, 97, 89, 256, 123]):  # 89 < 90
        xyz[rid, :n] = _structured_ring(rng, n)
        counts[rid] = n
    return xyz, counts


def test_plain_select_matches_golden_sequential():
    cfg = LiodomConfig(ring_width=256)
    xyz, counts = _structured_image(cfg)
    img = RingImage(torch.from_numpy(xyz), torch.from_numpy(counts))
    sm = SM.smoothness_plain(img.xyz, img.count)
    ec = SEL.select_edges_plain(img, sm, cfg)
    got_xyz = ec.xyz.numpy().reshape(cfg.scan_lines, -1, 3)
    got_valid = ec.valid.numpy().reshape(cfg.scan_lines, -1)
    for rid in range(6):
        n = counts[rid]
        want_idx = golden_select_edges(
            xyz[rid, :n].astype(np.float64), cfg.scan_regions,
            cfg.edges_per_region, cfg.min_points_per_scan,
            smooth=sm[rid, :n].numpy())
        got = got_xyz[rid][got_valid[rid]]
        assert got.shape == (len(want_idx), 3), rid
        np.testing.assert_allclose(got, xyz[rid][want_idx], atol=1e-5)
    assert not got_valid[3].any()          # below min_points_per_scan
    assert not got_valid[6:].any()


def test_plain_select_budget_matches_golden():
    rng = np.random.default_rng(5)
    cfg = LiodomConfig(ring_width=1024)
    n = 900
    ring = (rng.normal(size=(n, 3)) * 5.0
            + np.array([20.0, 0, 0])).astype(np.float32)
    xyz = np.zeros((cfg.scan_lines, cfg.ring_width, 3), np.float32)
    xyz[0, :n] = ring
    counts = np.zeros(cfg.scan_lines, np.int32)
    counts[0] = n
    img = RingImage(torch.from_numpy(xyz), torch.from_numpy(counts))
    ec = SEL.select_edges_plain(img, SM.smoothness_plain(img.xyz, img.count),
                                cfg)
    want = golden_select_edges(ring.astype(np.float64), cfg.scan_regions,
                               cfg.edges_per_region, cfg.min_points_per_scan)
    got_valid = ec.valid.numpy().reshape(cfg.scan_lines, -1)[0]
    assert got_valid.sum() == len(want) == cfg.max_edges_per_region * 8
    got = ec.xyz.numpy().reshape(cfg.scan_lines, -1, 3)[0][got_valid]
    np.testing.assert_allclose(got, ring[want], atol=1e-5)


def test_residual_matches_golden():
    rng = np.random.default_rng(0)
    q = se3.so3_exp_quat(torch.from_numpy(
        (rng.normal(size=3) * 0.3).astype(np.float32)))
    pose = Pose(q, torch.from_numpy((rng.normal(size=3)).astype(np.float32)))
    for _ in range(10):
        cp = rng.uniform(-30, 30, 3)
        lpa = cp + rng.normal(size=3) * 0.5
        lpb = cp + rng.normal(size=3) * 0.5
        got = SO.point_to_line_residual(
            pose, *(torch.from_numpy(a.astype(np.float32))
                    for a in (cp, lpa, lpb)), 3.0, 75.0)
        want = golden_point_to_line_residual(
            pose.q.numpy().astype(np.float64),
            pose.t.numpy().astype(np.float64), cp, lpa, lpb, 3.0, 75.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
