"""K2's algorithm (``csrc/select.cu``) pinned on the CPU, and K2 above the
JAX kernel's 128 slots a ring.

* ``select_walk`` is the kernel's algorithm in plain code: each region's
  top ``L = 11 * max_picks + 5`` columns in (value desc, column asc) order
  (-0.0 as +0.0), then the ordered walk over the regions, 32 entries a
  warp step, the picked mask carried across region boundaries.  It must
  give ``select_plain``'s slots bit for bit (bidx and bval), and its walk
  must never read past L or run out of a cut list, on: the bench frame
  (BoxWorld seed 0, 1800-column spin, 64 x 4096 rings); that plane
  quantised to 1/8 (many exact ties); planes of +0.0 and -0.0 under a
  threshold below 0; -inf columns; short regions on a densely sampled ring,
  where a pick's suppression reaches into the next region; a ring below
  ``min_points``; all at S = 88 (the presets) and S = 168
  (``edges_per_region=20``).  A list cut below L must show: the walk then
  runs out of it.
* The port's ``select_edges`` on the CPU against JAX ``select_edges_pallas``
  at S = 168, where the JAX package takes ``select_edges_xla``: bidx, bval
  and the edge points bit for bit, both fed the same smoothness plane.
* Rings too wide for a block's shared memory (2 x 49,152 columns at S =
  88, 2 x 38,741 at S = 424, made from a seed): the port's
  ``select_edges`` against JAX ``select_edges`` bit for bit, and the walk
  against ``select_plain``.
* ``select_lists_topl``, the device-memory path's list construction (order
  keys, a radix select of the L-th key, the ties at it taken in column
  order, a sorting network): every region's list equal to the sorted cut
  ``sorted(range(start, end), key=(-v, c))[:L]`` and, through
  ``select_walk(lists="topl")``, the slots equal to ``select_plain``'s, on
  the bench frame, its 1/8-quantised plane, +-0.0 under -0.5, -inf, NaN
  (the kernel's fold: NaN is -inf), denormals, all-equal regions, regions
  shorter than L, regions of exactly L columns and the wide rings above.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RingImage as JRing
from liodom_tpu.ops import features as JF
from liodom_tpu.ops.select_pallas import select_edges_pallas

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import select_pallas as SEL

torch.set_num_threads(1)

PICKS = {88: 10, 168: 20}      # S -> edges_per_region at 8 regions


@functools.lru_cache(maxsize=None)
def _bench_frame():
    """The bench drive's 6th frame (chip_smoke.py's lane 0, 1 cm noise):
    ring image and smoothness plane at 64 x 4096."""
    cfg = LiodomConfig(local_map_size=5)
    pos, yaws = drive_trajectory(6, speed=1.2, yaw_rate=0.01)
    scan = BoxWorld(seed=0).render(pos[5], yaw_matrix(yaws[5]), width=1800,
                                   noise=0.01, seed=5)
    img = F.split_scan(RawScan.from_points(torch.from_numpy(scan),
                                           cfg.max_points, device="cpu"), cfg)
    return img, F.smoothness(img, cfg)


def _dense_ring_image(seed, rings=16, width=512):
    """Rings sampled every 5 cm along gentle curves (every gap^2 far below
    0.05, so a pick suppresses 5 neighbours a side) with ~12 % of the gaps
    broken, counts from 40 to the width: short regions whose picks reach
    into the next region, and one ring below min_points."""
    rng = np.random.default_rng(seed)
    t = np.arange(width, dtype=np.float64) * 0.05
    xyz = np.zeros((rings, width, 3), np.float32)
    for r in range(rings):
        steps = np.where(rng.random(width) < 0.12, 0.4, 0.05)
        s = np.cumsum(steps)
        xyz[r, :, 0] = 10.0 + np.cos(s * 0.05 + r)
        xyz[r, :, 1] = s
        xyz[r, :, 2] = 0.1 * np.sin(t * 3 + r)
    count = rng.integers(40, width + 1, rings).astype(np.int32)
    count[3] = 20                    # below min_points at either S
    for r in range(rings):
        xyz[r, count[r]:] = 0.0
    return torch.from_numpy(xyz), torch.from_numpy(count)


def _planes(name, s):
    """(xyz, count, smooth, cfg) of a named scene at S slots a ring."""
    cfg = LiodomConfig(edges_per_region=PICKS[s])
    if name in ("bench", "quantised"):
        img, sm = _bench_frame()
        if name == "quantised":
            sm = torch.round(sm * 8.0) / 8.0
        return img.xyz, img.count, sm, cfg
    xyz, count = _dense_ring_image({"signed_zero": 1, "neg_inf": 2,
                                    "cross_region": 3}[name])
    rng = np.random.default_rng(7)
    sm = rng.random(xyz.shape[:2]).astype(np.float32)
    if name == "signed_zero":
        # most columns +-0.0, a threshold below 0: the picks rest on the
        # column order among equal zeros
        zero = rng.random(sm.shape) < 0.8
        sm = np.where(zero, np.where(rng.random(sm.shape) < 0.5, 0.0, -0.0),
                      -sm).astype(np.float32)
        cfg = cfg.replace(smoothness_threshold=-0.5)
    elif name == "neg_inf":
        sm = np.where(rng.random(sm.shape) < 0.4, -np.inf, sm - 0.5)
        cfg = cfg.replace(smoothness_threshold=-1.0)
    else:
        # high values at the region ends, quantised for ties
        sm = np.round(sm * 4) / 4
        sm[:, ::7] += 2.0
    return xyz, count, torch.from_numpy(sm.astype(np.float32)), cfg


SCENES = ["bench", "quantised", "signed_zero", "neg_inf", "cross_region"]


@pytest.mark.parametrize("s", [88, 168])
@pytest.mark.parametrize("name", SCENES)
def test_walk_is_the_pick_chain(name, s):
    xyz, count, sm, cfg = _planes(name, s)
    assert cfg.scan_regions * cfg.max_edges_per_region == s
    reach = SEL._reach_plane(xyz, cfg.neighbor_gap_sq)
    want_i, want_v = SEL.select_plain(sm, reach, count, cfg)
    got_i, got_v, stats = SEL.select_walk(sm, reach, count, cfg)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)
    big_l = SEL.walk_list_len(cfg.max_edges_per_region)
    assert stats["overflow"] == 0
    assert max(stats["visited"]) <= big_l
    assert int(want_v.sum()) > 0
    if name == "cross_region":
        # a ring below min_points picks nothing; several regions are
        # shorter than a pick's reach on both sides
        assert int(count[3]) < cfg.min_points_per_scan
        assert not bool(want_v[3].any())
        sector = (count - 10) // cfg.scan_regions
        assert int(((sector > 0) & (sector < 11)).sum()) >= 1
    if name == "signed_zero":
        picked = sm.gather(1, want_i.long())[want_v]
        zeros = picked == 0
        assert int(zeros.sum()) > 0.9 * picked.numel()
        assert bool((zeros & torch.signbit(picked)).any())
        assert bool((zeros & ~torch.signbit(picked)).any())


def test_walk_runs_out_of_a_list_cut_below_l():
    xyz, count, sm, cfg = _planes("cross_region", 88)
    reach = SEL._reach_plane(xyz, cfg.neighbor_gap_sq)
    want_i, want_v = SEL.select_plain(sm, reach, count, cfg)
    got_i, got_v, stats = SEL.select_walk(sm, reach, count, cfg,
                                          list_len=cfg.max_edges_per_region)
    assert stats["overflow"] > 0
    assert not (torch.equal(got_i, want_i) and torch.equal(got_v, want_v))


def test_smem_bytes_take_every_slot_count():
    """The kernel's shared memory at the widest ring the earlier kernel
    took (6 bytes a column, 227 KB) still fits at the presets' S, and every
    S fits at the bench width."""
    widest = 227 * 1024 // 6
    assert SEL.select_smem_bytes(widest, 8, 11) <= SEL._SMEM_LIMIT
    for picks in (1, 11, 21, 100, 1000):
        assert SEL.select_smem_bytes(4096, 8, picks) <= SEL._SMEM_LIMIT


def test_select_edges_at_168_slots_matches_jax():
    img, _ = _bench_frame()
    xyz, count = img.xyz.numpy(), img.count.numpy()
    jcfg = JConfig(local_map_size=5, edges_per_region=20)
    cfg = LiodomConfig(local_map_size=5, edges_per_region=20)
    assert cfg.scan_regions * cfg.max_edges_per_region == 168
    jimg = JRing(jnp.asarray(xyz), jnp.asarray(count))
    sm = F.smoothness(img, cfg)
    want = select_edges_pallas(jimg, jnp.asarray(sm.numpy()), jcfg)
    got = F.select_edges(img, sm, cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int(got.valid.sum()) > 3000
    # the slots themselves: the walk's bidx against the points JAX kept
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    bidx, bval, _ = SEL.select_walk(sm, reach, img.count, cfg)
    pts = np.take_along_axis(xyz, bidx.numpy()[..., None].astype(np.int64),
                             axis=1)
    pts = np.where(bval.numpy()[..., None], pts, 0.0).reshape(-1, 3)
    np.testing.assert_array_equal(pts, np.asarray(want.xyz))


def _wide_rings(seed, width):
    """Two rings of ``width`` columns sampled every 5 cm along gentle
    curves with ~12 % of the gaps broken (so a pick suppresses up to 5
    neighbours a side), counts near the width, and a smoothness plane
    quantised to 1/8 (many exact ties), all from ``seed``."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((2, width, 3), np.float32)
    for r in range(2):
        s = np.cumsum(np.where(rng.random(width) < 0.12, 0.4, 0.05))
        xyz[r, :, 0] = 10.0 + np.cos(s * 0.01 + r)
        xyz[r, :, 1] = s
        xyz[r, :, 2] = 0.1 * np.sin(s * 0.3 + r)
    count = np.array([width, width - 977], np.int32)
    xyz[1, count[1]:] = 0.0
    sm = np.round(rng.random((2, width)) * 8.0) / 8.0
    return xyz, count, sm.astype(np.float32)


@pytest.mark.parametrize("width,picks", [(49152, 10), (38741, 52)])
def test_select_edges_on_rings_too_wide_for_shared_memory_matches_jax(
        width, picks):
    """Rings whose arrays exceed a block's 227 KB (the card takes K2's
    device-memory path there): 88 slots at 49,152 columns and 424 at
    38,741.  The port's ``select_edges`` on the CPU against JAX's
    (``select_edges_xla`` off the TPU), edge points and validity bit for
    bit, and the kernel's walk (``select_walk``) against ``select_plain``
    slot for slot."""
    cfg = LiodomConfig(edges_per_region=picks, ring_width=width)
    jcfg = JConfig(edges_per_region=picks, ring_width=width)
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    assert n_regions * max_picks == {10: 88, 52: 424}[picks]
    assert SEL.select_smem_bytes(width, n_regions, max_picks) > 232448
    xyz, count, sm = _wide_rings(width, width)
    want = JF.select_edges(JRing(jnp.asarray(xyz), jnp.asarray(count)),
                           jnp.asarray(sm), jcfg)
    img = RingImage(torch.from_numpy(xyz), torch.from_numpy(count))
    got = F.select_edges(img, torch.from_numpy(sm), cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int(got.valid.sum()) > 0.8 * 2 * n_regions * max_picks
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    want_i, want_v = SEL.select_plain(torch.from_numpy(sm), reach,
                                      img.count, cfg)
    got_i, got_v, stats = SEL.select_walk(torch.from_numpy(sm), reach,
                                          img.count, cfg)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert stats["overflow"] == 0


def _topl_scene(name):
    """(xyz, count, smooth, cfg) of a named scene of the top-L test."""
    if name in ("bench", "quantised", "signed_zero", "neg_inf",
                "cross_region"):
        return _planes(name, 88)
    if name.startswith("wide"):
        width, picks = {"wide49152": (49152, 10),
                        "wide38741": (38741, 52)}[name]
        xyz, count, sm = _wide_rings(width, width)
        return (torch.from_numpy(xyz), torch.from_numpy(count),
                torch.from_numpy(sm),
                LiodomConfig(edges_per_region=picks, ring_width=width))
    width = 256 if name == "l_equals_len" else 512
    xyz, count = _dense_ring_image(5, width=width)
    rng = np.random.default_rng(11)
    sm = rng.random(xyz.shape[:2]).astype(np.float32)
    # L = 38 against regions of 3 to 62 columns: some cut, some shorter
    cfg = LiodomConfig(edges_per_region=2)
    if name == "nan":
        sm = np.where(rng.random(sm.shape) < 0.3, np.nan, sm - 0.5)
        cfg = cfg.replace(smoothness_threshold=-1.0)
    elif name == "denormal":
        # a few distinct subnormals of either sign, with +-0.0
        sm = np.round(rng.standard_normal(sm.shape) * 2) * 1e-41
        cfg = cfg.replace(smoothness_threshold=-1.0)
    elif name == "all_equal":
        sm = np.full(sm.shape, 0.75)
    else:                            # l_equals_len: 27-column regions, L 27
        cfg = cfg.replace(edges_per_region=1)
        big_l = SEL.walk_list_len(cfg.max_edges_per_region)
        count = torch.full_like(count, 10 + cfg.scan_regions * big_l)
        count[3] = 12
    return xyz, count, torch.from_numpy(sm.astype(np.float32)), cfg


TOPL_SCENES = ["bench", "quantised", "signed_zero", "neg_inf", "nan",
               "denormal", "all_equal", "cross_region", "l_equals_len",
               "wide49152", "wide38741"]


@pytest.mark.parametrize("name", TOPL_SCENES)
def test_topl_lists_are_the_sorted_cut(name):
    """The device-memory path's lists (``select_lists_topl``, its radix
    select and sort as the kernel runs them) against the sorted cut, region
    by region, and the walk over them against the plain pick chain."""
    xyz, count, sm, cfg = _topl_scene(name)
    n_regions, max_picks = cfg.scan_regions, cfg.max_edges_per_region
    big_l = SEL.walk_list_len(max_picks)
    folded = (torch.where(torch.isnan(sm), float("-inf"), sm) + 0.0)
    lens, tie_cut = [], 0
    for ring in range(sm.shape[0]):
        total = max(int(count[ring]) - 10, 0)
        sector = total // n_regions
        row = folded[ring].tolist()
        for j in range(n_regions):
            start = 5 + sector * j
            end = min(5 + (total if j == n_regions - 1
                           else sector * (j + 1)), sm.shape[1])
            n = max(end - start, 0)
            want = sorted(range(start, start + n),
                          key=lambda c: (-row[c], c))[:big_l]
            got = (SEL.select_lists_topl(sm[ring, start:start + n], big_l)
                   + start).tolist()
            assert got == want, (ring, j)
            lens.append(n)
            if n > big_l:            # the ties at the L-th value were cut
                cut = row[want[-1]]
                tie_cut += (sum(v == cut for v in row[start:start + n])
                            > sum(row[c] == cut for c in want))
    reach = SEL._reach_plane(xyz, cfg.neighbor_gap_sq)
    want_i, want_v = SEL.select_plain(folded, reach, count, cfg)
    got_i, got_v, stats = SEL.select_walk(sm, reach, count, cfg,
                                          lists="topl")
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert stats["overflow"] == 0
    assert int(want_v.sum()) > 0
    if name in ("quantised", "wide49152", "wide38741", "all_equal",
                "denormal"):
        assert tie_cut > 0
    if name in ("cross_region", "nan", "denormal", "all_equal"):
        assert 0 < min(n for n in lens if n) < big_l
    if name == "l_equals_len":
        assert lens.count(big_l) >= 8 * 15
    if name == "nan":
        assert bool(torch.isnan(sm).any())
    if name == "denormal":
        tiny = sm[(sm != 0)].abs()
        assert bool((tiny < 1.17549435e-38).all())
