"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device or no ``nvcc``.  On a machine with an H100 run them with

    python -m pytest tests/test_torch_cuda.py -q

This file imports torch and the port only, so it runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                         tie_scene, yaw_matrix)
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import compact_pallas as K7
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import knn_pallas as KNN
from liodom_tpu_torch.ops import neighbors as NB
from liodom_tpu_torch.ops import probe_insert as PI
from liodom_tpu_torch.ops import select_pallas as SEL
from liodom_tpu_torch.ops import smoothness_pallas as SM

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        kernels.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _images(n, width=900, ring_width=2048, noise=0.01):
    cfg = LiodomConfig(local_map_size=5, ring_width=ring_width)
    world = BoxWorld(seed=1)
    pos, yaws = drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    out = []
    for i in range(n):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=width,
                            noise=noise, seed=i)
        out.append(F.split_scan(RawScan.from_points(
            torch.from_numpy(scan), cfg.max_points, device="cpu"), cfg))
    return cfg, out


def test_smoothness_kernel_bit_exact(dev):
    cfg, imgs = _images(1)
    xyz, count = imgs[0].xyz.to(dev), imgs[0].count.to(dev)
    got = SM.smoothness_cuda(xyz, count)
    assert torch.equal(got, SM.smoothness_plain(xyz, count))
    assert torch.equal(got.cpu(), SM.smoothness_plain(imgs[0].xyz,
                                                      imgs[0].count))


def test_select_kernel_bit_exact(dev):
    cfg, imgs = _images(1)
    img = RingImage(imgs[0].xyz.to(dev), imgs[0].count.to(dev))
    sm = SM.smoothness_cuda(img.xyz, img.count)
    got = SEL.select_edges_cuda(img, sm, cfg)
    want = SEL.select_edges_plain(img, sm, cfg)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.xyz, want.xyz)
    assert int(got.valid.sum()) > 1000


def test_select_kernel_at_168_slots_bit_exact(dev):
    """K2 above the JAX kernel's 128 slots a ring (8 x 21 = 168): the
    slots sized at launch, bit for bit against select_plain and the walk
    model, one launch."""
    cfg, imgs = _images(1)
    cfg = cfg.replace(edges_per_region=20)
    img = RingImage(imgs[0].xyz.to(dev), imgs[0].count.to(dev))
    sm = SM.smoothness_cuda(img.xyz, img.count)
    before = _launched("liodom_select_edges")[0]
    got = SEL.select_edges_cuda(img, sm, cfg)
    assert _launched("liodom_select_edges")[0] == before + 1
    want = SEL.select_edges_plain(img, sm, cfg)
    assert got.valid.shape == (64 * 168,)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.xyz, want.xyz)
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    _, bval, stats = SEL.select_walk(sm.cpu(), reach.cpu(), img.count.cpu(),
                                     cfg)
    assert torch.equal(bval.reshape(-1), want.valid.cpu())
    assert stats["overflow"] == 0
    assert int(got.valid.sum()) > 1000


def _wide_planes(dev, rings, width, seed=3, counts=()):
    """Rings of ``width`` columns sampled every 5 cm along gentle curves,
    ~12 % of the gaps broken, counts near the width (the first rings'
    ``counts`` where given), and a smoothness plane quantised to 1/8, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    s = np.cumsum(np.where(rng.random((rings, width)) < 0.12, 0.4, 0.05),
                  axis=1)
    off = np.arange(rings)[:, None]
    xyz = np.stack([10.0 + np.cos(s * 0.01 + off), s,
                    0.1 * np.sin(s * 0.3 + off)], -1).astype(np.float32)
    count = (width - rng.integers(0, 2000, rings)).astype(np.int32)
    count[5] = 20                    # below min_points
    count[:len(counts)] = counts
    xyz[np.arange(width)[None, :] >= count[:, None]] = 0.0
    sm = (np.round(rng.random((rings, width)) * 8.0) / 8.0).astype(np.float32)
    return (RingImage(torch.from_numpy(xyz).to(dev),
                      torch.from_numpy(count).to(dev)),
            torch.from_numpy(sm).to(dev))


@pytest.mark.parametrize("width,picks", [(49152, 10), (38741, 52)])
def test_select_kernel_on_rings_too_wide_for_shared_memory(dev, width,
                                                           picks):
    """K2 where its arrays exceed a block's 227 KB (64 rings at 88 and 424
    slots): the wrapper takes the device-memory path, one launch, bit for
    bit against select_plain."""
    cfg = LiodomConfig(edges_per_region=picks, ring_width=width)
    assert SEL.select_smem_bytes(width, cfg.scan_regions,
                                 cfg.max_edges_per_region) > 232448
    img, sm = _wide_planes(dev, 64, width)
    entries = ("liodom_select_edges", "liodom_select_edges_global")
    before = _launched(*entries)
    got = SEL.select_edges_cuda(img, sm, cfg)
    assert _launched(*entries) == (before[0], before[1] + 1)
    want = SEL.select_edges_plain(img, sm, cfg)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.xyz, want.xyz)
    assert int(got.valid.sum()) > 0.8 * 63 * cfg.scan_regions * (picks + 1)


def _select_layout_case(dev, img, sm, cfg, where):
    """K2's device-memory path on ``img`` in the layout ``where`` names
    ("values": a region's order keys past shared memory; "lists": the
    lists and slots in the scratch; "neither"; None: not checked), bit for
    bit against select_plain."""
    regions, mp = cfg.scan_regions, cfg.max_edges_per_region
    w = img.xyz.shape[1]
    lay = SEL.select_global_shape(w, regions, mp)
    total = torch.clamp(img.count - 10, min=0)
    longest = int((total - total // regions * (regions - 1)).max())
    assert lay["lists_in_scratch"] == (where == "lists")
    if where is not None:
        assert (lay["keys_in_smem"] < longest) == (where == "values")
    assert lay["cluster_blocks"] == min(regions, 8)
    bidx, bval, pts = SEL.select_slots_global(img, sm, cfg)
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    pidx, pval = SEL.select_plain(sm, reach, img.count, cfg)
    assert torch.equal(bidx, pidx) and torch.equal(bval != 0, pval)
    want = SEL.select_edges_plain(img, sm, cfg)
    assert torch.equal(pts.reshape(-1, 3), want.xyz)
    assert int(pval.sum()) > 0.8 * (img.count.shape[0] - 1) * regions * mp


@pytest.mark.parametrize("picks,where", [(289, "values"), (329, "lists")])
def test_select_global_path_with_values_or_lists_in_scratch(dev, picks,
                                                            where):
    """K2's device-memory path at 64 rings x 49,152 columns in each of its
    layouts: at 8 x 290 slots a region's order keys leave shared memory
    (each radix pass reads the plane), at 8 x 330 the lists and slots go to
    the device scratch (handed to rank 0 through global memory); bit for
    bit against select_plain."""
    cfg = LiodomConfig(edges_per_region=picks, ring_width=49152)
    img, sm = _wide_planes(dev, 64, 49152, seed=4)
    _select_layout_case(dev, img, sm, cfg, where)


def test_select_global_path_either_side_of_its_layout_boundaries(dev):
    """K2's top-L path at 16 rings x 49,152 columns at the last slot count
    whose regions' keys shared memory holds and the first past it, and at
    the last whose lists and slots it holds and the first past it (found
    from select_global_shape): bidx, bval and the points bit for bit
    against select_plain."""
    width, regions = 49152, 8
    img, sm = _wide_planes(dev, 16, width, seed=5)
    total = torch.clamp(img.count - 10, min=0)
    longest = int((total - total // regions * (regions - 1)).max())
    shapes = {mp: SEL.select_global_shape(width, regions, mp)
              for mp in range(1, 400)}
    keys_edge = min(mp for mp, lay in shapes.items()
                    if lay["keys_in_smem"] < longest) - 1
    lists_edge = min(mp for mp, lay in shapes.items()
                     if lay["lists_in_scratch"]) - 1
    assert keys_edge < lists_edge
    for mp, where in ((keys_edge, "neither"), (keys_edge + 1, "values"),
                      (lists_edge, None), (lists_edge + 1, "lists")):
        cfg = LiodomConfig(edges_per_region=mp - 1, ring_width=width)
        _select_layout_case(dev, img, sm, cfg, where)


@pytest.mark.parametrize("picks", [10, 329])
def test_select_global_path_on_regions_no_longer_than_the_list(dev, picks):
    """K2's top-L path where a region has at most L = 11 max_picks + 5
    columns (the radix select skipped, every entry ranked): 16 rings x
    49,152 columns at 88 and 8 x 330 slots, the first rings' counts at and
    either side of min_points and 10 + 8 L; such regions, shorter than L
    and of exactly L, occur, and bidx, bval and the points are bit for bit
    select_plain's."""
    width, regions = 49152, 8
    cfg = LiodomConfig(edges_per_region=picks, ring_width=width)
    big_l = SEL.walk_list_len(cfg.max_edges_per_region)
    lo, top = cfg.min_points_per_scan, 10 + regions * big_l
    counts = (lo - 1, lo, lo + 37, (lo + top) // 2, top - 1, top, top + 1)
    img, sm = _wide_planes(dev, 16, width, seed=6, counts=counts)
    total = torch.clamp(img.count.long() - 10, min=0)
    lens = (total // regions)[:, None].repeat(1, regions)
    lens[:, -1] = total - total // regions * (regions - 1)
    lens = lens[img.count >= lo]
    assert int((lens < big_l).sum()) > 0 and int((lens == big_l).sum()) > 0
    bidx, bval, pts = SEL.select_slots_global(img, sm, cfg)
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    pidx, pval = SEL.select_plain(sm, reach, img.count, cfg)
    assert torch.equal(bidx, pidx) and torch.equal(bval != 0, pval)
    want = SEL.select_edges_plain(img, sm, cfg)
    assert torch.equal(pts.reshape(-1, 3), want.xyz)
    assert int(pval.sum()) > 0


def test_select_global_path_at_the_bench_shape(dev):
    """K2's device-memory path called directly on a ring the shared-memory
    kernel takes (88 and 168 slots): bit for bit the same edges."""
    cfg, imgs = _images(1)
    img = RingImage(imgs[0].xyz.to(dev), imgs[0].count.to(dev))
    sm = SM.smoothness_cuda(img.xyz, img.count)
    for c in (cfg, cfg.replace(edges_per_region=20)):
        got = SEL.select_edges_global_cuda(img, sm, c)
        want = SEL.select_edges_cuda(img, sm, c)
        assert torch.equal(got.valid, want.valid)
        assert torch.equal(got.xyz, want.xyz)


def _launched(*symbols):
    """The launches of each entry point so far, by symbol."""
    counts = kernels.launch_counts()
    return tuple(counts.get(symbol, 0) for symbol in symbols)


def _tie_prep(dev, radius):
    lanes = [tie_scene(s, 3000, 20000) for s in range(2)]
    q, qm, r, rm = (torch.from_numpy(np.stack([ln[i] for ln in lanes]))
                    .to(dev) for i in range(4))
    return KNN.knn_prepare(q, qm, r, rm, radius), r.shape[1]


def _list_walk(source, prep, k, like, ints=(), floats=()):
    """``source``'s ListWalk at ``k``, also where ``knn_launch`` takes the
    register walk: ``knn_launch`` above MAX_K, else the ``*_any_k`` entry
    point launched as ``knn_launch`` launches it, its lists in shared
    memory, its outputs shaped as ``like`` (the plain launch's)."""
    if k > KNN.MAX_K:
        return KNN.knn_launch(source, *prep, k, ints, floats)
    q4, r4, flags, qperm = prep
    b, n_e, n_m = flags.shape
    assert KNN.knn_any_k_shape(source, n_m, k)["lists_in_smem"]
    outs = tuple(torch.empty_like(t) for t in like)
    kernels.launch(f"liodom_{source}_any_k", q4.device, q4.data_ptr(),
                   r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(), None,
                   *(t.data_ptr() for t in outs), b, qperm.shape[-1], n_e,
                   n_m, *ints, KNN.TILE_E, KNN.TILE_M, k, *floats)
    return outs


GATES = KNN.line_gates(1.0, 3.0, 0.01)


@pytest.mark.parametrize("k", [3, 8])
def test_knn_kernels_at_k_bit_exact(dev, k):
    """K3, K4, K5 and K6 at k = 3 and 8 on a tie-heavy lattice (two pairs):
    d2, coordinates, indices and endpoints bit for bit against the keyed
    (d2, index) selection; K6's gate flips only at the ratio boundary."""
    prep, m = _tie_prep(dev, 1.0)
    d_b, c_b = KNN.knn_launch("knn_coords", *prep, k)
    d_o, c_o = KNN.knn_launch_plain(*prep, k=k)
    assert d_b.shape == (2, 3000, k)
    assert torch.equal(d_b, d_o) and torch.equal(c_b, c_o)
    solo = tuple(t[:1] for t in prep)
    d_s, c_s = KNN.knn_launch("knn_coords", *solo, k)
    assert torch.equal(d_s, d_o[:1]) and torch.equal(c_s, c_o[:1])
    got = KNN.knn_launch("knn_lines", *prep, k, floats=GATES)
    want = KNN.knn_lines_launch_plain(*prep, 1.0, 3.0, 0.01, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zm = c_o - c_o.mean(dim=-2, keepdim=True)
    eigs = NB.sym3_eigenvalues(torch.einsum("...ki,...kj->...ij", zm, zm))
    at_ratio = ((eigs[..., 2] - 3.0 * eigs[..., 1]).abs()
                <= 1e-4 * eigs[..., 2].abs())
    flips = got[2] != want[2]
    assert int(flips.sum()) <= 2 and not bool((flips & ~at_ratio).any())
    assert int(want[2].sum()) > 100
    prep5, m = _tie_prep(dev, None)
    d5, i5 = KNN.knn_launch("knn_index", *prep5, k, (m,))
    d5_o, i5_o = KNN.knn_index_launch_plain(*prep5, m, k=k)
    assert d5.shape == (2, 3000, k)
    assert torch.equal(d5, d5_o) and torch.equal(i5, i5_o)


@pytest.mark.parametrize("k", [1, 5, 16, 17, 20, 32, 64, 512])
def test_knn_any_k_walk_bit_exact(dev, k):
    """The run-time-k walk (ListWalk) of K3, K4, K5 and K6 on the tie
    lattice (two pairs), its lists in shared memory and, at k = 512, in the
    device scratch: d2, coordinates, indices and endpoints bit for bit
    against the keyed (d2, index) selection, K6's gate only at the ratio
    boundary; ``knn_launch`` takes it above MAX_K."""
    prep, m = _tie_prep(dev, 1.0)
    want = KNN.knn_launch_plain(*prep, k=k)
    shape = KNN.knn_any_k_shape("knn_coords", prep[2].shape[-1], k)
    assert shape["lists_in_smem"] == (k < 512)
    got = _list_walk("knn_coords", prep, k, want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    solo = tuple(t[:1] for t in prep)
    got = _list_walk("knn_coords", solo, k, tuple(t[:1] for t in want))
    assert torch.equal(got[0], want[0][:1]) and torch.equal(got[1],
                                                            want[1][:1])
    entries = ("liodom_knn_coords_batched", "liodom_knn_coords_any_k")
    before = _launched(*entries)
    KNN.knn_launch("knn_coords", *solo, k)
    after = _launched(*entries)
    assert after == ((before[0], before[1] + 1) if k > KNN.MAX_K
                     else (before[0] + 1, before[1]))
    if k >= 2:
        lines = KNN.knn_lines_launch_plain(*prep, 1.0, 3.0, 0.01, k=k)
        got = _list_walk("knn_lines", prep, k, lines, floats=GATES)
        assert torch.equal(got[0], lines[0]) and torch.equal(got[1], lines[1])
        zm = want[1] - want[1].mean(dim=-2, keepdim=True)
        eigs = NB.sym3_eigenvalues(torch.einsum("...ki,...kj->...ij", zm,
                                                zm))
        at_ratio = ((eigs[..., 2] - 3.0 * eigs[..., 1]).abs()
                    <= 1e-4 * eigs[..., 2].abs())
        assert not bool(((got[2] != lines[2]) & ~at_ratio).any())
    prep5, m = _tie_prep(dev, None)
    d5_o, i5_o = KNN.knn_index_launch_plain(*prep5, m, k=k)
    d5, i5 = _list_walk("knn_index", prep5, k, (d5_o, i5_o), (m,))
    assert torch.equal(d5, d5_o) and torch.equal(i5, i5_o)


@pytest.mark.parametrize("side", ["fits", "past"])
def test_knn_any_k_walk_at_the_shared_memory_boundary(dev, side):
    """ListWalk at 128 ref tiles of the tie lattice (two pairs), at the
    last k whose block's lists fit its 227 KB beside the staging buffers,
    the filled counts, the ranked flags and their count, and at the first
    k in the device scratch (found from the shape the library reports).
    K4, K5 and K6 launch at both, bit for bit against the keyed (d2,
    index) selection; the kernels have no static shared memory to add."""
    k = KNN.knn_any_k_list_edge("knn_coords", 128) + (side == "past")
    lanes = [tie_scene(s, 1000, 128 * KNN.TILE_M) for s in range(2)]
    q, qm, r, rm = (torch.from_numpy(np.stack([ln[i] for ln in lanes]))
                    .to(dev) for i in range(4))
    prep = KNN.knn_prepare(q, qm, r, rm, 1.0)
    assert prep[2].shape[-1] == 128
    shape = KNN.knn_any_k_shape("knn_coords", 128, k)
    assert shape["lists_in_smem"] == (side == "fits")
    assert shape["dynamic_smem_bytes"] <= 232448
    assert shape["scratch_bytes_per_tile"] == (
        shape["cluster_blocks"] * shape["thread_groups_per_block"]
        * 8 * k * KNN.TILE_E)
    got = KNN.knn_launch("knn_coords", *prep, k)
    want = KNN.knn_launch_plain(*prep, k=k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m = r.shape[1]
    got = KNN.knn_launch("knn_index", *prep, k, (m,))
    want = KNN.knn_index_launch_plain(*prep, m, k=k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = KNN.knn_launch("knn_lines", *prep, k, floats=GATES)
    want = KNN.knn_lines_launch_plain(*prep, 1.0, 3.0, 0.01, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_knn_index_is_one_kernel_launch(dev):
    """K5 is one kernel a call: no merge kernel, no partial lists."""
    from torch.profiler import ProfilerActivity, profile
    prep5, m = _tie_prep(dev, None)
    KNN.knn_launch("knn_index", *prep5, ints=(m,))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        KNN.knn_launch("knn_index", *prep5, ints=(m,))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "knn_index" in names[0], names


def test_knn_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-30, 30, (40, 3))
    q = torch.from_numpy((centers[rng.integers(0, 40, 3000)]
                          + rng.normal(size=(3000, 3)) * 0.4)
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy((centers[rng.integers(0, 40, 20000)]
                          + rng.normal(size=(20000, 3)) * 0.4)
                         .astype(np.float32)).to(dev)
    qm = torch.from_numpy(rng.random(3000) > 0.2).to(dev)
    rm = torch.from_numpy(rng.random(20000) > 0.2).to(dev)
    d_k, c_k = KNN.knn_coords_cuda(q, qm, r, rm, max_radius=1.0)
    d_p, c_p = KNN.knn_coords_plain(q, qm, r, rm)
    near = d_p < 1.0
    assert int(near.sum()) > 1000
    assert torch.equal(d_k[near], d_p[near])
    gate = qm & (d_p[:, -1] < 1.0)
    assert torch.equal(c_k[gate], c_p[gate])


def _clustered(rng, dev, n, centers):
    pts = (centers[rng.integers(0, len(centers), n)]
           + rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(rng.random(n) > 0.2).to(dev))


def test_knn_batched_kernel_is_k3_lane_by_lane(dev):
    rng = np.random.default_rng(1)
    lanes = []
    for _ in range(4):                       # a distinct scene per lane
        centers = rng.uniform(-30, 30, (40, 3))
        lanes.append(_clustered(rng, dev, 3000, centers)
                     + _clustered(rng, dev, 20000, centers))
    q, qm, r, rm = (torch.stack([ln[i] for ln in lanes]) for i in range(4))
    before = _launched("liodom_knn_coords_batched")[0]
    d_b, c_b = KNN.knn_coords_cuda(q, qm, r, rm, max_radius=1.0)
    assert _launched("liodom_knn_coords_batched")[0] == before + 1
    d_p, c_p = KNN.knn_coords_plain(q, qm, r, rm)
    for b in range(4):
        d_s, c_s = KNN.knn_coords_cuda(q[b], qm[b], r[b], rm[b],
                                       max_radius=1.0)
        assert torch.equal(d_b[b], d_s) and torch.equal(c_b[b], c_s)
        near = d_p[b] < 1.0
        assert int(near.sum()) > 1000
        assert torch.equal(d_b[b][near], d_p[b][near])
        gate = qm[b] & (d_p[b][:, -1] < 1.0)
        assert torch.equal(c_b[b][gate], c_p[b][gate])


def test_knn_index_kernel_matches_plain(dev):
    """K5 without a radius (the sharded step's call: nothing sorted, every
    non-empty tile visited) and with one, one pair and a batch of distinct
    pairs: indices identical to the plain version's wherever its d2 is
    finite (within the radius when pruned), d2 bit-identical there."""
    rng = np.random.default_rng(3)
    lanes = []
    for _ in range(3):
        centers = rng.uniform(-30, 30, (40, 3))
        lanes.append(_clustered(rng, dev, 3000, centers)
                     + _clustered(rng, dev, 20000, centers))
    q, qm, r, rm = (torch.stack([ln[i] for ln in lanes]) for i in range(4))
    for radius in (None, 1.0):
        lim_d2 = radius * radius if radius else 1e29
        before = _launched("liodom_knn_index")[0]
        d_b, i_b = KNN.knn_index_cuda(q, qm, r, rm, max_radius=radius)
        assert _launched("liodom_knn_index")[0] == before + 1
        for b in range(3):
            d_s, i_s = KNN.knn_index_cuda(q[b], qm[b], r[b], rm[b],
                                          max_radius=radius)
            assert torch.equal(d_b[b], d_s) and torch.equal(i_b[b], i_s)
            d_p, i_p = KNN.knn_index_plain(q[b], qm[b], r[b], rm[b])
            lim = d_p < lim_d2
            assert int(lim.sum()) > 5000
            assert torch.equal(d_s[lim], d_p[lim])
            assert torch.equal(i_s[lim], i_p[lim])
            assert bool(rm[b][i_s[d_s < 1e29].long()].all())


def test_knn_walk_tie_order_bit_exact(dev):
    """K3, K4 and K6 share the cluster walk of csrc/knn_search.cuh.  On a
    5 cm lattice with duplicate refs (equal distances in most rows), one
    pair and 4 distinct pairs as a batch, every slot is bit for bit the
    keyed (d2, index) selection ``knn_launch_plain``: d2, coordinates and
    K6's endpoints; K6's gate flips only where the plain eigenvalues sit at
    the ratio (|e_max - 3 e_mid| <= 1e-4 e_max), where acosf / cosf ulps
    can flip it."""
    lanes = [tie_scene(s, 3000, 20000) for s in range(4)]
    q, qm, r, rm = (torch.from_numpy(np.stack([ln[i] for ln in lanes]))
                    .to(dev) for i in range(4))
    for prep in (KNN.knn_prepare(q[:1], qm[:1], r[:1], rm[:1], 1.0),
                 KNN.knn_prepare(q, qm, r, rm, 1.0)):
        d_k, c_k = KNN.knn_launch("knn_coords", *prep)
        d_o, c_o = KNN.knn_launch_plain(*prep)
        assert torch.equal(d_k, d_o) and torch.equal(c_k, c_o)
        tied = ((d_o[..., 1:] < 1.0) & (d_o.diff(dim=-1) == 0)).any(-1)
        assert int(tied.sum()) > 1000
        got = KNN.knn_launch("knn_lines", *prep, floats=GATES)
        want = KNN.knn_lines_launch_plain(*prep, 1.0, 3.0, 0.01)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        zm = c_o - c_o.mean(dim=-2, keepdim=True)
        eigs = NB.sym3_eigenvalues(torch.einsum("...ki,...kj->...ij", zm, zm))
        at_ratio = ((eigs[..., 2] - 3.0 * eigs[..., 1]).abs()
                    <= 1e-4 * eigs[..., 2].abs())
        flips = got[2] != want[2]
        assert int(flips.sum()) <= 2 and not bool((flips & ~at_ratio).any())
        assert int(want[2].sum()) > 100


def test_knn_lines_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    bases = rng.uniform(-15, 15, (120, 3))
    t = np.linspace(-1.2, 1.2, 60)
    m = (bases[:, None, :] + t[None, :, None] * np.array([0.3, 0, 1])
         ).reshape(-1, 3) + rng.normal(size=(7200, 3)) * 0.01
    blobs = rng.uniform(-15, 15, (60, 3))
    m = np.concatenate([m, blobs[rng.integers(0, 60, 6000)]
                        + rng.normal(size=(6000, 3)) * 0.3])
    e = m[::5] + rng.normal(size=m[::5].shape) * 0.04
    r = torch.from_numpy(m.astype(np.float32)).to(dev)
    q = torch.from_numpy(e.astype(np.float32)).to(dev)
    rm = torch.from_numpy(rng.random(len(m)) > 0.05).to(dev)
    qm = torch.from_numpy(rng.random(len(e)) > 0.1).to(dev)
    for args in ((q, qm, r, rm), tuple(torch.stack([x, x.flip(0)])
                                       for x in (q, qm, r, rm))):
        before = _launched("liodom_knn_lines")[0]
        got = KNN.knn_lines_cuda(*args)
        assert _launched("liodom_knn_lines")[0] == before + 1
        want = KNN.knn_lines_plain(*args)
        both = got[2] & want[2]
        assert int(both.sum()) > 500
        assert torch.equal(got[0][both], want[0][both])
        assert torch.equal(got[1][both], want[1][both])
        assert int((got[2] != want[2]).sum()) <= 2   # ratio-gate boundary


def test_image_step_on_the_card_matches_the_cpu_path(dev):
    cfg, imgs = _images(4)
    gpu = P.init_state(cfg)
    cpu = P.init_state(cfg, device="cpu")
    for img in imgs:
        gpu, gp, gn = P.image_step(gpu, img.xyz.to(dev), img.count.to(dev),
                                   cfg)
        cpu, cp, cn = P.image_step(cpu, img.xyz, img.count, cfg)
        assert int(gn) == int(cn)
        assert float((gp.t.cpu() - cp.t).norm()) < 0.01


def _map_on(dev, capacity=65536, n_frames=4, seed=2):
    """A hash map built on ``dev`` from clustered frames around a drive."""
    rng = np.random.default_rng(seed)
    mcfg = MapConfig(map_capacity=capacity)
    m = G.init_map(capacity, device=dev)
    for f in range(n_frames):
        centers = rng.uniform(-60, 60, (200, 3)) * np.array([1, 1, 0.2])
        pts = (centers[rng.integers(0, 200, 6000)]
               + rng.normal(size=(6000, 3)) * 0.8).astype(np.float32)
        valid = torch.from_numpy(rng.random(6000) > 0.1).to(dev)
        pose = Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                    torch.tensor([5.0 * f, 1.0 * f, 0.0], device=dev))
        m = G.update_map(m, torch.from_numpy(pts).to(dev), valid, pose, mcfg)
    return mcfg, m


def _k7_equal(m, base, offs, cap):
    got = K7.compact_hits_cuda(m.xyz, m.key, m.valid, base, offs, cap)
    want = K7.compact_hits_plain(m.xyz, m.key, m.valid, base, offs, cap)
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return int(got[2])


def test_local_map_compact_kernel_bit_exact(dev):
    mcfg, m = _map_on(dev)
    offs = G.local_map_offsets(mcfg)
    for position in ((3.0, -2.0, 0.5), (45.0, 41.0, 3.0), (900.0, 0.0, 0.0)):
        base = G.cell_keys(torch.trunc(torch.tensor(position, device=dev)),
                           mcfg)
        for cap in (16, 4096, 16384, 70000):
            _k7_equal(m, base, offs, cap)
    n_hits = int(K7.compact_hits_cuda(m.xyz, m.key, m.valid,
                                      G.cell_keys(torch.zeros(3, device=dev),
                                                  mcfg), offs, 16)[2])
    assert n_hits > 1000


def test_local_map_compact_kernel_any_neighbourhood(dev):
    """K7 past the 128 targets it once took (cells_xy=6, cells_z=3: 174),
    on a map whose rows are not a multiple of a chunk, with no hit, at
    capacity 0 and at a truncating capacity; above its shared memory the
    wrapper refuses."""
    mcfg, m = _map_on(dev, capacity=131072)
    base = G.cell_keys(torch.zeros(3, device=dev), mcfg)
    offs = G.local_map_offsets(mcfg, cells_xy=6, cells_z=3)
    assert len(offs) == 174
    assert _k7_equal(m, base, offs, 16384) > 1024
    assert _k7_equal(m, base, offs, 1024) > 1024
    assert _k7_equal(m, base, offs, 0) > 0
    far = G.cell_keys(torch.tensor([9000.0, 0.0, 0.0], device=dev), mcfg)
    assert _k7_equal(m, far, offs, 1024) == 0
    rows = 100_003                  # not a multiple of 16 or of a chunk
    pick = torch.from_numpy(np.sort(np.random.default_rng(9).choice(
        m.xyz.shape[0], rows, replace=False))).to(dev)
    sub = G.MapState(m.xyz[pick], m.key[pick], m.valid[pick], m.overflow,
                     m.code[pick])
    empty = G.init_map(rows, device=dev)
    for kw in ({}, {"cells_xy": 6, "cells_z": 3}):
        o = G.local_map_offsets(mcfg, **kw)
        assert _k7_equal(sub, base, o, 16384) > 0
        assert _k7_equal(sub, base, o, 1024) > 1024
        assert _k7_equal(empty, base, o, 1024) == 0
    wide = np.zeros((K7.MAX_TARGETS, 3), np.int32)   # the most it takes
    wide[:len(offs)] = offs
    head = G.MapState(*(t[:4096] if t.ndim else t for t in m))
    assert _k7_equal(head, base, wide, 16384) > 0
    # above it, the targets in device memory: MAX_TARGETS + 1 of
    # cells_xy=70's and all 60,027 of cells_xy=122's, around the map's
    # base and one 69 cells off it
    cell = int(mcfg.voxel_xysize)          # the keys' XY step
    shift = torch.tensor([69 * cell, 0, 0], dtype=torch.int32, device=dev)
    many = G.local_map_offsets(mcfg, cells_xy=122)
    assert len(many) > 60_000
    for o in (G.local_map_offsets(mcfg, cells_xy=70)[:K7.MAX_TARGETS + 1],
              many):
        entries = ("liodom_local_map_compact",
                   "liodom_local_map_compact_global")
        before = _launched(*entries)
        for b in (base, base + shift):
            for cap in (16384, 1024):
                assert _k7_equal(m, b, o, cap) > 1024
        assert _launched(*entries) == (before[0], before[1] + 4)
    # a block 71 cells off: part of the map hits
    n = _k7_equal(m, base + shift * 71 // 69,
                  G.local_map_offsets(mcfg, cells_xy=70), 16384)
    assert 0 < n < int(m.valid.sum())


def test_local_map_compact_global_path_at_any_target_count(dev):
    """K7's device-memory path called directly where the shared-memory
    path also runs (27 and 174 targets, no target, one row short of a
    tile): bit for bit the plain version."""
    mcfg, m = _map_on(dev, capacity=131072)
    base = G.cell_keys(torch.zeros(3, device=dev), mcfg)
    for offs in (G.local_map_offsets(mcfg), np.zeros((0, 3), np.int32),
                 G.local_map_offsets(mcfg, cells_xy=6, cells_z=3)):
        for cap in (0, 1024, 16384):
            for rows in (m.xyz.shape[0], 2047):
                args = (m.xyz[:rows], m.key[:rows], m.valid[:rows], base,
                        offs, cap)
                got = K7.compact_hits_global_cuda(*args)
                want = K7.compact_hits_plain(*args)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_local_map_compact_global_path_either_side_of_a_stride_change(dev):
    """K7's fenced search (the device-memory path) at target counts either
    side of each fence-stride change up to cells_xy=70's 19,883 (stride
    8), just past a multiple of the stride, and at 0 and 17, on 65,537
    rows with keys on, beside and away from the targets, around a plain
    base and one whose key - base wraps int32: rows, validity and n_hits
    bit for bit against the plain version; the library's stride is the
    wrapper's."""
    rng = np.random.default_rng(15)
    every = G.local_map_offsets(MapConfig(), cells_xy=70)
    rows = 65537
    xyz = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(rows) < 0.8).to(dev)
    counts = [0, 17, 2730, 2731, 5460, 5461, 8 * 1000 + 1, len(every)]
    for n in counts:
        offs = every[rng.permutation(len(every))[:n]]
        shape = K7.compact_shape(rows, n)
        assert shape["fence_stride"] == K7.fence_stride(n)
        rel = rng.integers(-3000, 3000, (rows, 3))
        if n:
            on = offs[rng.integers(0, n, rows)].astype(np.int64)
            side = on + np.eye(3, dtype=np.int64)[rng.integers(0, 3, rows)]
            pick = rng.random(rows)[:, None]
            rel = np.where(pick < 0.5, on, np.where(pick < 0.75, side, rel))
        for base in (np.array([5, -3, 1]), np.array([2**31 - 20, -2**31 + 30,
                                                     2**31 - 1])):
            key = ((rel + base + 2**31) % 2**32 - 2**31).astype(np.int32)
            args = (xyz.to(dev), torch.from_numpy(key).to(dev), valid,
                    torch.from_numpy(base.astype(np.int32)).to(dev), offs)
            for cap in (1024, 65536):
                got = K7.compact_hits_global_cuda(*args, cap)
                want = K7.compact_hits_plain(*args, cap)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                assert (int(want[2]) > 1024) == (n > 0)
    assert [K7.fence_stride(n) for n in counts] == [1, 1, 1, 2, 2, 4, 4, 8]


def _probe_equal(tab, code, active):
    got = PI.probe_insert_cuda(tab, code, active, with_rounds=True)
    want = PI.probe_insert_plain(tab, code, active, with_rounds=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


def test_probe_insert_kernel_bit_exact(dev):
    mcfg, m = _map_on(dev)
    rng = np.random.default_rng(5)
    for n_tab, e in ((m.code.shape[0], 6000), (256, 2000)):
        tab = m.code if n_tab == m.code.shape[0] else torch.full(
            (n_tab,), G.EMPTY, dtype=torch.int64, device=dev)
        pts = torch.from_numpy((rng.normal(size=(e, 3)) * 40)
                               .astype(np.float32)).to(dev)
        pts[: e // 4] = pts[e // 4: e // 2]         # duplicate codes
        active = torch.from_numpy(rng.random(e) > 0.1).to(dev)
        code = G._packed_codes(pts, active, mcfg)
        got = _probe_equal(tab, code, active)
        if n_tab == 256:
            assert bool(got[3].any())          # exhausted _MAX_PROBES
            assert int(got[4]) == PI.MAX_PROBES


def test_probe_insert_kernel_edge_cases(dev):
    """One row; no active row (no round runs); rows past what the cluster
    keeps on chip (70,000), and 20,000 of them into a 256-slot table they
    exhaust."""
    mcfg, m = _map_on(dev)
    rng = np.random.default_rng(6)
    n = 70_000
    assert n > PI.probe_shape()["rows_on_chip"]
    pts = torch.from_numpy((rng.normal(size=(n, 3)) * 60)
                           .astype(np.float32)).to(dev)
    pts[:20000] = pts[20000:40000]                   # duplicate codes
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    code = G._packed_codes(pts, active, mcfg)
    got = _probe_equal(m.code, code[:1],
                       torch.ones(1, dtype=torch.bool, device=dev))
    assert int(got[4]) >= 1
    got = _probe_equal(m.code, code[:3000],
                       torch.zeros(3000, dtype=torch.bool, device=dev))
    assert int(got[4]) == 0 and torch.equal(got[0], m.code)
    got = _probe_equal(m.code, code, active)
    assert int(got[2].sum()) > 1000 and int(got[4]) > 1
    small = torch.full((256,), G.EMPTY, dtype=torch.int64, device=dev)
    got = _probe_equal(small, code[:20000], active[:20000])
    assert bool(got[3].any()) and int(got[4]) == PI.MAX_PROBES


def _fold_frame_on(dev, m, e, seed):
    """``e`` world points against the map ``m``: half near its stored
    leaves, half on new ground, a tenth invalid, and the last eighth
    repeating the first (the same slots at both ends of the frame, in the
    first and the last block of the fold's cluster)."""
    rng = np.random.default_rng(seed)
    rows = torch.nonzero(m.valid).squeeze(1).cpu().numpy()
    old = m.xyz[torch.from_numpy(rng.choice(rows, e // 2)).to(dev)].cpu()
    old = old.numpy() + rng.normal(size=(e // 2, 3)) * 0.1
    new = rng.normal(size=(e - e // 2, 3)) * np.array([80, 80, 8]) + 150
    pts = np.concatenate([old, new]).astype(np.float32)[rng.permutation(e)]
    pts[e - e // 8:] = pts[: e // 8]
    valid = rng.random(e) > 0.1
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev),
            Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                 torch.zeros(3, device=dev)))


@pytest.mark.parametrize("cap,e", [(65536, 37), (1 << 22, 5632),
                                   (65536, 20_000), (1 << 20, 100_000),
                                   (1 << 20, 196_608), (1024, 1500)],
                         ids=["e37", "e5632_2p22", "e20000_two_blocks",
                              "e100000_nine_blocks", "e196608_limit",
                              "full_1024"])
def test_map_fold_kernel_against_the_plain_fold(dev, cap, e):
    """``csrc/map_fold.cu`` against ``grid._sparse_fold`` on the same
    probe result: every field of the state and the slots folded bit for bit
    against the plain fold on the CPU; against the plain fold on the card
    the integers bit for bit and the centroids within 1e-5 m (its
    ``segment_reduce`` may add in another order).  Frames of 37 rows, of
    the bench's 5,632 at 2^22 slots (one sorting block, 11 folding), past
    one block's shared memory (2, 9 and 16 sorting blocks, the last the
    kernel's limit), and into a full 1,024-slot table; repeated slots,
    claimed and dropped rows."""
    from liodom_tpu_torch.ops import map_fold as MF
    mcfg, m = _map_on(dev, capacity=cap)
    pts, valid, pose = _fold_frame_on(dev, m, e, seed=e)
    ins = G.insert_frame(m, pts, valid, pose, mcfg)
    ok = valid & ~ins.failed
    shape = MF.map_fold_shape(e)
    assert e <= shape["max_rows"] and shape["sort_blocks"] == {
        37: 1, 5632: 1, 1500: 1, 20_000: 2, 100_000: 9, 196_608: 16}[e]
    assert shape["cluster_blocks"] == {
        37: 1, 5632: 11, 1500: 3, 20_000: 16, 100_000: 16, 196_608: 16}[e]
    before = _launched("liodom_map_fold")[0]
    got, folded = G._fold(m, valid, ins, mcfg, with_folded=True)
    torch.cuda.synchronize()
    assert _launched("liodom_map_fold")[0] == before + 1
    card, card_folded = G._sparse_fold(m, valid, ins, mcfg, with_folded=True)
    cpu, cpu_folded = G._sparse_fold(
        G.MapState(*(t.cpu() for t in m)), valid.cpu(),
        G.Inserted(*(t.cpu() for t in ins)), mcfg, with_folded=True)
    for name in G.MapState._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(cpu, name)), \
            name
    for name in ("key", "valid", "overflow", "code"):
        assert torch.equal(getattr(got, name), getattr(card, name)), name
    assert float((got.xyz - card.xyz).abs().max()) <= 1e-5
    hit = int(torch.unique(ins.slot[ok]).numel())
    assert int(folded) == int(card_folded) == int(cpu_folded) == hit
    if cap == 1024:
        assert bool((valid & ins.failed).any()) and int(got.overflow) > int(
            m.overflow)
    else:
        assert bool(ins.claimed.any()) and hit < int(ok.sum())
    for a, b in zip(m, G.MapState(*(t.cpu() for t in m))):
        assert torch.equal(a.cpu(), b)          # the inputs left untouched


def test_update_map_launches_the_fold_once_a_call(dev):
    """``update_map`` on CUDA: one probe launch and one fold launch a
    call, its state the plain fold's on the CPU; a frame past the kernel's
    limit is refused, never folded plainly."""
    from liodom_tpu_torch.ops import map_fold as MF
    mcfg, m = _map_on(dev, capacity=65536)
    cpu = G.MapState(*(t.cpu() for t in m))
    entries = ("liodom_probe_insert", "liodom_map_fold")
    probes, folds = _launched(*entries)
    for f in range(3):
        pts, valid, pose = _fold_frame_on(dev, m, 5632, seed=f)
        m = G.update_map(m, pts, valid, pose, mcfg)
        cpu_pose = Pose(pose.q.cpu(), pose.t.cpu())
        ins = G.insert_frame(cpu, pts.cpu(), valid.cpu(), cpu_pose, mcfg)
        cpu = G._sparse_fold(cpu, valid.cpu(), ins, mcfg)
        for a, b in zip(m, cpu):
            assert torch.equal(a.cpu(), b)
    assert _launched(*entries) == (probes + 3, folds + 3)
    limit = MF.map_fold_shape(1)["max_rows"]
    assert limit == MF.MAX_ROWS
    pts, valid, pose = _fold_frame_on(dev, m, limit + 1, seed=9)
    with pytest.raises(ValueError, match="exceeds"):
        G.update_map(m, pts, valid, pose, mcfg)
    assert _launched("liodom_map_fold")[0] == folds + 3


def test_combined_step_on_the_card_matches_the_cpu_path(dev):
    cfg, imgs = _images(4)
    cfg = cfg.replace(mapping=True)
    mcfg = MapConfig(map_capacity=131072, local_map_capacity=16384)
    go, gm = S.init_combined(cfg, mcfg)
    co, cm = S.init_combined(cfg, mcfg, device="cpu")
    for img in imgs:
        go, gm, gp, gn = S.combined_image_step(
            go, gm, img.xyz.to(dev), img.count.to(dev), cfg, mcfg)
        co, cm, cp, cn = S.combined_image_step(co, cm, img.xyz, img.count,
                                               cfg, mcfg)
        assert int(gn) == int(cn)
        assert float((gp.t.cpu() - cp.t).norm()) < 0.01
    assert abs(int(gm.valid.sum()) - int(cm.valid.sum())) <= \
        0.001 * int(cm.valid.sum())
    assert int(gm.overflow) == int(cm.overflow) == 0


def test_batch_image_step_on_the_card_matches_the_cpu_path(dev):
    from liodom_tpu_torch.parallel.sharded import init_batch_state
    cfg, imgs = _images(3)
    pairs = [(imgs[i], imgs[2 - i]) for i in range(3)]   # distinct lanes
    gpu = init_batch_state(cfg, 2)
    cpu = init_batch_state(cfg, 2, device="cpu")
    for a, b in pairs:
        xyz = torch.stack([a.xyz, b.xyz])
        cnt = torch.stack([a.count, b.count])
        gpu, gp, gn = P.batch_image_step(gpu, xyz.to(dev), cnt.to(dev), cfg)
        cpu, cp, cn = P.batch_image_step(cpu, xyz, cnt, cfg)
        assert torch.equal(gn.cpu(), cn)
        assert float((gp.t.cpu() - cp.t).norm(dim=-1).max()) < 0.01


def _smoothness_cases(dev):
    """K1's inputs at every shape the port launches it with: the bench
    frame (64 x 4,096) split on the card, the folded batches (256 and 512
    rings), the Ouster path (128 rings), a width that is not a multiple of
    4 (1,801) and the edge counts (0, <= 10, the full width, one full ring
    with the rest empty), plus a tensor 4 bytes off 16-byte alignment."""
    from liodom_tpu_torch.core.organize import organized_from_unorganized
    rng = np.random.default_rng(0)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(8, speed=1.2, yaw_rate=0.01)
    cfg = LiodomConfig()
    scans = [world.render(pos[i], yaw_matrix(yaws[i]), width=1800,
                          noise=0.01, seed=i) for i in range(8)]
    bench = [F.split_scan(RawScan.from_points(s, cfg.max_points), cfg)
             for s in scans]
    ocfg = LiodomConfig(lidar_type=1, scan_lines=128)
    ouster = F.split_scan_ouster(torch.from_numpy(
        organized_from_unorganized(scans[0], 128, 2048)).to(dev), ocfg)

    def rand(r, w, counts):
        xyz = torch.from_numpy((rng.normal(size=(r, w, 3)) * 5)
                               .astype(np.float32)).to(dev)
        return xyz, torch.tensor(counts, dtype=torch.int32, device=dev)

    edge = [0, 3, 10, 11, 4096] + [int(c) for c in
                                   rng.integers(0, 4097, 59)]
    one = [4096] + [0] * 63
    odd = rand(64, 1801, [1801, 0, 10, 11] + [int(c) for c in
                                                rng.integers(0, 1802, 60)])
    big = torch.empty(64 * 4096 * 3 + 1, device=dev)
    shifted = big[1:].view(64, 4096, 3)
    shifted.copy_(bench[0].xyz)
    return {"bench_64x4096": (bench[0].xyz, bench[0].count),
            "folded_256x4096": (torch.cat([b.xyz for b in bench[:4]]),
                                torch.cat([b.count for b in bench[:4]])),
            "folded_512x4096": (torch.cat([b.xyz for b in bench]),
                                torch.cat([b.count for b in bench])),
            "ouster_128x4096": (ouster.xyz, ouster.count),
            "width_1801": odd,
            "edge_counts": rand(64, 4096, edge),
            "one_full_ring": rand(64, 4096, one),
            "unaligned": (shifted, bench[0].count)}


def test_smoothness_kernel_at_every_launched_shape(dev):
    cases = _smoothness_cases(dev)
    before = _launched("liodom_smoothness")[0]
    for name, (xyz, count) in cases.items():
        got = SM.smoothness_cuda(xyz, count)
        assert torch.equal(got, SM.smoothness_plain(xyz, count)), name
    torch.cuda.synchronize()
    assert _launched("liodom_smoothness")[0] == before + len(cases)
    assert SM.smoothness_shape()["cols_per_thread"] == 4


def test_split_makes_no_host_sync(dev):
    """split_scan, split_overflow, split_scan_ouster and extract_features on
    the card under torch's sync debug mode set to raise."""
    from liodom_tpu_torch.core.organize import organized_from_unorganized
    cfg = LiodomConfig()
    world = BoxWorld(seed=0)
    scan = world.render(np.zeros(3), np.eye(3), width=1800, noise=0.01,
                        seed=0)
    raw = RawScan.from_points(scan, cfg.max_points)
    cloud = torch.from_numpy(organized_from_unorganized(scan, 128, 2048)
                             ).to(dev)
    ocfg = LiodomConfig(lidar_type=1, scan_lines=128)
    F.extract_features(raw, cfg)               # build the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = F.split_scan(raw, cfg)
        dropped = F.split_overflow(raw, cfg)
        oimg = F.split_scan_ouster(cloud, ocfg)
        ec = F.extract_features(raw, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(dropped) == 0 and int(img.count.sum()) > 50000
    assert int(oimg.count.sum()) > 50000 and int(ec.valid.sum()) > 1000
    cpu = F.split_scan(RawScan(raw.xyz.cpu(), raw.valid.cpu()), cfg)
    assert torch.equal(img.count.cpu(), cpu.count)
    assert torch.equal(img.xyz.cpu(), cpu.xyz)


def test_raw_scan_steps_are_the_image_steps_on_the_card(dev):
    """full_step equals image_step on the card's split of the same scans,
    pose for pose; combined_step equals combined_image_step from the same
    states (the map's centroid sums land in a varying order on the card,
    so two free-running drives may part in the last bits)."""
    cfg = LiodomConfig(local_map_size=5, ring_width=2048)
    ccfg = cfg.replace(mapping=True)
    mcfg = MapConfig(map_capacity=131072, local_map_capacity=16384)
    world = BoxWorld(seed=1)
    pos, yaws = drive_trajectory(4, speed=1.0, yaw_rate=0.02)
    raws = [RawScan.from_points(world.render(pos[i], yaw_matrix(yaws[i]),
                                             width=900, noise=0.01, seed=i),
                                cfg.max_points) for i in range(4)]
    a = b = P.init_state(cfg)
    co, cm = S.init_combined(ccfg, mcfg)
    for i, raw in enumerate(raws):
        img = F.split_scan(raw, cfg)
        a, pa, na = P.full_step(a, raw.xyz, raw.valid, cfg)
        b, pb, nb = P.image_step(b, img.xyz, img.count, cfg)
        assert torch.equal(pa.q, pb.q) and torch.equal(pa.t, pb.t)
        assert torch.equal(na, nb)
        ro, rm, rp, rn = S.combined_step(co, cm, raw.xyz, raw.valid, ccfg,
                                         mcfg, step=i)
        co, cm, ip, in_ = S.combined_image_step(co, cm, img.xyz, img.count,
                                                ccfg, mcfg, step=i)
        assert torch.equal(rp.q, ip.q) and torch.equal(rp.t, ip.t)
        assert torch.equal(rn, in_) and torch.equal(rm.code, cm.code)


def test_voxel_downsample_on_the_card_is_the_cpu_result(dev):
    from liodom_tpu_torch.ops import voxel as V
    rng = np.random.default_rng(6)
    t = rng.uniform(0, 30, (28160, 1))
    d = rng.normal(size=(6, 3))
    xyz = (rng.normal(size=(28160, 3)) * 0.05
           + t * d[rng.integers(0, 6, 28160)]).astype(np.float32)
    valid = rng.random(28160) > 0.3
    cx, cv = V.voxel_downsample(torch.from_numpy(xyz),
                                torch.from_numpy(valid), 0.4)
    args = (torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev))
    V.voxel_downsample(*args, 0.4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gx, gv = V.voxel_downsample(*args, 0.4)
        gx2, _ = V.voxel_downsample(*args, 0.4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the leaves' sums run in sorted order on both devices: bit for bit
    assert torch.equal(gv.cpu(), cv) and int(cv.sum()) > 1000
    assert torch.equal(gx.cpu(), cx) and torch.equal(gx, gx2)


def test_stager_and_steps_make_no_host_sync(dev):
    """The apps' frame loop between due points: frames staged from pinned
    buffers and ``image_step`` on them, under torch's sync debug mode set to
    raise, more frames than the stager has slots; then one block fetch
    gives the poses of an ``image_step`` loop on plainly copied frames."""
    from liodom_tpu_torch.runtime.device_io import Stager, fetch_poses
    cfg, imgs = _images(6)
    host = [(im.xyz.numpy(), im.count.numpy()) for im in imgs]
    state = P.init_state(cfg)
    P.image_step(state, imgs[0].xyz.to(dev), imgs[0].count.to(dev), cfg)
    stager = Stager((cfg.scan_lines, cfg.ring_width, 3), dev, slots=2)
    pending = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, c in host:
            state, pose, ne = P.image_step(state, *stager.put(x, c), cfg)
            pending.append((pose.q, pose.t, ne))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mats, nes = fetch_poses(pending)
    ref, ref_ne = P.init_state(cfg), []
    for im in imgs:
        ref, pose, ne = P.image_step(ref, im.xyz.to(dev), im.count.to(dev),
                                     cfg)
        ref_ne.append(int(ne))
        assert np.array_equal(mats[len(ref_ne) - 1],
                              pose.matrix().cpu().double().numpy())
    assert nes.tolist() == ref_ne


def test_captured_image_step_equals_eager_and_keeps_outputs(dev):
    """``runtime/aot.get_or_compile``: ``image_step`` captured as a CUDA
    graph gives the eager step's poses and edge counts bit for bit, frame
    after frame, and poses kept across calls stay distinct (each call
    returns tensors the next does not write)."""
    from liodom_tpu_torch.runtime import aot
    cfg, imgs = _images(6)
    imgs = [RingImage(im.xyz.to(dev), im.count.to(dev)) for im in imgs]
    state = P.init_state(cfg)

    def fn(s, x, c):
        return P.image_step(s, x, c, cfg)

    step = aot.get_or_compile("test_image_step", fn,
                              (state, imgs[0].xyz, imgs[0].count),
                              extra=str(cfg))
    assert step is not fn                   # a graph, not the eager step
    eager, graph, kept = P.init_state(cfg), state, []
    for im in imgs:
        eager, ep, en = P.image_step(eager, im.xyz, im.count, cfg)
        graph, gp, gn = step(graph, im.xyz, im.count)
        assert torch.equal(gp.q, ep.q) and torch.equal(gp.t, ep.t)
        assert torch.equal(gn, en)
        kept.append((gp.t, ep.t))
    for g, e in kept:
        assert torch.equal(g, e)
    assert len({tuple(g.tolist()) for g, _ in kept[1:]}) == len(kept) - 1
    with pytest.raises(ValueError):
        step(graph, imgs[0].xyz[:, :8], imgs[0].count)


def test_captured_combined_step_refresh_patterns(dev):
    """``combined_image_step`` at cadence 4, one graph for a refreshing
    frame and one for the others: within 1 cm of the eager drive (the
    map's centroid sums land in atomic order) with equal edge counts."""
    from liodom_tpu_torch.runtime import aot
    cfg, imgs = _images(6)
    cfg = cfg.replace(mapping=True)
    mcfg = MapConfig(map_capacity=131072, local_map_capacity=16384)
    imgs = [RingImage(im.xyz.to(dev), im.count.to(dev)) for im in imgs]
    odom, m = S.init_combined(cfg, mcfg)
    steps = {}
    for refresh in (True, False):
        def fn(o, mm, x, c, i=0 if refresh else 1):
            return S.combined_image_step(o, mm, x, c, cfg, mcfg, step=i,
                                         local_map_every=4)
        steps[refresh] = aot.get_or_compile(
            "test_combined", fn, (odom, m, imgs[0].xyz, imgs[0].count),
            extra=f"{cfg}|{mcfg}|refresh={refresh}")
    eo, em = odom, m
    go, gm = odom, m
    for i, im in enumerate(imgs):
        eo, em, ep, en = S.combined_image_step(eo, em, im.xyz, im.count, cfg,
                                               mcfg, step=i,
                                               local_map_every=4)
        go, gm, gp, gn = steps[i % 4 == 0](go, gm, im.xyz, im.count)
        assert torch.equal(gn, en)
        assert float((gp.t - ep.t).norm()) < 0.01
    assert int(gm.overflow) == int(em.overflow) == 0
    assert abs(int(gm.valid.sum()) - int(em.valid.sum())) <= \
        0.001 * int(em.valid.sum())


def test_update_map_full_is_reproducible_on_the_card(dev):
    """``update_map_full`` at ``resolution=0.1`` (not packable, the sorted
    soup): two calls on one input give every field ``torch.equal``, since
    each leaf's rows are summed in row order (``segment_reduce``), not in
    atomic order; and the result is the CPU path's to float32 rounding."""
    cfg, imgs = _images(4)
    mcfg = MapConfig(resolution=0.1, map_capacity=65536)
    assert not G.packable(mcfg)
    edges = [F.select_edges(im, F.smoothness(im, cfg), cfg) for im in imgs]
    poses = [Pose(torch.tensor([1.0, 0.0, 0.0, 0.0]),
                  torch.tensor([0.5 * i, 0.1 * i, 0.0])) for i in range(4)]
    m_cpu = G.init_map(65536, device="cpu")
    for e, p in zip(edges[:3], poses[:3]):
        m_cpu = G.update_map(m_cpu, e.xyz, e.valid, p, mcfg)
    m = G.MapState(*(t.to(dev) for t in m_cpu))
    e, p = edges[3], poses[3]
    args = (e.xyz.to(dev), e.valid.to(dev), Pose(p.q.to(dev), p.t.to(dev)),
            mcfg)
    a = G.update_map_full(m, *args)
    b = G.update_map_full(m, *args)
    for name in G.MapState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    c = G.update_map_full(m_cpu, e.xyz, e.valid, p, mcfg)
    assert torch.equal(a.valid.cpu(), c.valid)
    assert torch.equal(a.code.cpu(), c.code)
    assert float((a.xyz.cpu() - c.xyz).abs().max()) <= 1e-5
    assert int(a.valid.sum()) > 4000


def test_captured_batch_step_equals_eager(dev):
    """``batch_image_step`` at B = 4 captured by ``aot.get_or_compile``
    (K4 is ``knn_coords``' second entry point: nothing new to build): the
    eager step's poses and edge counts, bit for bit, frame after frame."""
    from liodom_tpu_torch.parallel.sharded import init_batch_state
    from liodom_tpu_torch.runtime import aot
    cfg, imgs = _images(5)
    b = 4
    # four distinct lanes: each a frame behind the previous
    xs = [torch.stack([imgs[max(i - s, 0)].xyz for s in range(b)]).to(dev)
          for i in range(len(imgs))]
    cs = [torch.stack([imgs[max(i - s, 0)].count for s in range(b)]).to(dev)
          for i in range(len(imgs))]

    def fn(s, x, c):
        return P.batch_image_step(s, x, c, cfg)

    step = aot.get_or_compile("test_batch_step", fn,
                              (init_batch_state(cfg, b), xs[0], cs[0]),
                              extra=f"{cfg}|B={b}")
    assert step is not fn
    eager = graph = init_batch_state(cfg, b)
    for x, c in zip(xs, cs):
        eager, ep, en = P.batch_image_step(eager, x, c, cfg)
        graph, gp, gn = step(graph, x, c)
        assert torch.equal(gp.q, ep.q) and torch.equal(gp.t, ep.t)
        assert torch.equal(gn, en)


def test_captured_sharded_step_on_a_one_rank_nccl_group(dev):
    """The sharded flagship captured on a one-rank NCCL group (its
    communicators made before the capture; K5 prepared by
    ``path_kernels(True, sharded=True)``): within 1 cm and 1e-3 rad of the
    eager step, equal edge counts."""
    import socket

    import torch.distributed as dist
    from liodom_tpu_torch.parallel import combined as CB
    from liodom_tpu_torch.parallel import launch
    from liodom_tpu_torch.parallel.mesh import make_mesh
    from liodom_tpu_torch.parallel.sharded import all_gather
    from liodom_tpu_torch.runtime import aot
    from liodom_tpu_torch.runtime.device_io import path_kernels
    cfg, imgs = _images(6)
    cfg = cfg.replace(mapping=True)
    mcfg = MapConfig(map_capacity=131072, local_map_capacity=16384)
    imgs = [RingImage(im.xyz.to(dev), im.count.to(dev)) for im in imgs]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        one = torch.ones(1, device=dev)
        for group in mesh.get_all_groups():
            all_gather(one, group, 1)
            dist.all_reduce(one, group=group)
        sstep = CB.make_sharded_combined_image_step(mesh, cfg, mcfg)
        init = CB.init_combined_image_sharded(cfg, mcfg, mesh)
        step = aot.get_or_compile(
            "test_sharded_step", sstep, init + (imgs[0].xyz, imgs[0].count),
            extra=f"{cfg}|{mcfg}|sharded",
            kernel_names=path_kernels(True, sharded=True))
        assert step is not sstep
        es, em = gs, gm = init
        for im in imgs:
            es, em, ep, en = sstep(es, em, im.xyz, im.count)
            gs, gm, gp, gn = step(gs, gm, im.xyz, im.count)
            assert torch.equal(gn, en)
            assert float((gp.t - ep.t).norm()) < 0.01
            dq = float((gp.q - ep.q).abs().max())
            assert dq < 1e-3
        assert int(gm.overflow) == int(em.overflow) == 0
    finally:
        dist.destroy_process_group()


def test_bench_stages_graphs_equal_their_eager_stages(dev):
    """``tools/bench_stages``: every stage graph (and each fused graph)
    replays to the eager call's outputs, ``torch.equal``; every row is
    timed, eager and as a graph."""
    from liodom_tpu_torch.tools import bench_stages as BS
    out = BS.run("cuda", frames=6, width=900, ring_width=2048, reps=3)
    assert out["graph_equal"] and all(out["graph_equal"].values()), \
        out["graph_equal"]
    for name, row in out["stage_ms"].items():
        assert row["eager_ms"] > 0 and row["graph_ms"] > 0, name
    for key in ("odom_ms", "combined_ms"):
        assert out[key]["graph_equals_eager"]
        assert out[key]["chained_graph_poses_equal"]


def test_bench_graph_rows_pass_their_gates(dev):
    """``tools/bench`` at a small size (900 columns, ring width 2,048, 2 + 4
    frames, chunks of 3 so that the chained combined course meets two
    refresh phases, B = 2): every row present, no gate failed (each graph
    against its eager run: ``torch.equal`` for the odometry, window-15,
    Ouster and batch rows, <= 1e-6 m for the combined ones; the chained
    rows within 1e-3 m of their per-frame runs), no truncation or
    overflow, every rate finite, eager and graph."""
    import math
    from liodom_tpu_torch.tools import bench as B
    lines = []
    out = B.run(width=900, ring_width=2048, n_warm=2, n_bench=4,
                map_capacity=131072, local_map_capacity=8192, batches=(2,),
                chunk=3, reps=2, emit=lines.append)
    assert [r["metric"] for r in out["rows"]] == [
        "odometry_scans_per_s_1chip", "odometry_scans_per_s_chained",
        "odometry_scans_per_s_window15", "ouster_scans_per_s",
        "combined_scans_per_s_1chip", "combined_scans_per_s_chained",
        "batched_odometry_scans_per_s_B2"]
    assert not out["warnings"]
    for row in out["rows"]:
        assert not row.get("parity_failed"), row
        assert math.isfinite(row["value"]) and row["value"] > 0, row
        assert math.isfinite(row["eager_value"]) and row["eager_value"] > 0
    for name, modes in out["poses"].items():
        g, e = modes["graph"][-1], modes["eager"][-1]
        if name.startswith("combined"):
            assert float((g.t - e.t).norm()) <= B.COMBINED_PARITY_TOL_M
        else:
            assert torch.equal(g.t, e.t) and torch.equal(g.q, e.q), name
    final = out["final"]
    assert lines[-1] is final
    assert not any(k.endswith("_skipped") or "parity" in k for k in final)
    assert "combined_async_scans_per_s" in final
    assert "," in final["card"]          # nvidia-smi: name, power limit
    assert final["build_s"] is not None and final["build_s"] >= 0


def _lm_lanes(seed, b, e, dev, k=None):
    """B lanes of e correspondences (edges 5-60 m out, lines through their
    true world points, ~10 % invalid) and a start ~0.6 m and 0.1 rad off;
    with ``k``, lpa and lpb are the first two rows of a (B, e, k, 3)
    tensor, as the line fit hands them over."""
    rng = np.random.default_rng(seed)
    ang, rad = rng.uniform(0, 2 * np.pi, (b, e)), rng.uniform(5, 60, (b, e))
    cp = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                   rng.uniform(-2, 4, (b, e))], -1)
    rot = np.stack([yaw_matrix(y) for y in rng.uniform(-0.5, 0.5, b)])
    world = np.einsum("bij,bej->bei", rot, cp) + [1.0, -0.5, 0.1]
    d = rng.normal(size=(b, e, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    off = rng.normal(size=(b, e, 3)) * 0.02
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    lpa, lpb = f32(world + off + 0.3 * d), f32(world + off - 0.4 * d)
    if k is not None:
        near = torch.stack([lpa, lpb] + [lpa] * (k - 2), -2)
        lpa, lpb = near[..., 0, :], near[..., 1, :]
    q0 = np.zeros((b, 4))
    q0[:, 0], q0[:, 3] = np.cos(0.05), np.sin(0.05)
    return (Pose(f32(q0), f32(np.tile([1.5, -0.8, 0.15], (b, 1)))), f32(cp),
            lpa, lpb, torch.tensor(rng.random((b, e)) > 0.1, device=dev))


@pytest.mark.parametrize("b, e, k", [(1, 5632, None), (8, 5632, 5),
                                     (1, 37, None), (2, 40000, 5)])
def test_lm_solve_kernel_against_the_plain_version(dev, b, e, k):
    """One launch a call; within 1e-3 m and 1e-3 rad of ``lm_solve_plain``
    on the card (the sums over edges in another order); a rerun and each
    lane's solo call bit for bit; no valid correspondence holds the
    pose."""
    from liodom_tpu_torch.ops import solver as SLV
    pose, cp, lpa, lpb, valid = _lm_lanes(e + b, b, e, dev, k)
    kw = dict(min_range=3.0, max_range=75.0)
    before = _launched("liodom_lm_solve")[0]
    got = SLV.lm_solve(pose, cp, lpa, lpb, valid, **kw)
    assert _launched("liodom_lm_solve")[0] == before + 1
    want = SLV.lm_solve_plain(pose, cp, lpa, lpb, valid, **kw)
    assert float((got.t - want.t).norm(dim=-1).max()) < 1e-3
    assert float((got.q - want.q).abs().max()) < 1e-3
    assert float((got.t - pose.t).norm(dim=-1).min()) > 0.05
    again = SLV.lm_solve(pose, cp, lpa, lpb, valid, **kw)
    assert torch.equal(again.q, got.q) and torch.equal(again.t, got.t)
    for i in range(b):
        one = SLV.lm_solve(Pose(pose.q[i], pose.t[i]), cp[i], lpa[i],
                           lpb[i], valid[i], **kw)
        assert torch.equal(one.q, got.q[i]) and torch.equal(one.t, got.t[i])
    held = SLV.lm_solve(pose, cp, lpa, lpb, torch.zeros_like(valid), **kw)
    assert torch.equal(held.q, pose.q) and torch.equal(held.t, pose.t)


def test_lm_solve_with_a_group_on_the_card_stays_plain(dev):
    """A call with a process group (here one NCCL rank) all-reduces between
    rounds: the plain version, no launch, the kernel's pose within 1e-3 m."""
    import socket

    import torch.distributed as dist
    from liodom_tpu_torch.ops import solver as SLV
    from liodom_tpu_torch.parallel import launch
    pose, cp, lpa, lpb, valid = _lm_lanes(3, 1, 2000, dev)
    pose, cp, lpa, lpb, valid = (Pose(pose.q[0], pose.t[0]), cp[0], lpa[0],
                                 lpb[0], valid[0])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        kw = dict(min_range=3.0, max_range=75.0)
        before = _launched("liodom_lm_solve")[0]
        got = SLV.lm_solve(pose, cp, lpa, lpb, valid, group=dist.group.WORLD,
                           **kw)
        assert _launched("liodom_lm_solve")[0] == before
        want = SLV.lm_solve(pose, cp, lpa, lpb, valid, **kw)
        assert float((got.t - want.t).norm()) < 1e-3
    finally:
        dist.destroy_process_group()
