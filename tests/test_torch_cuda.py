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
            torch.from_numpy(scan), cfg.max_points), cfg))
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
    before = SEL.select_edges_cuda.launches
    got = SEL.select_edges_cuda(img, sm, cfg)
    assert SEL.select_edges_cuda.launches == before + 1
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


def _tie_prep(dev, radius):
    lanes = [tie_scene(s, 3000, 20000) for s in range(2)]
    q, qm, r, rm = (torch.from_numpy(np.stack([ln[i] for ln in lanes]))
                    .to(dev) for i in range(4))
    return KNN.knn_prepare_batched(q, qm, r, rm, radius), r.shape[1]


@pytest.mark.parametrize("k", [3, 8])
def test_knn_kernels_at_k_bit_exact(dev, k):
    """K3, K4, K5 and K6 at k = 3 and 8 on a tie-heavy lattice (two pairs):
    d2, coordinates, indices and endpoints bit for bit against the keyed
    (d2, index) selection; K6's gate flips only at the ratio boundary."""
    prep, m = _tie_prep(dev, 1.0)
    d_b, c_b = KNN.knn_launch_batched(*prep, k=k)
    d_o, c_o = KNN.knn_launch_plain(*prep, k=k)
    assert d_b.shape == (2, 3000, k)
    assert torch.equal(d_b, d_o) and torch.equal(c_b, c_o)
    solo = tuple(t[0] for t in prep)
    d_s, c_s = KNN.knn_launch(*solo, k=k)
    assert torch.equal(d_s, d_o[0]) and torch.equal(c_s, c_o[0])
    got = KNN.knn_lines_launch(*prep, 1.0, 3.0, 0.01, k=k)
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
    d5, i5 = KNN.knn_index_launch(*prep5, m, k=k)
    d5_o, i5_o = KNN.knn_index_launch_plain(*prep5, m, k=k)
    assert d5.shape == (2, 3000, k)
    assert torch.equal(d5, d5_o) and torch.equal(i5, i5_o)


def test_knn_index_is_one_kernel_launch(dev):
    """K5 is one kernel a call: no merge kernel, no partial lists."""
    from torch.profiler import ProfilerActivity, profile
    prep5, m = _tie_prep(dev, None)
    KNN.knn_index_launch(*prep5, m)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        KNN.knn_index_launch(*prep5, m)
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
    before = KNN.knn_launch_batched.launches
    d_b, c_b = KNN.knn_coords_batched_cuda(q, qm, r, rm, max_radius=1.0)
    assert KNN.knn_launch_batched.launches == before + 1
    d_p, c_p = KNN.knn_coords_batched_plain(q, qm, r, rm)
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
        before = KNN.knn_index_launch.launches
        d_b, i_b = KNN.knn_index_cuda(q, qm, r, rm, max_radius=radius)
        assert KNN.knn_index_launch.launches == before + 1
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
    for prep in (KNN.knn_prepare(q[0], qm[0], r[0], rm[0], 1.0),
                 KNN.knn_prepare_batched(q, qm, r, rm, 1.0)):
        batched = prep[2].ndim == 3
        launch = KNN.knn_launch_batched if batched else KNN.knn_launch
        d_k, c_k = launch(*prep)
        d_o, c_o = KNN.knn_launch_plain(*prep)
        assert torch.equal(d_k, d_o) and torch.equal(c_k, c_o)
        tied = ((d_o[..., 1:] < 1.0) & (d_o.diff(dim=-1) == 0)).any(-1)
        assert int(tied.sum()) > 1000
        prep_l = prep if batched else tuple(x[None] for x in prep)
        got = KNN.knn_lines_launch(*prep_l, 1.0, 3.0, 0.01)
        want = KNN.knn_lines_launch_plain(*prep_l, 1.0, 3.0, 0.01)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        near = c_o if batched else c_o[None]
        zm = near - near.mean(dim=-2, keepdim=True)
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
        before = KNN.knn_lines_launch.launches
        got = KNN.knn_lines_cuda(*args)
        assert KNN.knn_lines_launch.launches == before + 1
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


def test_local_map_compact_kernel_bit_exact(dev):
    mcfg, m = _map_on(dev)
    offs = G.local_map_offsets(mcfg)
    for position in ((3.0, -2.0, 0.5), (45.0, 41.0, 3.0), (900.0, 0.0, 0.0)):
        base = G.cell_keys(torch.trunc(torch.tensor(position, device=dev)),
                           mcfg)
        for cap in (16, 4096, 16384, 70000):
            got = K7.compact_hits_cuda(m.xyz, m.key, m.valid, base, offs, cap)
            want = K7.compact_hits_plain(m.xyz, m.key, m.valid, base, offs,
                                         cap)
            assert int(got[2]) == int(want[2])
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    n_hits = int(K7.compact_hits_cuda(m.xyz, m.key, m.valid,
                                      G.cell_keys(torch.zeros(3, device=dev),
                                                  mcfg), offs, 16)[2])
    assert n_hits > 1000


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
        got = PI.probe_insert_cuda(tab, code, active)
        want = PI.probe_insert_plain(tab, code, active)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if n_tab == 256:
            assert bool(got[3].any())          # exhausted _MAX_PROBES


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
