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
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import knn_pallas as KNN
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
