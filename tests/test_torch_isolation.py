"""The port stands alone: it imports neither jax nor liodom_tpu, its entry
points default to CUDA and raise without it, and a CPU tensor takes each
kernel's plain version without touching a launch counter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.mapping import service as S
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import compact_pallas as K7
from liodom_tpu_torch.ops import knn_pallas as KNN
from liodom_tpu_torch.ops import probe_insert as PI
from liodom_tpu_torch.ops import select_pallas as SEL
from liodom_tpu_torch.ops import smoothness_pallas as SM
from liodom_tpu_torch.parallel.sharded import init_batch_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import liodom_tpu_torch
names = [m.name for m in pkgutil.walk_packages(liodom_tpu_torch.__path__,
                                               "liodom_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "liodom_tpu"))
print(json.dumps({"modules": names, "bad": bad,
                  "built": sorted(liodom_tpu_torch.kernels._libs)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["built"] == []          # importing builds and loads nothing
    for name in ("odometry.pipeline", "ops.knn_pallas", "ops.compact_pallas",
                 "ops.probe_insert", "mapping.grid", "mapping.service",
                 "parallel.sharded", "convert"):
        assert f"liodom_tpu_torch.{name}" in res["modules"]


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints no
    result; alone in a directory it cannot even import the port."""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    if not torch.cuda.is_available():
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_default_to_cuda():
    cfg = LiodomConfig(ring_width=256)
    if torch.cuda.is_available():
        assert P.init_state(cfg).odom.t.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.init_state(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    assert P.init_state(cfg, device="cpu").odom.t.device.type == "cpu"
    mcfg = MapConfig(map_capacity=64, local_map_capacity=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            G.init_map(64)
        with pytest.raises(RuntimeError, match="CUDA"):
            S.MappingService(mcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            S.init_combined(cfg.replace(mapping=True), mcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_batch_state(cfg, 2)
    assert G.init_map(64, device="cpu").code.device.type == "cpu"
    assert init_batch_state(cfg, 2, device="cpu").odom.t.shape == (2, 3)


def _counts():
    return (SM.smoothness_cuda.launches, SEL.select_edges_cuda.launches,
            KNN.knn_launch.launches, KNN.knn_launch_batched.launches,
            KNN.knn_lines_launch.launches, K7.compact_hits_cuda.launches,
            PI.probe_insert_cuda.launches)


def test_cpu_tensors_take_the_plain_versions():
    before = _counts()
    rng = np.random.default_rng(0)
    cfg = LiodomConfig(ring_width=256)
    xyz = torch.from_numpy((rng.normal(size=(64, 256, 3)) * 5)
                           .astype(np.float32))
    count = torch.full((64,), 200, dtype=torch.int32)
    sm = SM.smoothness_kernel(xyz, count)
    assert torch.equal(sm, SM.smoothness_plain(xyz, count))
    ec = SEL.select_edges_kernel(RingImage(xyz, count), sm, cfg)
    ref = SEL.select_edges_plain(RingImage(xyz, count), sm, cfg)
    assert torch.equal(ec.xyz, ref.xyz) and torch.equal(ec.valid, ref.valid)
    q, r = xyz[0], xyz[1]
    qm = torch.ones(256, dtype=torch.bool)
    d, c = KNN.knn_coords(q, qm, r, qm, max_radius=1.0)
    d0, c0 = KNN.knn_coords_plain(q, qm, r, qm)
    assert torch.equal(d, d0) and torch.equal(c, c0)
    qb, rb, qmb = torch.stack([q, r]), torch.stack([r, q]), torch.stack([qm,
                                                                         qm])
    d, c = KNN.knn_coords_batched(qb, qmb, rb, qmb, max_radius=1.0)
    d0, c0 = KNN.knn_coords_batched_plain(qb, qmb, rb, qmb)
    assert torch.equal(d, d0) and torch.equal(c, c0)
    for args in ((q, qm, r, qm), (qb, qmb, rb, qmb)):
        got = KNN.knn_lines(*args, max_sq_dist=4.0)
        want = KNN.knn_lines_plain(*args, max_sq_dist=4.0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    mcfg = MapConfig(voxel_xysize=20.0, voxel_zsize=25.0)
    ones = torch.ones(256, dtype=torch.bool)
    m = G.update_map(G.init_map(4096, device="cpu"), xyz[0], ones,
                     Pose.identity(), mcfg)
    code = G._packed_codes(xyz[2], ones, mcfg)
    got = PI.probe_insert(m.code, code, ones)
    want = PI.probe_insert_plain(m.code, code, ones)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    lx, lv, n = G.get_local_map(m, torch.zeros(3), mcfg, capacity=64)
    base = G.cell_keys(torch.zeros(3), mcfg)
    want = K7.compact_hits_plain(m.xyz, m.key, m.valid, base,
                                 G.local_map_offsets(mcfg), 64)
    assert torch.equal(lx, want[0]) and int(n) == int(want[2]) > 0
    assert _counts() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    cfg = LiodomConfig(ring_width=256)
    xyz = torch.zeros((64, 256, 3))
    count = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        SM.smoothness_cuda(xyz, count)
    with pytest.raises(ValueError):
        SEL.select_edges_cuda(RingImage(xyz, count), torch.zeros(64, 256),
                              cfg)
    q4 = torch.zeros((64, 4))
    with pytest.raises(ValueError):
        KNN.knn_launch(q4, torch.zeros((512, 4)),
                       torch.zeros((1, 1), dtype=torch.int32),
                       torch.zeros(64, dtype=torch.int32))
    prep = (q4[None], torch.zeros((1, 512, 4)),
            torch.zeros((1, 1, 1), dtype=torch.int32),
            torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        KNN.knn_launch_batched(*prep)
    with pytest.raises(ValueError):
        KNN.knn_lines_launch(*prep, 1.0, 3.0, 0.01)
    with pytest.raises(ValueError):
        KNN.knn_coords_batched_cuda(q4[None, :, :3], q4[None, :, 0] > 0,
                                    q4[None, :, :3], q4[None, :, 0] > 0)
    m = G.init_map(64, device="cpu")
    with pytest.raises(ValueError):
        K7.compact_hits_cuda(m.xyz, m.key, m.valid,
                             torch.zeros(3, dtype=torch.int32),
                             np.zeros((27, 3), np.int32), 16)
    with pytest.raises(ValueError):
        PI.probe_insert_cuda(m.code, m.code[:8],
                            torch.ones(8, dtype=torch.bool))


def test_kernel_libraries_are_keyed_by_source():
    a = kernels.library_path("smoothness", "/usr/local/cuda/bin/nvcc")
    b = kernels.library_path("select", "/usr/local/cuda/bin/nvcc")
    assert a.parent == kernels.BUILD_DIR and a.name.startswith("smoothness-")
    assert a != b
    assert set(kernels.SOURCES) == {p.stem for p in kernels.CSRC.glob("*.cu")}
