"""The port stands alone: it imports neither jax nor liodom_tpu (nor does a
``parallel.launch`` run), its entry points and apps default to CUDA and
raise without it, and a CPU tensor takes each kernel's plain version without
touching a launch counter."""

import ctypes
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
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
from liodom_tpu_torch.ops import voxel as V
from liodom_tpu_torch.parallel import combined as CB
from liodom_tpu_torch.parallel import launch
from liodom_tpu_torch.parallel.mesh import make_mesh
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
                 "ops.probe_insert", "ops.voxel", "core.organize",
                 "mapping.grid", "mapping.service",
                 "parallel.mesh", "parallel.sharded", "parallel.sharded_map",
                 "parallel.combined", "parallel.launch", "convert",
                 "core.io", "core.presets", "runtime.native",
                 "runtime.stats", "runtime.publisher", "runtime.channels",
                 "runtime.viz", "runtime.tracer", "runtime.checkpoint",
                 "runtime.logging_config", "runtime.device_io",
                 "apps.run_kitti", "apps.run_synthetic", "apps.run_ouster",
                 "apps.run_mapping", "apps.run_stream", "apps.run_longcourse",
                 "runtime.aot", "runtime.cache"):
        assert f"liodom_tpu_torch.{name}" in res["modules"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_LAUNCH = """
import json, runpy, sys
sys.argv = ["launch", "--coordinator", "127.0.0.1:%d", "--num-processes", "1",
            "--process-id", "0", "--device", "cpu", "smoke"]
try:
    runpy.run_module("liodom_tpu_torch.parallel.launch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "liodom_tpu"))
print(json.dumps({"bad": bad}))
"""


def test_launch_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _LAUNCH % _free_port()],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "smoke step OK" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


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


def test_apps_default_to_cuda(tmp_path):
    """Each app runs on CUDA unless ``--device cpu``: without a card and
    that flag it raises before it reads any input; so does arming the span
    recorder without naming a device."""
    from liodom_tpu_torch.apps import (run_kitti, run_mapping, run_ouster,
                                       run_synthetic)
    from liodom_tpu_torch.runtime import tracer
    argvs = ((run_kitti, ["--root", str(tmp_path)]),
             (run_mapping, ["--root", str(tmp_path), "--poses", "p.txt"]),
             (run_ouster, ["--synthetic"]), (run_synthetic, []))
    for app, argv in argvs:
        assert app.parse_args(argv).device is None
        assert app.parse_args(argv + ["--device", "cpu"]).device == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                app.main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tracer.arm()
        assert not tracer.RECORDER.on


def test_stream_and_longcourse_apps_default_to_cuda(tmp_path):
    """``run_stream`` and ``run_longcourse`` run on CUDA unless ``--device
    cpu``; without a card and that flag they raise before they render or
    read a frame."""
    from liodom_tpu_torch.apps import run_longcourse, run_stream
    for app, argv in ((run_stream, []), (run_stream, ["--root",
                                                      str(tmp_path)]),
                      (run_longcourse, []), (run_longcourse, ["--chunk",
                                                              "12"])):
        assert app.parse_args(argv).device is None
        assert app.parse_args(argv + ["--device", "cpu"]).device == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                app.main(argv)


def test_raw_scan_entry_points_default_to_cuda():
    """The raw-scan path: ``RawScan.from_points`` puts the scan on CUDA
    unless told otherwise (and raises without it), and ``full_step``,
    ``combined_step`` and ``extract_features`` run where their inputs lie;
    a scan on another device than the state is refused."""
    cfg = LiodomConfig(ring_width=256, max_points=512)
    pts = np.zeros((100, 3), np.float32)
    if torch.cuda.is_available():
        assert RawScan.from_points(pts, 512).xyz.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            RawScan.from_points(pts, 512)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.init_state(cfg.replace(filter_local_map=True))
    raw = RawScan.from_points(pts, 512, device="cpu")
    assert raw.xyz.device.type == "cpu" and int(raw.valid.sum()) == 100
    assert F.extract_features(raw, cfg).xyz.device.type == "cpu"
    state = P.init_state(cfg, device="cpu")
    assert P.full_step(state, raw.xyz, raw.valid, cfg)[1].t.device.type == \
        "cpu"
    mcfg = MapConfig(map_capacity=64, local_map_capacity=16)
    ccfg = cfg.replace(mapping=True)
    odom, m = S.init_combined(ccfg, mcfg, device="cpu")
    assert S.combined_step(odom, m, raw.xyz, raw.valid, ccfg,
                           mcfg)[2].t.device.type == "cpu"
    meta = raw.xyz.to("meta")
    with pytest.raises(ValueError):
        P.full_step(state, meta, raw.valid, cfg)
    with pytest.raises(ValueError):
        S.combined_step(odom, m, meta, raw.valid, ccfg, mcfg)


def test_parallel_entry_points_default_to_cuda():
    """make_mesh, initialize and the composed steps' init functions run on
    CUDA unless told otherwise, and raise without it; on the CPU they take
    gloo (a one-rank group in this process)."""
    import torch.distributed as dist
    cfg = LiodomConfig(ring_width=256, mapping=True)
    mcfg = MapConfig(map_capacity=64, local_map_capacity=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.initialize("127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, 1)
    assert not dist.is_initialized()
    launch.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        launch.initialize(None, None, None, device="cpu")   # idempotent
        mesh = make_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="mesh 2x1"):
            make_mesh(2, 1, device="cpu")
        for init in (CB.init_combined_sharded,
                     CB.init_combined_image_sharded):
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="CUDA"):
                    init(cfg, mcfg, mesh)
            st, ms = init(cfg, mcfg, mesh, device="cpu")
            assert ms.xyz.device.type == "cpu" and ms.xyz.shape == (64, 3)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="coordinator"):
        launch.initialize(None, None, None, device="cpu")


def test_cpu_tensors_take_the_plain_versions():
    before = kernels.launch_counts()
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
    d, c = KNN.knn_coords(qb, qmb, rb, qmb, max_radius=1.0)
    d0, c0 = KNN.knn_coords_plain(qb, qmb, rb, qmb)
    assert torch.equal(d, d0) and torch.equal(c, c0)
    for args in ((q, qm, r, qm), (qb, qmb, rb, qmb)):
        got = KNN.knn_lines(*args, max_sq_dist=4.0)
        want = KNN.knn_lines_plain(*args, max_sq_dist=4.0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for args in ((q, qm, r, qm), (qb, qmb, rb, qmb)):
        got = NB.knn_auto(*args)
        want = KNN.knn_index_plain(*args)
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
    # the raw-scan path and the voxel filter: plain versions only
    pts = xyz.reshape(-1, 3)[:4000] * 4.0
    raw = RawScan.from_points(pts, 4096, device="cpu")
    assert F.extract_features(raw, cfg).xyz.device.type == "cpu"
    fcfg = cfg.replace(filter_local_map=True, local_map_size=1,
                       max_points=4096)
    P.full_step(P.init_state(fcfg, device="cpu"), raw.xyz, raw.valid, fcfg)
    ocfg = cfg.replace(lidar_type=1)
    P.full_step(P.init_state(ocfg, device="cpu"), xyz * 4.0, raw.valid, ocfg)
    ccfg = fcfg.replace(mapping=True, filter_local_map=False)
    S.combined_step(*S.init_combined(ccfg, mcfg.replace(map_capacity=4096),
                                     device="cpu"),
                    raw.xyz, raw.valid, ccfg, mcfg.replace(map_capacity=4096))
    V.voxel_downsample(pts, torch.ones(4000, dtype=torch.bool), 0.4)
    assert kernels.launch_counts() == before


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
    with pytest.raises(ValueError):         # one pair's layout, not a batch
        KNN.knn_launch("knn_coords", q4, torch.zeros((512, 4)),
                       torch.zeros((1, 1), dtype=torch.int32),
                       torch.zeros(64, dtype=torch.int32))
    prep = (q4[None], torch.zeros((1, 512, 4)),
            torch.zeros((1, 1, 1), dtype=torch.int32),
            torch.zeros((1, 64), dtype=torch.int32))
    for source, extra in (("knn_coords", {}),
                          ("knn_lines", {"floats": (1.0, 3.0, 1e-4)}),
                          ("knn_index", {"ints": (512,)})):
        with pytest.raises(ValueError):
            KNN.knn_launch(source, *prep, **extra)
    pts = (q4[None, :, :3], q4[None, :, 0] > 0, q4[None, :, :3],
           q4[None, :, 0] > 0)
    for wrapper in (KNN.knn_coords_cuda, KNN.knn_lines_cuda,
                    KNN.knn_index_cuda):
        with pytest.raises(ValueError):
            wrapper(*pts)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        kernels.launch("liodom_smoothness", xyz.device)
    m = G.init_map(64, device="cpu")
    with pytest.raises(ValueError):
        K7.compact_hits_cuda(m.xyz, m.key, m.valid,
                             torch.zeros(3, dtype=torch.int32),
                             np.zeros((27, 3), np.int32), 16)
    # above the targets shared memory holds: the device path's own check
    with pytest.raises(ValueError, match="one CUDA device"):
        K7.compact_hits_cuda(m.xyz, m.key, m.valid,
                             torch.zeros(3, dtype=torch.int32),
                             np.zeros((K7.MAX_TARGETS + 1, 3), np.int32), 16)
    with pytest.raises(ValueError):
        PI.probe_insert_cuda(m.code, m.code[:8],
                            torch.ones(8, dtype=torch.bool))


def _c_entry_points(source: str) -> dict:
    """``{symbol: [ctypes type of each parameter]}`` of every ``extern "C"``
    function in ``csrc/<source>.cu``, read from its text."""
    text = (kernels.CSRC / f"{source}.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for p in params.split(","):
            decl = " ".join(p.split()[:-1]) if "*" not in p else "*"
            types.append({"*": ctypes.c_void_p, "int": ctypes.c_int,
                          "float": ctypes.c_float,
                          "long long": ctypes.c_longlong}[decl])
        out[name] = types
    return out


def test_kernel_abi_table_matches_the_sources():
    """``kernels.ABI`` is the C interface of ``csrc/``: every entry point it
    lists is an ``extern "C" int`` of its source with as many parameters
    of the same types (pointers as ``c_void_p``), and no ``extern "C"``
    function of a source is left out of it."""
    for source in kernels.SOURCES:
        assert kernels.ABI[source] == _c_entry_points(source), source
        assert all(len(a) > 0 for a in kernels.ABI[source].values())


def test_kernel_libraries_are_keyed_by_source():
    a = kernels.library_path("smoothness", "/usr/local/cuda/bin/nvcc")
    b = kernels.library_path("select", "/usr/local/cuda/bin/nvcc")
    assert a.parent == kernels.BUILD_DIR and a.name.startswith("smoothness-")
    assert a != b
    assert set(kernels.SOURCES) == {p.stem for p in kernels.CSRC.glob("*.cu")}
