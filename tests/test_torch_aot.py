"""The warm start of the port (``runtime/aot.py``, ``runtime/cache.py``) on
the CPU: the tag's identity rules (JAX's ``_tag``: the name, the torch
version, the device kind, every leaf's shape and dtype, ``extra``), the
CPU route of ``get_or_compile`` (``fn`` after one warm call, no graph;
for ``image_step``, ``batch_image_step`` and the sharded flagship on a
one-rank gloo group in a process of its own),
``run_kitti --aot`` equal to the eager run (per frame, in chunks, with the
map), ``run_ouster --aot`` likewise, and the library directory that
``enable_persistent_cache`` resolves.  The CUDA graph itself is held to
the eager step on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.apps import run_kitti, run_ouster
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.runtime import aot, cache

torch.set_num_threads(1)

CFG = LiodomConfig(ring_width=256, local_map_size=3)


def _args(shape=(64, 256, 3), dtype=torch.float32):
    return (P.init_state(CFG, device="cpu"), torch.zeros(shape, dtype=dtype),
            torch.zeros((64,), dtype=torch.int32))


def test_tags_differ_by_extra_shape_and_dtype_only():
    base = aot._tag("step", _args(), "cfg")
    assert base == aot._tag("step", _args(), "cfg")
    assert base.startswith("step-")
    assert aot._tag("step", _args(), "other") != base
    assert aot._tag("other", _args(), "cfg") != base
    assert aot._tag("step", _args(shape=(64, 512, 3)), "cfg") != base
    assert aot._tag("step", _args(dtype=torch.float64), "cfg") != base
    # a baked-in host value is part of the identity
    assert (aot._tag("step", _args() + (0,), "cfg")
            != aot._tag("step", _args() + (1,), "cfg"))
    with pytest.raises(ValueError, match="device"):
        aot._tag("step", (1, 2), "")


def test_cpu_route_returns_fn_results():
    """On the CPU, ``get_or_compile`` returns ``fn`` itself after one warm
    call, from the registry on a second request; its results are
    ``image_step``'s."""
    calls = []

    def fn(s, x, c):
        calls.append(1)
        return P.image_step(s, x, c, CFG)

    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.normal(size=(64, 256, 3)).astype(np.float32)
                           * 20.0)
    cnt = torch.full((64,), 200, dtype=torch.int32)
    extra = "test_cpu_route_returns_fn_results"
    got = aot.get_or_compile("cpu_route", fn, _args(), extra=extra)
    assert got is fn and len(calls) == 1
    assert aot.get_or_compile("cpu_route", fn, _args(), extra=extra) is fn
    assert len(calls) == 1
    state = P.init_state(CFG, device="cpu")
    a = got(state, img, cnt)
    b = P.image_step(state, img, cnt, CFG)
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    assert torch.equal(a[2], b[2])


def _drive(cfg, n, width=240, seed=2):
    """``n`` BoxWorld ring images (numpy) at ``cfg``, split by the port's
    CPU split."""
    from liodom_tpu_torch.core.frame import RawScan
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             yaw_matrix)
    from liodom_tpu_torch.ops import features as F
    world = BoxWorld(seed=seed)
    pos, yaws = drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    xs, cs = [], []
    for i in range(n):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=width,
                            noise=0.01, seed=i)
        img = F.split_scan(RawScan.from_points(
            torch.from_numpy(scan), cfg.max_points, device="cpu"), cfg)
        xs.append(img.xyz.numpy())
        cs.append(img.count.numpy())
    return np.stack(xs), np.stack(cs)


def test_cpu_route_batch_image_step():
    """``batch_image_step`` (B = 2) through ``get_or_compile``'s CPU route:
    ``fn`` after one warm call, and its poses and edge counts over 3
    frames are the direct calls', bit for bit."""
    from liodom_tpu_torch.parallel.sharded import init_batch_state
    xs, cs = _drive(CFG, 4)
    lanes = [(torch.from_numpy(np.stack([xs[i], xs[i - 1]])),
              torch.from_numpy(np.stack([cs[i], cs[i - 1]])))
             for i in range(1, 4)]
    calls = []

    def fn(s, x, c):
        calls.append(1)
        return P.batch_image_step(s, x, c, CFG)

    got = aot.get_or_compile("cpu_batch", fn,
                             (init_batch_state(CFG, 2, device="cpu"),)
                             + lanes[0], extra=f"{CFG}|B=2")
    assert got is fn and len(calls) == 1
    a = b = init_batch_state(CFG, 2, device="cpu")
    for x, c in lanes:
        a, pa, na = got(a, x, c)
        b, pb, nb = P.batch_image_step(b, x, c, CFG)
        assert torch.equal(pa.q, pb.q) and torch.equal(pa.t, pb.t)
        assert torch.equal(na, nb)
    assert int(na.min()) > 100


_SHARDED_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.parallel import combined as CB
from liodom_tpu_torch.parallel import launch
from liodom_tpu_torch.parallel.mesh import make_mesh
from liodom_tpu_torch.runtime import aot
from liodom_tpu_torch.runtime.device_io import path_kernels

torch.set_num_threads(1)
workdir, port, step_kw, map_kw = sys.argv[1], sys.argv[2], *map(
    json.loads, sys.argv[3:5])
inp = np.load(workdir + "/inputs.npz")
cfg = LiodomConfig(mapping=True, **step_kw)
mcfg = MapConfig(**map_kw)
launch.initialize("127.0.0.1:" + port, 1, 0, device="cpu")
try:
    mesh = make_mesh(1, 1, device="cpu")
    step = CB.make_sharded_combined_image_step(mesh, cfg, mcfg)

    def init():
        return CB.init_combined_image_sharded(cfg, mcfg, mesh, device="cpu")

    xs, cs = torch.from_numpy(inp["xs"]), torch.from_numpy(inp["cs"])
    got = aot.get_or_compile("cpu_sharded", step, init() + (xs[0], cs[0]),
                             extra=f"{cfg}|{mcfg}|sharded",
                             kernel_names=path_kernels(True, sharded=True))
    out = {"is_fn": np.asarray(got is step)}
    for key, f in (("direct", step), ("route", got)):
        st, poses = init(), []
        for x, c in zip(xs, cs):
            s, m, pose, ne = f(*st, x, c)
            st = (s, m)
            poses.append(np.concatenate([pose.q.numpy(), pose.t.numpy(),
                                         [float(ne)]]))
        out[key] = np.stack(poses)
        out[key + "_slots"] = np.asarray(int(st[1].valid.sum()))
    np.savez(workdir + "/out.npz", **out)
finally:
    dist.destroy_process_group()
"""


def test_cpu_route_sharded_flagship_on_a_one_rank_gloo_group(tmp_path):
    """``make_sharded_combined_image_step`` on a one-rank gloo group (a
    process of its own, as the parallel tests' ranks) through
    ``get_or_compile``'s CPU route with the sharded kernel list: ``fn``
    itself, and 4 frames of poses, edge counts and map slots equal to the
    direct calls'."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from torch_ranks import MAP_KW, STEP_KW
    cfg = LiodomConfig(mapping=True, **STEP_KW)
    xs, cs = _drive(cfg, 4)
    np.savez(tmp_path / "inputs.npz", xs=xs, cs=cs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(repo))
    run = subprocess.run(
        [sys.executable, "-c", _SHARDED_RANK, str(tmp_path), str(port),
         json.dumps(STEP_KW), json.dumps(MAP_KW)], cwd=repo, env=env,
        capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    assert bool(out["is_fn"])
    np.testing.assert_array_equal(out["route"], out["direct"])
    assert int(out["route_slots"]) == int(out["direct_slots"]) > 1000
    assert out["direct"][:, -1].min() > 100          # edges every frame


def test_enable_persistent_cache_resolves_the_build_dir(tmp_path,
                                                        monkeypatch):
    """The default is ``kernels/build/``; a path given before the first
    build becomes the directory every library is named under; the call is
    idempotent, and one without a path keeps the directory in use."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(kernels, "_started", False)
    default = Path(kernels.__file__).resolve().parent / "build"
    assert cache.enable_persistent_cache() == str(default)
    d = tmp_path / "libs"
    assert cache.enable_persistent_cache(str(d)) == str(d.resolve())
    assert d.is_dir()
    assert cache.enable_persistent_cache(str(d)) == str(d.resolve())
    assert cache.enable_persistent_cache() == str(d.resolve())
    assert kernels.library_path("smoothness", "nvcc").parent == d.resolve()
    # after a build or a load the directory stays
    monkeypatch.setattr(kernels, "_started", True)
    assert cache.enable_persistent_cache(str(tmp_path / "late")) == str(
        d.resolve())
    assert not (tmp_path / "late").exists()


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """``tests/test_run_kitti_e2e.py``'s KITTI tree: 6 scans of 500
    columns, an identity ``Tr``."""
    from test_run_kitti_e2e import _make_kitti
    root = tmp_path_factory.mktemp("kitti")
    _make_kitti(root, n_scans=6, width=500)
    return root


def _poses(d: Path) -> np.ndarray:
    return np.loadtxt(d / "poses.txt").reshape(-1, 3, 4)


@pytest.mark.parametrize("extra", [[], ["--chunk", "4"],
                                   ["--mapping", "--local-map-every", "2",
                                    "--local-map-capacity", "4096"]],
                         ids=["per_frame", "chunk4", "mapping_every2"])
def test_run_kitti_aot_equals_eager(tree, tmp_path, extra):
    """``--aot --device cpu`` takes the same steps as the eager run: the
    same poses and edge counts, bit for bit."""
    base = ["--root", str(tree), "--seq", "00", "--local-map-size", "3",
            "--ring-width", "512", "--device", "cpu"] + extra
    eager = run_kitti.run(base + ["--results-dir", str(tmp_path / "e")])
    warm = run_kitti.run(base + ["--aot",
                                 "--results-dir", str(tmp_path / "a")])
    assert eager["rc"] == warm["rc"] == 0
    assert warm["graphs"] >= 1 and "aot_capture_s" in warm
    np.testing.assert_array_equal(_poses(tmp_path / "a"),
                                  _poses(tmp_path / "e"))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "a" / "nfeats.txt"),
                                  np.loadtxt(tmp_path / "e" / "nfeats.txt"))


def test_run_ouster_aot_equals_eager(tmp_path):
    base = ["--synthetic", "--frames", "4", "--width", "256",
            "--local-map-size", "3", "--device", "cpu"]
    eager = run_ouster.run(base + ["--results-dir", str(tmp_path / "e")])
    warm = run_ouster.run(base + ["--aot",
                                  "--results-dir", str(tmp_path / "a")])
    assert eager["rc"] == warm["rc"] == 0 and warm["graphs"] == 1
    np.testing.assert_array_equal(_poses(tmp_path / "a"),
                                  _poses(tmp_path / "e"))
