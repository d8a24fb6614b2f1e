"""The warm start of the port (``runtime/aot.py``, ``runtime/cache.py``) on
the CPU: the tag's identity rules (JAX's ``_tag``: the name, the torch
version, the device kind, every leaf's shape and dtype, ``extra``), the
CPU route of ``get_or_compile`` (``fn`` after one warm call, no graph),
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
