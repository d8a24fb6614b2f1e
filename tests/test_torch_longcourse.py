"""The port's ``run_longcourse`` (``--device cpu``) against the JAX app
(``apps/run_longcourse.py``, run once in this process with its persistent
compilation cache off) on the streaming world at 5 frames, width 600,
ring width 1,280, window 3, a 65,536-slot map and an 8,192-row local map:
poses within 1 cm and 1e-3 rad a frame (the port-vs-JAX bar of
``tests/test_torch_apps.py``), the map's leaves within 0.1 %; ``--chunk 3``
(a remainder of 2 on the per-frame step) and a resume from a checkpoint at
frame 3 within 1e-6 m of the per-frame run."""

import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu_torch.apps import run_longcourse
from liodom_tpu_torch.runtime import checkpoint as CK

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COURSE = ["--frames", 5, "--width", 600, "--ring-width", 1280,
          "--local-map-size", 3, "--map-capacity", 65536,
          "--local-map-capacity", 8192, "--sample-every", 5]
CK_AT = 3


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache():
    """The JAX app turns the persistent cache on when loaded; a warm
    ``.jax_cache/`` breaks ``tests/test_aot.py`` on a later worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIODOM_JAX_CACHE", "off")
        yield


@pytest.fixture(scope="module", autouse=True)
def _two_cores():
    """Every thread of this process on two cores while the file runs: the
    JAX app computes on XLA's CPU thread pool, which spans every core, and
    the suite's other workers hold paced tests (``tests/test_run_stream.py``
    must finish a frame within its sensor period)."""
    threads = [int(t) for t in os.listdir("/proc/self/task")]
    before = {t: os.sched_getaffinity(t) for t in threads}
    cores = set(sorted(os.sched_getaffinity(0))[-2:])
    for t in threads:
        os.sched_setaffinity(t, cores)
    try:
        yield
    finally:
        for t in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(t), before.get(int(t),
                                                    before[threads[0]]))


def _run_jax(argv):
    """``apps/run_longcourse.py``'s ``main()`` in this process, loaded under
    a name of its own, with ``--json``: (exit code, its summary)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_app_run_longcourse", REPO / "apps" / "run_longcourse.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["run_longcourse.py"] + [str(a) for a in argv] + ["--json"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main()
    finally:
        sys.argv = old
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _run_port(argv) -> dict:
    return run_longcourse.run([str(a) for a in argv] + ["--device", "cpu"])


def _poses(d: Path) -> np.ndarray:
    return np.loadtxt(d / "poses.txt").reshape(-1, 3, 4)


def _gaps(a: np.ndarray, b: np.ndarray):
    """Per-frame translation (m) and rotation (rad) gaps of two (F, 3, 4)
    trajectories, the angle from the sine and the cosine of the relative
    rotation."""
    assert a.shape == b.shape
    dt = np.linalg.norm(a[:, :, 3] - b[:, :, 3], axis=1)
    rel = np.einsum("fji,fjk->fik", a[:, :, :3], b[:, :, :3])
    sin = 0.5 * np.linalg.norm(np.stack(
        [rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
         rel[:, 1, 0] - rel[:, 0, 1]], axis=1), axis=1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1.0)
    return dt, np.arctan2(sin, cos)


@pytest.fixture(scope="module")
def jax_course(tmp_path_factory):
    """The JAX app's per-frame course: (results dir, its summary)."""
    res = tmp_path_factory.mktemp("jax_lc")
    rc, summary = _run_jax(COURSE + ["--results-dir", res])
    assert rc == 0, summary
    return res, summary


@pytest.fixture(scope="module")
def port_course(tmp_path_factory):
    """The port's per-frame course with a checkpoint at frame 3: (results
    dir, report, checkpoint dir)."""
    root = tmp_path_factory.mktemp("port_lc")
    ck = root / "ck"
    rep = _run_port(COURSE + ["--results-dir", root / "res",
                              "--checkpoint-dir", ck,
                              "--checkpoint-every", CK_AT])
    assert rep["rc"] == 0, rep
    return root / "res", rep, ck


def test_longcourse_matches_jax(jax_course, port_course):
    """Poses within 1 cm and 1e-3 rad a frame, map leaves within 0.1 %,
    every loss counter 0."""
    res, rep, _ = port_course
    jres, jsum = jax_course
    dt, dr = _gaps(_poses(res), _poses(jres))
    np.testing.assert_array_less(dt, 0.01)
    np.testing.assert_array_less(dr, 1e-3)
    assert rep["frames"] == jsum["frames"] == 5
    assert rep["ring_dropped"] == jsum["ring_dropped"] == 0
    assert rep["map_overflow"] == 0 and rep["local_map_truncation"] == 0
    leaves = jsum["map_leaves"]
    assert abs(rep["map_leaves"] - leaves) <= 1e-3 * leaves, (
        rep["map_leaves"], leaves)


def test_longcourse_chunk_matches_per_frame(port_course, tmp_path):
    """``--chunk 3`` over 5 frames: one chained call and a remainder of 2
    on the per-frame step, within 1e-6 m of the per-frame run."""
    res, rep, _ = port_course
    out = tmp_path / "res"
    rep_c = _run_port(COURSE + ["--chunk", 3, "--results-dir", out])
    assert rep_c["rc"] == 0
    dt, _ = _gaps(_poses(out), _poses(res))
    assert dt.max() <= 1e-6, dt
    assert rep_c["map_leaves"] == rep["map_leaves"]


def test_longcourse_resume_matches_uninterrupted(port_course, tmp_path):
    """A checkpoint at frame 3, resumed to frame 5: within 1e-6 m of the
    uninterrupted run, the same map leaves."""
    res, rep, ck = port_course
    assert CK.latest_step(str(ck)) == CK_AT
    out = tmp_path / "res"
    rep_r = _run_port(COURSE + ["--results-dir", out, "--checkpoint-dir", ck,
                                "--checkpoint-every", 100])
    assert rep_r["rc"] == 0 and rep_r["start_frame"] == CK_AT
    dt, _ = _gaps(_poses(out), _poses(res))
    assert dt.max() <= 1e-6, dt
    assert rep_r["map_leaves"] == rep["map_leaves"]
