"""The streaming world and the live-stream app of the port against the JAX
package's, on the CPU.

``StreamWorld`` renders equal JAX's bit for bit; its tile cache is safe
under concurrent renders and evictions, and a ``set_keepout`` raced by a
render leaves only tiles a fresh world with that keepout makes (the
keepout is read under the cache lock with a generation count, so a tile
built under an older keepout is never cached).  ``run_stream``
(``--device cpu``) keeps the JAX app's accounting contract in the four
cases of ``tests/test_run_stream.py``, without wall-clock pacing: overload
drops are certain (``--engine-delay 0.2 --rate 100``) and a queue as long
as the run makes drops impossible; its ATE is within 1 cm of the JAX
app's on the same frames.  The JAX app runs once, in this process, with
its persistent compilation cache off."""

import contextlib
import importlib.util
import io
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu.core import synth as JS
from liodom_tpu_torch.apps import run_stream
from liodom_tpu_torch.core import synth as TS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--width", 400, "--ring-width", 512]


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


# ---- StreamWorld ------------------------------------------------------------

@pytest.mark.parametrize("keepout", [False, True])
def test_streamworld_renders_equal_jax(keepout):
    """Three poses along the long course, 600 columns, 1 cm noise."""
    pos, yaws = JS.drive_trajectory(40, speed=1.2, yaw_rate=0.004)
    jw, tw = JS.StreamWorld(seed=0), TS.StreamWorld(seed=0)
    if keepout:
        jw.set_keepout(pos[:, :2])
        tw.set_keepout(pos[:, :2])
    for i in (0, 17, 39):
        args = (pos[i], JS.yaw_matrix(yaws[i]))
        kw = dict(width=600, noise=0.01, seed=100 + i)
        assert np.array_equal(tw.render(*args, **kw), jw.render(*args, **kw))


def _same_tile(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_streamworld_tile_cache_thread_safe():
    """4 workers x 1,500 tiles (6,000 > the 4,096 bound) with an
    overlapping hot band, so reads race evictions; a tile regenerated after
    eviction equals a fresh world's."""
    w = TS.StreamWorld(seed=0)
    errors = []

    def worker(base):
        try:
            for k in range(1500):
                w._tile_objects(base + k, 0)
                if k % 7 == 0:
                    w._tile_objects(k % 100, 1)
        except Exception as e:          # noqa: BLE001 — recorded for assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(1000 * t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(w._cache) <= 4096
    fresh = TS.StreamWorld(seed=0)
    for key in ((3, 0), (1000, 0), (50, 1)):
        assert _same_tile(w._tile_objects(*key), fresh._tile_objects(*key))


def _course(n=300):
    pos, _ = TS.drive_trajectory(n, speed=1.2, yaw_rate=0.004)
    return pos[:, :2]


def test_set_keepout_raced_by_a_render_caches_no_stale_tile():
    """A tile generation that read keepout A is held inside its keepout
    filter while ``set_keepout(B)`` runs; released, it returns its tile to
    its caller but must not cache it: every cached tile equals a fresh
    world's under B."""
    path_a, path_b = _course(), _course()[::-1] + 5.0
    w = TS.StreamWorld(seed=0)
    w.set_keepout(path_a)
    inside, release = threading.Event(), threading.Event()
    real = TS.StreamWorld._path_near

    def held(p, *box):
        inside.set()
        assert release.wait(timeout=60)
        return real(p, *box)

    w._path_near = held
    t = threading.Thread(target=w._tile_objects, args=(0, 0))
    t.start()
    assert inside.wait(timeout=60)
    w._path_near = real
    w.set_keepout(path_b)
    release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    fresh = TS.StreamWorld(seed=0)
    fresh.set_keepout(path_b)
    assert (0, 0) not in w._cache
    for key in [(0, 0), (1, 0), (0, 1)]:
        w._tile_objects(*key)
    assert w._cache
    for key, tile in w._cache.items():
        assert _same_tile(tile, fresh._tile_objects(*key)), key


def test_set_keepout_under_concurrent_renders_leaves_fresh_tiles():
    """Renders of tiles along the course in 4 threads while the keepout
    switches between two paths and ends on B: every cached tile is a fresh
    world's under B."""
    path_a, path_b = _course(), _course() + np.array([0.0, 6.0])
    w = TS.StreamWorld(seed=0)
    w.set_keepout(path_a)
    stop = threading.Event()
    errors = []

    def render_tiles(k):
        try:
            while not stop.is_set():
                for tx in range(-2, 14):
                    w._tile_objects(tx, k % 3 - 1)
        except Exception as e:          # noqa: BLE001 — recorded for assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=render_tiles, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for j in range(20):
            w.set_keepout(path_b if j % 2 else path_a)
        stop.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    fresh = TS.StreamWorld(seed=0)
    fresh.set_keepout(path_b)
    assert w._cache
    for key, tile in list(w._cache.items()):
        assert _same_tile(tile, fresh._tile_objects(*key)), key


# ---- run_stream ---------------------------------------------------------------

def _port(argv) -> dict:
    return run_stream.run([str(a) for a in argv] + ["--device", "cpu"])


def test_overload_drops_counted_and_watchdog_fires():
    """The sensor far above the engine's rate: drop-oldest evicts frames,
    every eviction is counted, and the 0.8x watchdog warns."""
    s = _port(["--frames", 15, "--rate", 100, *SMALL, "--engine-delay", 0.2])
    assert s["rc"] == 0
    assert s["accounted"] == 15, s
    assert s["dropped"] > 0, s
    assert s["processed"] >= 1, s
    assert s["warn_count"] >= 1, s
    assert s["output_hz"] < 0.8 * s["input_hz"], s


def test_queue_as_long_as_the_run_drops_nothing():
    """A queue that holds every frame: all processed, none dropped, the
    trajectory tracks ground truth."""
    s = _port(["--frames", 6, "--rate", 1000, "--queue-size", 6, *SMALL,
               "--world", "box", "--local-map-size", 3])
    assert s["rc"] == 0
    assert s["processed"] == 6 and s["dropped"] == 0, s
    assert s["ate_m"] is not None and s["ate_m"] < 1.5, s


def test_stream_kitti_layout(tmp_path):
    """``--root``: the rosbag-replay deployment over a KITTI-layout sequence
    through the same channels, scored against its ground truth."""
    from test_run_kitti_e2e import _make_kitti
    _make_kitti(tmp_path, n_scans=6, width=400)
    s = _port(["--root", tmp_path, "--seq", "00", "--frames", 6,
               "--rate", 1000, "--queue-size", 6, "--ring-width", 512,
               "--local-map-size", 3])
    assert s["rc"] == 0
    assert s["accounted"] == 6 and s["processed"] == 6, s
    assert s["ate_m"] is not None and s["ate_m"] < 1.5, s


def test_mapping_feedback_loop():
    """The mapper thread folds solved frames and publishes the local map
    back; the overflow counters stay 0."""
    s = _port(["--frames", 8, "--rate", 1000, "--queue-size", 8, *SMALL,
               "--world", "box", "--mapping", "--local-map-size", 3,
               "--local-map-every", 2, "--map-capacity", 65536,
               "--local-map-capacity", 4096])
    assert s["rc"] == 0
    assert s["accounted"] == 8 and s["processed"] == 8, s
    assert s["mapper_processed"] >= 1, s
    assert s["map_overflow"] == 0 and s["local_map_truncation"] == 0, s


def _run_jax(argv) -> dict:
    """``apps/run_stream.py``'s ``main()`` in this process, loaded under a
    name of its own, with ``--json``: its summary."""
    spec = importlib.util.spec_from_file_location(
        "_jax_app_run_stream", REPO / "apps" / "run_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["run_stream.py"] + [str(a) for a in argv] + ["--json"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert mod.main() == 0
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_ate_matches_jax_on_the_streaming_world():
    """The app's default world, every frame processed by both (a queue as
    long as the run): ATE within 1 cm of the JAX app's."""
    argv = ["--frames", 6, "--rate", 1000, "--queue-size", 6, "--width", 600,
            "--ring-width", 1280, "--local-map-size", 3]
    j = _run_jax(argv)
    s = _port(argv)
    assert j["processed"] == s["processed"] == 6
    assert j["dropped"] == s["dropped"] == 0
    assert abs(s["ate_m"] - j["ate_m"]) < 0.01, (s["ate_m"], j["ate_m"])
