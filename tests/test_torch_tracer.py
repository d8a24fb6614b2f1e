"""The span recorder (``liodom_tpu_torch/runtime/tracer.py``) on the CPU:
off it records nothing and makes no event; on it nests spans with their
parents and frames, resolves device events to the host clock at an
anchor (on fake events), reads a captured graph's spans from its last
replay, attributes idle gaps to the host span open in them, accumulates
counters without a host sync, stays silent under ``torch.profiler``, and
leaves the steps' outputs bit for bit as they are; the apps'
``--trace-out`` writes a Chrome trace."""

import json

import numpy as np
import pytest
import torch

from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.runtime import tracer

torch.set_num_threads(1)

CFG = LiodomConfig(ring_width=256, local_map_size=3)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracer.RECORDER.disarm()
    tracer.RECORDER._reset()
    yield tracer.RECORDER
    tracer.RECORDER.disarm()
    tracer.RECORDER._reset()


class FakeEvent:
    """A CUDA event on a fake device clock (``FakeEvent.now``, ms)."""
    now = 0.0
    made = []

    def __init__(self, enable_timing=False, external=False):
        self.external = external
        self.t = None
        FakeEvent.made.append(self)

    def record(self):
        self.t = FakeEvent.now

    def elapsed_time(self, end):
        return end.t - self.t

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass


@pytest.fixture
def fake_card(monkeypatch, fresh_recorder):
    """The recorder armed as on a card, its events fake, the host clock at
    ``clock[0]`` ns, stream capture as ``capturing[0]`` says."""
    clock, capturing = [0], [False]
    FakeEvent.now, FakeEvent.made = 0.0, []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(tracer.time, "perf_counter_ns", lambda: clock[0])
    fresh_recorder.arm("cpu")
    fresh_recorder._cuda = True
    return fresh_recorder, clock, capturing


def _image(seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=(64, 256, 3)).astype(np.float32)
                           * 20.0)
    return img, torch.full((64,), 200, dtype=torch.int32)


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made while the recorder is off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not tracer.RECORDER.on
    assert tracer.span("a") is tracer.span("b", device=True)
    with tracer.span("step", device=True):
        tracer.count("local_map.rows", torch.tensor(3))
    tracer.anchor()
    P.image_step(P.init_state(CFG, device="cpu"), *_image(), CFG)
    assert tracer.snapshot() == {"host": [], "device": [], "counts": [],
                                 "anchors": [], "quiet": []}
    assert tracer.RECORDER.frame == 0


def test_nesting_gives_parents_and_frames():
    tracer.arm("cpu")
    with tracer.span("loader.next"):
        pass
    with tracer.span("step"):
        with tracer.span("features"):
            pass
        with tracer.span("knn"):
            with tracer.span("inner"):
                pass
    with tracer.span("fetch"):
        tracer.anchor()
    with tracer.span("aot.replay"):
        with tracer.span("step"):      # nested: ends no frame of its own
            pass
    rec = tracer.snapshot()
    names = [h[0] for h in rec["host"]]
    assert names == ["loader.next", "step", "features", "knn", "inner",
                     "fetch", "aot.replay", "step"]
    parent = {n: (rec["host"][h[2]][0] if h[2] >= 0 else None)
              for n, h in zip(names, rec["host"]) if n != "step"}
    assert parent == {"loader.next": None, "features": "step",
                      "knn": "step", "inner": "knn", "fetch": None,
                      "aot.replay": None}
    assert [h[1] for h in rec["host"]] == [0, 0, 0, 0, 0, 1, 1, 1]
    assert rec["host"][7][2] == 6
    assert tracer.RECORDER.frame == 2
    assert rec["anchors"][0][0] == 1
    assert all(h[3] <= h[4] for h in rec["host"])


def test_anchor_resolves_events_on_the_host_clock(fake_card):
    rec, clock, _ = fake_card
    clock[0] = 1_000
    FakeEvent.now = 2.0                     # ms on the card
    with tracer.span("step", device=True):
        FakeEvent.now = 2.5
        with tracer.span("knn", device=True):
            FakeEvent.now = 3.0
        FakeEvent.now = 4.0
    FakeEvent.now = 7.0                     # the anchor executes here
    clock[0] = 50_000_000
    tracer.anchor()
    # resolved once the next frame step is dispatched, not at the anchor
    assert rec._device == [] and len(rec._due) == 1
    with tracer.span("step"):
        pass
    assert len(rec._device) == 2 and rec._due == []
    dev = {d[0]: d for d in tracer.snapshot()["device"]}
    # t = t_anchor - (anchor - event) ms
    assert dev["step"][3:5] == (50_000_000 - 5_000_000, 47_000_000)
    assert dev["knn"][3:5] == (45_500_000, 46_000_000)
    assert dev["knn"][2] == "step" and dev["step"][2] == ""
    assert dev["step"][1] == 0 and not dev["step"][5]
    # resolved events go back to the pool, which the next span takes
    made = len(FakeEvent.made)
    with tracer.span("x", device=True):
        pass
    assert len(FakeEvent.made) == made


def test_captured_spans_are_read_from_the_last_replay(fake_card):
    rec, clock, capturing = fake_card
    capturing[0] = True
    with tracer.span("step", device=True):
        with tracer.span("lm_solve", device=True):
            pass
    capturing[0] = False
    spans = rec.take_captured()
    assert [s[:2] for s in spans] == [("lm_solve", "step"), ("step", "")]
    assert all(e.external for s in spans for e in s[2:])
    assert tracer.snapshot()["host"] == []       # capture is no frame's
    assert rec.frame == 0 and rec.take_captured() == ()

    def replay(t0_ms):
        ev = {s[0]: s[2:] for s in spans}
        ev["step"][0].t, ev["lm_solve"][0].t = t0_ms, t0_ms + 1.0
        ev["lm_solve"][1].t, ev["step"][1].t = t0_ms + 3.0, t0_ms + 4.0
        with tracer.span("aot.replay"):
            rec.replayed(spans)

    replay(0.0)
    replay(10.0)                # the same events, recorded anew
    FakeEvent.now, clock[0] = 20.0, 100_000_000
    tracer.anchor()
    got = {d[0]: d for d in tracer.snapshot()["device"]}
    assert set(got) == {"step", "lm_solve"}
    assert got["lm_solve"][1] == 1 and got["lm_solve"][5]
    assert got["lm_solve"][3:5] == (91_000_000, 93_000_000)
    assert got["step"][3:5] == (90_000_000, 94_000_000)
    tracer.anchor()             # no replay since: nothing read again
    assert len(tracer.snapshot()["device"]) == 2


def test_idle_gaps_go_to_the_innermost_host_span():
    rec = {"host": [("loader.next", 0, -1, 0, 40, 1),
                    ("aot.replay", 0, -1, 40, 60, 1),
                    ("stage.put", 0, -1, 100, 170, 1),
                    ("fetch", 1, -1, 170, 200, 1),
                    ("fetch.copy", 1, 3, 180, 199, 1)],
           "device": [("aot.graph", 0, "", 50, 110, False),
                      ("lm_solve", 0, "", 60, 80, True),
                      ("stage.copy", 1, "", 120, 130, False),
                      ("fetch.copy", 1, "", 190, 195, False)],
           "counts": [], "anchors": []}
    assert tracer.idle_gaps(rec, 0, 200) == [
        (0, 50, "loader.next"), (110, 120, "stage.put"),
        (130, 190, "stage.put"), (195, 200, "fetch.copy")]
    assert tracer.idle_gaps(rec) == [(110, 120, "stage.put"),
                                     (130, 190, "stage.put")]
    total, gaps = tracer.union([(0, 10), (5, 20), (30, 40)])
    assert (total, gaps) == (30, [(20, 30)])
    assert tracer.idle_gaps({**rec, "host": []}, 0, 60) == [(0, 50, "host")]


def test_counters_accumulate_without_a_host_sync(monkeypatch):
    tracer.arm("cpu")
    real = {n: getattr(torch.Tensor, n)
            for n in ("item", "tolist", "__int__", "__bool__", "numpy")}

    def no_sync(*a, **k):
        raise AssertionError("a counter read its value on the host")
    for n in real:
        monkeypatch.setattr(torch.Tensor, n, no_sync)
    for v in (3, 4, 5):
        tracer.count("local_map.rows", torch.tensor(v, dtype=torch.int32))
    tracer.count("stage.waits", 1)
    with tracer.span("step"):
        pass
    for n, f in real.items():
        monkeypatch.setattr(torch.Tensor, n, f)
    assert tracer.RECORDER._acc["local_map.rows"].dtype == torch.int64
    tracer.anchor()
    tracer.count("local_map.rows", torch.tensor(8))
    with tracer.span("step"):
        pass
    tracer.anchor()
    assert sorted(tracer.snapshot()["counts"], key=lambda c: c[1]) == [
        ("stage.waits", 1, 1, tracer.snapshot()["anchors"][0][1]),
        ("local_map.rows", 1, 12, tracer.snapshot()["anchors"][0][1]),
        ("stage.waits", 2, 1, tracer.snapshot()["anchors"][1][1]),
        ("local_map.rows", 2, 20, tracer.snapshot()["anchors"][1][1])]


def test_a_counter_first_met_under_capture_raises(fake_card):
    _, _, capturing = fake_card
    capturing[0] = True
    with pytest.raises(RuntimeError, match="warm call"):
        tracer.count("local_map.rows", torch.tensor(1))


def test_nothing_is_recorded_under_the_profiler():
    tracer.arm("cpu")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("step", device=True):
            with tracer.span("knn", device=True):
                tracer.count("n", 1)
        tracer.anchor()
    rec = tracer.snapshot()
    assert (rec["host"], rec["device"], rec["counts"], rec["anchors"]) == (
        [], [], [], [])
    assert len(rec["quiet"]) == 1           # open: no span after it yet
    assert tracer.RECORDER.frame == 1       # frames still counted
    with tracer.span("step"):
        pass
    rec = tracer.snapshot()
    assert rec["host"][0][:3] == ("step", 1, -1)
    (q0, q1), = rec["quiet"]
    assert q0 <= q1 <= rec["host"][0][3]
    assert not any(e.name in ("step", "fetch")
                   for e in prof.events())


def _image_drive(n=3):
    from liodom_tpu_torch.core.frame import RawScan
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             yaw_matrix)
    from liodom_tpu_torch.ops import features as F
    world = BoxWorld(seed=2)
    pos, yaws = drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    out = []
    for i in range(n):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=240,
                            noise=0.01, seed=i)
        img = F.split_scan(RawScan.from_points(
            torch.from_numpy(scan), CFG.max_points, device="cpu"), CFG)
        out.append((img.xyz, img.count))
    return out


def _steps(kind):
    """(initial state, step) of ``kind``, as a frame loop calls it."""
    from liodom_tpu_torch.mapping import service as S
    from liodom_tpu_torch.runtime import aot
    if kind == "combined":
        cfg = CFG.replace(mapping=True)
        mcfg = MapConfig(map_capacity=16384, local_map_capacity=4096)
        o, m = S.init_combined(cfg, mcfg, device="cpu")

        def step(s, x, c):
            o, m, pose, ne = S.combined_image_step(s[0], s[1], x, c, cfg,
                                                   mcfg, step=0)
            return (o, m), pose, ne
        return (o, m), step
    state = P.init_state(CFG, device="cpu")

    def step(s, x, c):
        return P.image_step(s, x, c, CFG)
    if kind == "aot":
        x0 = torch.zeros((64, 256, 3))
        c0 = torch.zeros((64,), dtype=torch.int32)
        return state, aot.get_or_compile(
            "tracer_test", step, (state, x0, c0),
            extra=f"on={tracer.RECORDER.on}")
    return state, step


def _leaves(tree):
    from torch.utils._pytree import tree_flatten
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("kind", ["image_step", "combined", "aot"])
def test_outputs_equal_with_the_recorder_on_and_off(kind):
    from liodom_tpu_torch.runtime.device_io import fetch_poses
    frames = _image_drive()
    runs = []
    for on in (False, True):
        if on:
            tracer.arm("cpu")
        state, step = _steps(kind)
        outs = []
        for x, c in frames:
            state, pose, ne = step(state, x, c)
            outs += _leaves((state, pose, ne))
            fetch_poses([(pose.q, pose.t, ne)])
        tracer.disarm()
        runs.append(outs)
    off, on = runs
    assert len(off) == len(on)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(off, on))
    rec = tracer.snapshot()
    names = {h[0] for h in rec["host"]}
    assert {"step", "features", "knn", "lm_solve", "window.push",
            "fetch"} <= names
    assert len(rec["anchors"]) == len(frames)
    if kind == "combined":
        assert {"map.update", "map.local"} <= names
        rows = [c for c in rec["counts"] if c[0] == "local_map.rows"]
        assert len(rows) == len(frames) and rows[-1][2] > 0
        assert [r[2] for r in rows] == sorted(r[2] for r in rows)


def test_run_stream_trace_out_writes_a_chrome_trace(tmp_path):
    from liodom_tpu_torch.apps import run_stream
    path = tmp_path / "trace.json"
    rep = run_stream.run(["--frames", "3", "--rate", "1000", "--queue-size",
                          "3", "--width", "400", "--ring-width", "512",
                          "--world", "box", "--local-map-size", "3",
                          "--device", "cpu", "--trace-out", str(path)])
    assert rep["rc"] == 0 and rep["trace_out"] == str(path)
    assert not tracer.RECORDER.on
    ev = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in ev if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"stage.put", "step", "features", "knn", "lm_solve",
            "window.push", "fetch"} <= names
    steps = sorted(e["args"]["frame"] for e in spans if e["name"] == "step")
    assert steps == [0, 1, 2, 3]      # the warm step, then the 3 frames
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    assert {e["args"]["name"] for e in ev if e["ph"] == "M"} >= {
        "host", "device", "spans", "graph spans", "idle"}


def test_write_chrome_holds_every_track(tmp_path):
    rec = {"host": [("step", 0, -1, 1_000, 4_500, 7),
                    ("fetch", 1, -1, 5_000, 9_000, 7),
                    ("loader.next", 1, -1, 2_000, 3_000, 8)],
           "device": [("aot.graph", 0, "", 2_000, 4_000, False),
                      ("lm_solve", 0, "step", 2_500, 3_000, True),
                      ("fetch.copy", 1, "", 6_000, 8_000, False)],
           "counts": [("local_map.rows", 1, 42, 9_000)],
           "anchors": [(1, 9_000)]}
    path = tmp_path / "t.json"
    tracer.write_chrome(str(path), rec)
    ev = json.loads(path.read_text())["traceEvents"]
    x = [(e["name"], e["pid"], e["tid"], e["ts"], e["dur"]) for e in ev
         if e["ph"] == "X"]
    assert ("step", 1, 0, 0.0, 3.5) in x
    assert ("loader.next", 1, 1, 1.0, 1.0) in x
    assert ("aot.graph", 2, 0, 1.0, 2.0) in x
    assert ("lm_solve", 2, 1, 1.5, 0.5) in x
    assert ("fetch", 2, 2, 3.0, 2.0) in x          # the idle gap 4-6 us
    assert [e for e in ev if e["ph"] == "C"] == [
        {"ph": "C", "name": "local_map.rows", "pid": 1, "ts": 8.0,
         "args": {"local_map.rows": 42}}]


def test_run_kitti_trace_out_writes_a_chrome_trace(tmp_path):
    """``run_kitti --aot --mapping --trace-out`` on a 4-scan tree: the
    loader's, the stager's, the warm start's and the fetch's spans, the
    map's spans and ``local_map.rows``, and the same poses as without it."""
    from liodom_tpu_torch.apps import run_kitti
    from liodom_tpu_torch.core.synth import (BoxWorld, drive_trajectory,
                                             yaw_matrix)
    velo = tmp_path / "kitti" / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(4, speed=1.0, yaw_rate=0.01)
    for i in range(4):
        pts = world.render(pos[i], yaw_matrix(yaws[i]), width=400,
                           noise=0.005, seed=i)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec.tofile(str(velo / f"{i:06d}.bin"))
    base = ["--root", str(tmp_path / "kitti"), "--local-map-size", "3",
            "--ring-width", "512", "--device", "cpu", "--aot", "--mapping",
            "--local-map-capacity", "4096", "--sync-every", "2"]
    path = tmp_path / "trace.json"
    plain = run_kitti.run(base + ["--results-dir", str(tmp_path / "a")])
    traced = run_kitti.run(base + ["--results-dir", str(tmp_path / "b"),
                                   "--trace-out", str(path)])
    assert plain["rc"] == traced["rc"] == 0
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "a" / "poses.txt"),
        np.loadtxt(tmp_path / "b" / "poses.txt"))
    ev = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in ev if e["ph"] == "X"}
    assert {"loader.next", "stage.put", "step", "features", "knn",
            "lm_solve", "window.push", "map.update", "map.local",
            "fetch"} <= names
    rows = [e["args"]["local_map.rows"] for e in ev if e["ph"] == "C"
            and e["name"] == "local_map.rows"]
    # fetched at frames 0 (the first), 1 and 3 (every 2nd, the last)
    assert len(rows) == 3 and 0 < rows[0] and rows == sorted(rows)
