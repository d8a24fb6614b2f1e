"""The readers of the program's own spans and counters
(``benchmark/spans.py``, ``benchmark/metrics/*``) on synthetic records of a
replay and of the live loop: each reads what the record holds inside the
window and ``None`` without a record."""

from types import SimpleNamespace

import pytest

from benchmark import spans, spec

from conftest import ROOT

MS = 1_000_000
T0 = 2_000_000_000              # t_process 1.0 s + setup_s 1.0 s, in ns
READERS = ("device_idle.program", "loader_idle_ms.replay",
           "graph_device_ms.replay", "aot_copy_ms.replay",
           "lm_solve_device_ms.replay", "knn_device_ms.replay",
           "features_device_ms.replay", "map_device_ms.replay",
           "local_map_rows.replay", "step_host_ms.live",
           "fetch_wait_ms.live")


def _run(rec):
    return SimpleNamespace(program=rec, ctx=SimpleNamespace(
        t_process=1.0, setup_s=1.0))


def _replay_record():
    """Frames 4 (set-up) to 7 of a captured step, 4 ms apart, frame 5 at
    the window's start; frame 7 sampled in the graph; a fetch after it."""
    host, dev = [], []

    def top(name, f, s, e):
        host.append((name, f, -1, s, e, 1))

    for f in range(4, 8):
        b = T0 + (f - 5) * 4 * MS
        top("loader.next", f, b, b + MS)
        top("stage.put", f, b + MS, b + 1.2 * MS)
        top("aot.replay", f, b + 1.2 * MS, b + 1.5 * MS)
        dev += [("stage.copy", f, "", b + 1.2 * MS, b + 1.25 * MS, False),
                ("aot.copy_in", f, "", b + 1.3 * MS, b + 1.4 * MS, False),
                ("aot.graph", f, "", b + 1.4 * MS, b + 3.4 * MS, False),
                ("aot.clone_out", f, "", b + 3.4 * MS, b + 3.5 * MS, False)]
    b = T0 + 2 * 4 * MS
    dev += [("features", 7, "step", b + 1.4 * MS, b + 1.5 * MS, True),
            ("knn", 7, "step", b + 1.5 * MS, b + 1.6 * MS, True),
            ("lm_solve", 7, "step", b + 1.6 * MS, b + 2.4 * MS, True),
            ("knn", 7, "step", b + 2.4 * MS, b + 2.5 * MS, True),
            ("lm_solve", 7, "step", b + 2.5 * MS, b + 3.3 * MS, True),
            ("map.update", 7, "step", b + 3.3 * MS, b + 3.35 * MS, True),
            ("map.local", 7, "step", b + 3.35 * MS, b + 3.4 * MS, True)]
    b8 = T0 + 3 * 4 * MS
    top("fetch", 8, b8, b8 + 0.5 * MS)
    host.append(("fetch.copy", 8, len(host) - 1, b8, b8 + 0.42 * MS, 1))
    dev.append(("fetch.copy", 8, "", b8 + 0.1 * MS, b8 + 0.4 * MS, False))
    counts = [("local_map.rows", 5, 1000, T0 - 1000),
              ("local_map.rows", 8, 1600, b8 + 0.5 * MS)]
    return {"host": host, "device": dev, "counts": counts,
            "anchors": [(5, T0 - 1000), (8, b8 + 0.5 * MS)]}


def _live_record():
    host = []
    for f, (step, fetch) in enumerate([(28, 2), (30, 3), (29, 4)]):
        b = T0 + f * 100 * MS
        host.append(("stage.put", f, -1, b, b + MS, 1))
        host.append(("step", f, -1, b + MS, b + (1 + step) * MS, 1))
        host.append(("features", f, len(host) - 1, b + MS, b + 2 * MS, 1))
        s = b + (1 + step) * MS
        host.append(("fetch", f + 1, -1, s, s + fetch * MS, 1))
    return {"host": host, "device": [], "counts": [], "anchors": []}


def _read(name, rec):
    cell = spec.Cell(spec.load_benchmark(ROOT), "kitti-odom.replay", ROOT)
    return cell.reader(name).read(_run(rec))


def test_replay_readers_read_the_window():
    rec = _replay_record()
    got = {n: _read(n, rec) for n in READERS[:9]}
    assert got["graph_device_ms.replay"] == pytest.approx(2.0)
    assert got["aot_copy_ms.replay"] == pytest.approx(0.2)
    assert got["lm_solve_device_ms.replay"] == pytest.approx(1.6)
    assert got["knn_device_ms.replay"] == pytest.approx(0.2)
    assert got["features_device_ms.replay"] == pytest.approx(0.1)
    assert got["map_device_ms.replay"] == pytest.approx(0.1)
    assert got["local_map_rows.replay"] == pytest.approx(200.0)
    # busy: 3 x (0.05 + 2.2) + 0.3 ms of a window of 12.5 ms
    assert got["device_idle.program"] == pytest.approx(
        100 * (1 - 7.05 / 12.5))
    # the loader's gaps: 1.2 ms (from the window's start), 1.7, 1.7
    assert got["loader_idle_ms.replay"] == pytest.approx(4.6 / 3)
    gaps = spans.longest_gaps(_run(rec), 3)
    assert [g[0] for g in gaps] == ["loader.next"] * 3
    assert spans.longest_gaps(_run(rec))[-1][0] == "aot.replay"
    assert {g[0] for g in spans.longest_gaps(_run(rec))} == {
        "loader.next", "aot.replay", "host", "fetch"}


def test_live_readers_read_the_window():
    rec = _live_record()
    assert _read("step_host_ms.live", rec) == pytest.approx(29.0)
    assert _read("fetch_wait_ms.live", rec) == pytest.approx(3.0)
    assert _read("device_idle.program", rec) is None


def test_every_reader_reads_none_without_a_record():
    for name in READERS:
        assert _read(name, None) is None
        assert _read(name, {"host": [], "device": [], "counts": [],
                            "anchors": []}) is None
        run = SimpleNamespace(ctx=SimpleNamespace(t_process=1.0,
                                                  setup_s=1.0))
        cell = spec.Cell(spec.load_benchmark(ROOT), "kitti-odom.replay",
                         ROOT)
        assert cell.reader(name).read(run) is None


def test_readers_name_their_layer_as_the_benchmark_does():
    bench = spec.load_benchmark(ROOT)
    layers = {m["layer"] for m in bench["per_layer"]}
    moved = {m["name"] for m in bench["end_to_end"]}
    cell = spec.Cell(bench, "kitti-odom.replay", ROOT)
    for name in READERS:
        r = cell.reader(name)
        assert r.NAME == name and r.LAYER in layers and r.MOVES in moved
        assert r.SOURCE in ("program_span", "program_counter")
        assert spec.NAME.match(name) and spec.UNIT.match(r.UNIT)


def test_a_quiet_stretch_is_left_out_of_the_idle():
    """A ``--trace 1`` run's profiled stretch (frame 6 here) holds no span:
    its time is neither idle nor window."""
    rec = _replay_record()
    b6 = T0 + 4 * MS
    rec["host"] = [h for h in rec["host"] if h[1] != 6]
    rec["device"] = [d for d in rec["device"] if d[1] != 6]
    rec["quiet"] = [(b6, b6 + 4 * MS)]
    # gaps 1.2 + 0.05 + 0.5 (frame 5), 1.2 + 0.05 + 0.6 + 0.1 (frame 7 and
    # the fetch) over the window's 12.5 ms less the quiet 4
    assert _read("device_idle.program", rec) == pytest.approx(
        100 * 3.7 / 8.5)
    assert all(not (b6 < (s + e) / 2 < b6 + 4 * MS)
               for s, e, _ in spans.window(_run(rec)).gaps())
