"""The ``kitti-map.newground`` cell's readers (``benchmark/metrics/
*.newground.py``) on a synthetic record handed back by the ``drive`` loop
(``Result.extra["program"]``): each reads what the record holds inside the
window, and ``None`` without a record or without its span or counter (a
program without them)."""

from types import SimpleNamespace

import pytest

from benchmark import spec

from conftest import ROOT

MS = 1_000_000
T0 = 2_000_000_000              # t_process 1.0 s + setup_s 1.0 s, in ns
CELL = "kitti-map.newground"
READERS = ("map_probe_ms.newground", "map_fold_ms.newground",
           "probe_rounds.newground", "state_copy_mb.newground")


def _run(rec):
    return SimpleNamespace(
        result=SimpleNamespace(extra={} if rec is None else
                               {"program": rec}),
        ctx=SimpleNamespace(t_process=1.0, setup_s=1.0))


def _record(with_new=True):
    """Frames 4 (set-up) to 7 of the captured map step, 4 ms apart, frame 5
    at the window's start, frames 6 and 7 sampled in the graph; the
    counters read before the window and at the fetch after frame 7."""
    host, dev = [], []
    for f in range(4, 8):
        b = T0 + (f - 5) * 4 * MS
        host.append(("aot.replay", f, -1, b + MS, b + 1.5 * MS, 1))
        dev.append(("map.update", f, "step", b + 2 * MS, b + 2.6 * MS,
                    True))
        if with_new and f >= 6:
            dev += [("map.probe", f, "map.update", b + 2 * MS,
                     b + (2.1 + 0.05 * f) * MS, True),
                    ("map.fold", f, "map.update", b + 2.3 * MS,
                     b + 2.6 * MS, True)]
    b8 = T0 + 3 * 4 * MS
    host.append(("fetch", 8, -1, b8, b8 + 0.5 * MS, 1))
    counts = [("local_map.rows", 5, 1000, T0 - 1000),
              ("local_map.rows", 8, 1600, b8 + 0.5 * MS)]
    if with_new:
        counts += [("map.probe_rounds", 5, 40, T0 - 1000),
                   ("map.probe_rounds", 8, 52, b8 + 0.5 * MS),
                   ("aot.copy_bytes", 5, 5 * 280_000_000, T0 - 1000),
                   ("aot.copy_bytes", 8, 8 * 280_000_000, b8 + 0.5 * MS)]
    return {"host": host, "device": dev, "counts": counts,
            "anchors": [(5, T0 - 1000), (8, b8 + 0.5 * MS)]}


def _read(name, rec):
    cell = spec.Cell(spec.load_benchmark(ROOT), CELL, ROOT)
    return cell.reader(name).read(_run(rec))


def test_readers_read_the_window():
    rec = _record()
    # map.probe: 0.4 and 0.45 ms (frames 6, 7); map.fold 0.3 ms each
    assert _read("map_probe_ms.newground", rec) == pytest.approx(0.425)
    assert _read("map_fold_ms.newground", rec) == pytest.approx(0.3)
    assert _read("probe_rounds.newground", rec) == pytest.approx(4.0)
    assert _read("state_copy_mb.newground", rec) == pytest.approx(280.0)


@pytest.mark.parametrize("rec", [None, {"host": [], "device": [],
                                        "counts": [], "anchors": []},
                                 _record(with_new=False)],
                         ids=["no-record", "empty", "parent-program"])
def test_readers_read_none_without_their_spans(rec):
    for name in READERS:
        assert _read(name, rec) is None


def test_readers_are_the_cells_metrics():
    bench = spec.load_benchmark(ROOT)
    cell = spec.Cell(bench, CELL, ROOT)
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert [m["name"] for m in cell.end_to_end] == ["scans_per_s",
                                                    "setup_s"]
    for m in cell.per_layer:
        assert m["workloads"] == [CELL]
        assert cell.reader(m["name"]).SOURCE in ("program_span",
                                                 "program_counter")
