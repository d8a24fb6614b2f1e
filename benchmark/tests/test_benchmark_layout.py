"""The benchmark's data layout: ``BENCHMARK.json`` keeps to its contract,
every file it names is found by name, and a configuration, a mix, a
metric or a cell is added by adding files and entries, with no edit."""

import json
import re
import shutil

from benchmark import spec

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _names(key):
    return [e["name"] for e in BENCH[key]]


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_units_and_lines():
    names = (_names("configs") + _names("workloads") + _names("end_to_end")
             + _names("per_layer"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len(set(_names(key))) == len(_names(key))
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    lines = [w["why"] for w in BENCH["workloads"]] + [
        c["source"] for c in BENCH["configs"]] + [
        m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_found_by_name():
    for w in BENCH["workloads"]:
        cell = spec.Cell(BENCH, w["name"], ROOT)
        assert cell.traffic["name"] == w["traffic"]
        assert (ROOT / "benchmark" / "loops" /
                f"{cell.traffic['loop']}.py").exists()
        assert cell.limits and all(isinstance(v, (int, float))
                                   for v in cell.limits.values())
        for m in cell.per_layer:
            r = cell.reader(m["name"])
            assert (r.NAME, r.UNIT, r.LAYER, r.MOVES, r.SOURCE) == (
                m["name"], m["unit"], m["layer"], m["moves"], m["source"])
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_layers_name_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert len(by_layer) == 6
    for layer in by_layer:
        assert re.fullmatch(r"[^\n\t]{1,200}", layer)


def test_each_metric_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = _names("workloads")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells
            assert moved.get("workloads") is None or w in moved["workloads"]
    for w in cells:
        have = [n for n, m in e2e.items()
                if m.get("workloads") is None or w in m["workloads"]]
        assert "setup_s" in have and len(have) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_no_cell_asks_for_four_chips():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_a_file_added_in_a_copy_adds_an_entry(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = tmp_path / "benchmark"
    conf = json.loads((here / "configs" / "kitti-hdl64-odom.json").read_text())
    conf["name"] = "kitti-hdl64-odom-w5"
    conf["odometry"]["local_map_size"] = 5
    (here / "configs" / "kitti-hdl64-odom-w5.json").write_text(
        json.dumps(conf))
    traffic = json.loads((here / "traffic" / "replay.json").read_text())
    traffic.update(name="replay-fetch50", fetch_every=50)
    (here / "traffic" / "replay-fetch50.json").write_text(json.dumps(traffic))
    (here / "limits" / "w5.replay-fetch50.json").write_text(
        (here / "limits" / "kitti-odom.replay.json").read_text())
    (here / "metrics" / "frames.replay.py").write_text(
        'NAME, UNIT, LAYER = "frames.replay", "frames", "device (H100)"\n'
        'MOVES, SOURCE = "scans_per_s", "host_clock"\n\n\n'
        "def read(run):\n    return run.result.attempted\n")
    bench["configs"].append({"name": "kitti-hdl64-odom-w5",
                             "source": "x", "reduced": ["route_m"],
                             "file": "benchmark/configs/"
                                     "kitti-hdl64-odom-w5.json", "why": "x"})
    bench["workloads"].append({"name": "w5.replay-fetch50",
                               "config": "kitti-hdl64-odom-w5",
                               "traffic": "replay-fetch50", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("w5.replay-fetch50")
    bench["per_layer"].append({"name": "frames.replay", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "device (H100)",
                               "moves": "scans_per_s",
                               "workloads": ["w5.replay-fetch50"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell(spec.load_benchmark(tmp_path), "w5.replay-fetch50",
                     tmp_path)
    assert cell.config["odometry"]["local_map_size"] == 5
    assert cell.traffic["fetch_every"] == 50
    assert [m["name"] for m in cell.per_layer] == ["frames.replay"]
    assert [m["name"] for m in cell.end_to_end] == ["scans_per_s", "setup_s"]
    assert cell.reader("frames.replay").read(
        type("R", (), {"result": type("X", (), {"attempted": 3})})) == 3
    from benchmark import port
    cfg, _ = port.configs(cell.config)
    assert cfg.local_map_size == 5


def test_config_holds_what_is_run():
    from benchmark import port
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        cfg, mcfg = port.configs(conf)
        for k, v in conf["odometry"].items():
            assert getattr(cfg, k) == v, k
        for k, v in (conf["map"] or {}).items():
            assert getattr(mcfg, k) == v, k
        assert cfg.local_map_size == 15 and cfg.max_edges == 5632
