"""The port of ``scripts/warm_cache.py`` (``liodom_tpu_torch/tools/
warm_cache``) on the CPU: its three programs and their configurations are
the JAX tool's (read from the script's source, which is not imported: it
enables JAX's persistent cache when imported), and ``--device cpu`` runs
them through ``get_or_compile``'s CPU route without building anything.
The cold and warm builds on the card are ``chip_smoke.py``'s
``warm_cache`` phase."""

import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.config import MapConfig as JMapConfig

from liodom_tpu_torch import kernels
from liodom_tpu_torch.runtime import native
from liodom_tpu_torch.tools import warm_cache as WC

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "warm_cache.py"


def _calls(tree, name):
    """The keyword arguments (literals, or names left as strings) of every
    call of ``name`` in the script, in source order."""
    calls = sorted((node for node in ast.walk(tree)
                    if isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == name), key=lambda n: n.lineno)
    return [{k.arg: (k.value.id if isinstance(k.value, ast.Name)
                     else ast.literal_eval(k.value)) for k in node.keywords}
            for node in calls]


def test_programs_and_configs_are_the_jax_tools():
    tree = ast.parse(SCRIPT.read_text())
    # for window in (5, 15): LiodomConfig(local_map_size=window, ...)
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.target, ast.Name) and n.target.id == "window"]
    assert len(loops) == 1
    windows = ast.literal_eval(loops[0].iter)
    cfg_calls = _calls(tree, "LiodomConfig")
    map_calls = _calls(tree, "MapConfig")
    names = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and n.value in ("kitti_image_step", "kitti_combined")]
    assert len(map_calls) == 1 and len(cfg_calls) == 2
    rw = 4096
    assert WC.RING_WIDTH == rw

    def jcfg(kw, **bind):
        return JConfig(**{k: bind.get(v, v) if isinstance(v, str) else v
                          for k, v in kw.items()})

    want = [("kitti_image_step", jcfg(cfg_calls[0], window=w, rw=rw), None)
            for w in windows]
    want.append(("kitti_combined", jcfg(cfg_calls[1], rw=rw),
                 JMapConfig(**map_calls[0])))
    got = WC.programs()
    assert [p.name for p in got] == [w[0] for w in want]
    assert sorted(set(names)) == sorted({w[0] for w in want})
    for p, (_, c, m) in zip(got, want):
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(c)
        if m is None:
            assert p.mcfg is None
        else:
            assert dataclasses.asdict(p.mcfg) == dataclasses.asdict(m)
    assert [p.cfg.local_map_size for p in got] == [5, 15, 15]
    assert [p.cfg.mapping for p in got] == [False, False, True]
    assert WC.programs(1024)[2].cfg.ring_width == 1024


def test_cpu_runs_the_programs_and_builds_nothing(monkeypatch, tmp_path,
                                                  capsys):
    def refuse(*a, **k):
        raise AssertionError("--device cpu built something")

    monkeypatch.setattr(kernels, "build_all", refuse)
    monkeypatch.setattr(kernels, "load", refuse)
    monkeypatch.setattr(native, "native_available", refuse)
    libs = tmp_path / "libs"
    assert WC.main(["--device", "cpu", "--dir", str(libs)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-1])
    assert rep["device"] == "cpu" and rep["compiled"] == []
    assert rep["sources"] == {} and rep["native_loader"] is None
    assert list(rep["programs"]) == [p.label for p in WC.programs()]
    for label, s in rep["programs"].items():
        assert s["context_s"] is None and s["load_s"] is None
        for key in ("first_call_s", "second_call_s", "capture_s"):
            assert s[key] > 0, (label, key)
        assert any(line.startswith(label + ":") for line in out[:-1])
    assert not libs.exists()


def test_build_sources_reports_cold_and_warm(monkeypatch, tmp_path):
    """``build_sources`` starts one build a source and names each cold
    (compiled by this call) or warm (found built), by the library path."""
    built = []
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    kernels.library_path("select", "nvcc").touch()

    def fake_build(names):
        for n in names:
            built.append(n)
            kernels.library_path(n, "nvcc").touch()
        return {}

    monkeypatch.setattr(kernels, "build_all", fake_build)
    got = WC.build_sources(("smoothness", "select"))
    assert got["smoothness"]["build"] == "cold"
    assert got["select"]["build"] == "warm"
    assert sorted(built) == ["select", "smoothness"]
    got = WC.build_sources(("smoothness", "select"))
    assert {v["build"] for v in got.values()} == {"warm"}


@pytest.mark.parametrize("argv", [[], ["--dir", "x"]])
def test_without_a_card_it_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WC.main(argv)
