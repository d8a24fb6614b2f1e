"""The port of ``bench.py`` (``liodom_tpu_torch/tools/bench``) on the CPU.

* Its rows, their keys, the final line's keys and its constants against
  ``bench.py``'s, read from the source with ``ast``: importing ``bench.py``
  would turn on JAX's persistent compilation cache in this process.
* Its configurations field for field against the JAX package's, and the
  scans of three frames at ``bench.py``'s width, rendered and split,
  ``np.array_equal`` to the JAX package's ``BoxWorld`` and native split.
* A small run of ``run(device="cpu")`` (ring width 512, 256 columns, 1 + 2
  frames, chunks of 2, one timed repetition of each chained course, B = 2):
  the final poses of the odometry, window-15, Ouster and both combined
  phases against the same procedure written with the JAX package's
  functions, within 1 cm and 1e-3 rad (the two engines
  sum the solve in another order); the chained phases within 1e-6 m of the
  per-frame ones, the batch lanes within 1 cm of solo; graph equal to eager
  (``get_or_compile``'s CPU route); every rate finite.
* The gate: a perturbed chained step flags its row and drops its keys, and
  ``main`` returns 0.  The budget: at 0 s the odometry row and a final line
  with every other phase skipped.  The device: ``run()`` raises without
  CUDA.

The graphs against their eager runs on the card are
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``bench`` phase.
"""

import ast
import dataclasses
import json
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.core.synth import BoxWorld as JBoxWorld
from liodom_tpu.core.synth import drive_trajectory as j_drive
from liodom_tpu.core.synth import yaw_matrix as j_yaw
from liodom_tpu.mapping import service as JS
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.runtime import native as jnative

from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.tools import bench as B

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parent.parent / "bench.py"
SMALL = dict(width=256, ring_width=512, n_warm=1, n_bench=2,
             map_capacity=65536, local_map_capacity=4096, batches=(2,),
             chunk=2, reps=1)
POSE_M, POSE_RAD = 0.01, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache():
    """Nothing here turns the persistent cache on; kept off for the JAX
    side as the other files that run JAX steps keep it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIODOM_JAX_CACHE", "off")
        yield


def _source():
    return ast.parse(SCRIPT.read_text())


def _name(node) -> str:
    """A key or metric literal; an f-string's fields become ``{}``."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                   for v in node.values)


def _bench_lines(tree):
    """(rows, final keys) of ``bench.py``: each dict literal with a
    ``metric`` key in source order, as (metric, keys); the last is the
    final line's, whose keys also take every ``final[...] =``."""
    dicts = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                    and any(isinstance(k, ast.Constant) and k.value == "metric"
                            for k in n.keys)), key=lambda n: n.lineno)
    lines = [(_name(d.values[[k.value for k in d.keys].index("metric")]),
              [_name(k) for k in d.keys]) for d in dicts]
    final = list(lines[-1][1])
    for n in ast.walk(tree):
        target = n.targets[0] if isinstance(n, ast.Assign) else None
        if (isinstance(target, ast.Subscript)
                and getattr(target.value, "id", "") == "final"):
            final.append(_name(target.slice))
    return lines[:-1], final


def _matches(template: str, key: str) -> bool:
    return re.fullmatch(re.escape(template).replace(r"\{\}", r"\d+"),
                        key) is not None


def _numbers(tree, name: str):
    """Every number compared with ``remaining()`` (``>`` or ``<=``) in
    source order, or assigned to ``name``."""
    if name == "remaining":
        cmps = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Compare)
                       and isinstance(n.left, ast.Call)
                       and getattr(n.left.func, "id", "") == "remaining"),
                      key=lambda n: n.lineno)
        return [ast.literal_eval(c.comparators[0]) for c in cmps]
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign):
            t = n.targets[0]
            names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                     else [getattr(t, "id", None)])
            if name in names:
                val = ast.literal_eval(n.value)
                return val if len(names) == 1 else val[names.index(name)]
    raise KeyError(name)


@pytest.fixture(scope="module")
def small():
    lines = []
    out = B.run(device="cpu", emit=lines.append, **SMALL)
    return out, lines


def test_rows_keys_and_constants_are_bench_py_s(small):
    tree = _source()
    rows, final_keys = _bench_lines(tree)
    out, lines = small
    assert lines[-1] is out["final"] and lines[:-1] == out["rows"]
    got = [r["metric"] for r in out["rows"]]
    assert len(got) == len(rows) == 7
    for (metric, keys), row in zip(rows, out["rows"]):
        assert _matches(metric, row["metric"]), (metric, row["metric"])
        assert set(keys) <= set(row), set(keys) - set(row)
        assert "eager_value" in row and "graph_vs_eager_m" in row
    final = out["final"]
    want = [k for k in final_keys if k != "combined_skipped"]
    missing = [k for k in want if not any(_matches(k, g) for g in final)]
    assert not missing
    rate_keys = [k for k in final if k.endswith("_scans_per_s")
                 or k.endswith("_pf_control")]
    assert len(rate_keys) == 2 * 8
    for k in rate_keys:
        assert k.startswith("eager_") or f"eager_{k}" in final
    assert final["card"] == "cpu" and final["build_s"] is None
    # the inputs and the protocol
    assert B.BASELINE_SCANS_PER_S == _numbers(tree, "BASELINE_SCANS_PER_S")
    assert B.CHAIN_PARITY_TOL_M == _numbers(tree, "CHAIN_PARITY_TOL_M")
    assert (B.N_WARM, B.N_BENCH) == (_numbers(tree, "n_warm"),
                                     _numbers(tree, "n_bench"))
    assert B.CHUNK == _numbers(tree, "chain_k")
    assert B.REPS == _numbers(tree, "reps")
    fors = [n for n in ast.walk(tree) if isinstance(n, ast.For)
            and getattr(n.target, "id", "") == "bsz"]
    assert B.BATCHES == ast.literal_eval(fors[0].iter)
    assert list(B.HEADROOM_S.values()) == _numbers(tree, "remaining")
    assert "\"520\"" in SCRIPT.read_text() and B.BUDGET_S == 520.0
    widths = {k.value.value for n in ast.walk(tree) if isinstance(n, ast.Call)
              for k in n.keywords if k.arg == "width"}
    assert widths == {B.WIDTH}
    maps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "id", "") == "MapConfig"]
    kw = {k.arg: ast.literal_eval(k.value) for k in maps[0].keywords}
    assert kw == {"local_map_capacity": B.LOCAL_MAP_CAPACITY,
                  "map_capacity": B.MAP_CAPACITY}


def test_configs_are_the_jax_bench_s():
    cfgs = B.configs()
    jcfg = JConfig(local_map_size=5)
    want = {"cfg": jcfg, "ccfg": jcfg.replace(mapping=True),
            "cfg15": jcfg.replace(local_map_size=15),
            "ocfg": jcfg.replace(lidar_type=1, laser_frame=""),
            "mcfg": JMapConfig(local_map_capacity=16384,
                               map_capacity=524288)}
    assert set(cfgs) == set(want)
    for name, j in want.items():
        assert dataclasses.asdict(cfgs[name]) == dataclasses.asdict(j), name
    assert cfgs["cfg"].ring_width == 4096


def test_scans_are_the_jax_bench_s():
    """Three frames at bench.py's width (``bench.py:96-109,224-231``)."""
    cfgs = B.configs()
    cfg, ocfg = cfgs["cfg"], cfgs["ocfg"]
    raw = B.spins(3)
    vel, ous = B.velodyne_scans(cfg, raw), B.ouster_scans(ocfg, raw)
    world = JBoxWorld(seed=0)
    pos, yaws = j_drive(3, speed=1.2, yaw_rate=0.01)
    for i in range(3):
        scan = world.render(pos[i], j_yaw(yaws[i]), width=1800, noise=0.01,
                            seed=i)
        np.testing.assert_array_equal(raw[i], scan)
        img, counts, n_drop = jnative.split_velodyne(
            scan.astype(np.float32), 64, 4096, cfg.min_range, cfg.max_range)
        assert n_drop == 0
        assert np.array_equal(vel[i][0], img)
        assert np.array_equal(vel[i][1], counts)
        img, counts, n_drop = jnative.split_ouster_np(
            scan.reshape(64, 1800, 3), 4096, ocfg.min_range, ocfg.max_range)
        assert n_drop == 0
        assert np.array_equal(ous[i][0], img)
        assert np.array_equal(ous[i][1], counts)
        assert int(counts.sum()) > 50000


def _jax_poses():
    """The bench's procedure at ``SMALL`` with the JAX package's
    functions: every frame's pose of each per-frame phase (the 15-frame
    window's first two: JAX's brute-force kNN takes ~6 s a frame there on
    the CPU)."""
    jcfg = JConfig(local_map_size=5, ring_width=SMALL["ring_width"])
    jm = JMapConfig(local_map_capacity=SMALL["local_map_capacity"],
                    map_capacity=SMALL["map_capacity"])
    n = SMALL["n_warm"] + SMALL["n_bench"]
    raw = B.spins(n, SMALL["width"])
    out = {}
    for name, cfg, frames in (
            ("odometry", jcfg, n),
            ("window15", jcfg.replace(local_map_size=15), 2),
            ("ouster", jcfg.replace(lidar_type=1, laser_frame=""), n)):
        split = (B.ouster_scans if name == "ouster" else B.velodyne_scans)
        state, out[name] = JP.init_state(cfg), []
        for x, c in split(cfg, raw[:frames]):
            state, pose, _ = JP.image_step(state, jnp.asarray(x),
                                           jnp.asarray(c), cfg)
            out[name].append(pose)
    ccfg = jcfg.replace(mapping=True)
    scans = B.velodyne_scans(jcfg, raw)
    for name, every_frame in (("combined", True), ("combined_async", False)):
        (co, cm), out[name] = JS.init_combined(ccfg, jm), []
        for i, (x, c) in enumerate(scans):
            co, cm, pose, _ = JS.combined_image_step(
                co, cm, jnp.asarray(x), jnp.asarray(c), ccfg, jm,
                step=0 if every_frame else i, local_map_every=4)
            out[name].append(pose)
    return out


def test_poses_match_the_jax_procedure(small):
    out, _ = small
    n = SMALL["n_warm"] + SMALL["n_bench"]
    for name, track in _jax_poses().items():
        assert len(track) == (2 if name == "window15" else n)
        for mode in B.MODES:
            poses = out["poses"][name][mode]
            assert len(poses) == n
            for i, (p, jp) in enumerate(zip(poses, track)):
                dt = float(np.abs(p.t.numpy() - np.asarray(jp.t)).max())
                dq = float(np.abs(p.q.numpy() - np.asarray(jp.q)).max())
                assert dt < POSE_M and dq < POSE_RAD, (name, mode, i, dt, dq)
        assert float(np.linalg.norm(np.asarray(track[-1].t))) > 0.1, name
    # the two cadences part after the first refresh they differ on
    a, e = out["poses"]["combined_async"]["eager"], out["poses"]["combined"][
        "eager"]
    assert not torch.equal(a[-1].t, e[-1].t)


def test_chained_and_batch_rows_against_the_per_frame_rows(small):
    out, _ = small
    poses = out["poses"]
    rows = {r["metric"]: r for r in out["rows"]}
    for name, ref in (("chained", "odometry"),
                      ("combined_chained", "combined_async")):
        for mode in B.MODES:
            got, want = poses[name][mode], poses[ref][mode]
            assert len(got) == len(want) == 3
            for p, q in zip(got, want):
                gap = float(np.linalg.norm(p.t.numpy() - q.t.numpy()))
                assert gap <= 1e-6, (name, mode, gap)
    for metric in ("odometry_scans_per_s_chained",
                   "combined_scans_per_s_chained"):
        row = rows[metric]
        assert row["final_pose_err_vs_per_frame_m"] <= 1e-6
        assert row["eager_final_pose_err_vs_per_frame_m"] <= 1e-6
        assert row["chunk"] == SMALL["chunk"]
    for mode in B.MODES:
        for lanes, solo in zip(poses["batched_B2"][mode],
                               poses["odometry"][mode]):
            assert lanes.t.shape == (2, 3)
            assert float((lanes.t - solo.t).abs().max()) < POSE_M
            assert float((lanes.q - solo.q).abs().max()) < POSE_RAD
    row = rows["batched_odometry_scans_per_s_B2"]
    assert row["unit"] == "scans/s aggregate" and row["x_over_solo"] > 0


def test_graph_is_eager_on_the_cpu_and_rates_are_finite(small):
    out, _ = small
    for name, modes in out["poses"].items():
        for g, e in zip(modes["graph"], modes["eager"]):
            assert torch.equal(g.t, e.t) and torch.equal(g.q, e.q), name
    for row in out["rows"]:
        assert not row.get("parity_failed"), row["metric"]
        assert row["graph_vs_eager_m"] == 0.0
        for key in ("value", "eager_value", "vs_baseline"):
            assert math.isfinite(row[key]) and row[key] > 0, (row, key)
        assert row["vs_baseline"] == row["value"] / 10.0
    comb = next(r for r in out["rows"]
                if r["metric"] == "combined_scans_per_s_1chip")
    assert comb["lossless"] and 0 < comb["local_map_hits"] <= 4096
    assert not out["warnings"]
    final = out["final"]
    assert all(math.isfinite(v) and v > 0 for k, v in final.items()
               if k.endswith("_scans_per_s"))
    assert not any(k.endswith("_skipped") or "parity" in k for k in final)
    assert json.loads(json.dumps(final)) == final


def _small_constants(monkeypatch):
    """``main`` passes no size: shrink the module's defaults instead."""
    for name, value in (("WIDTH", 256), ("RING_WIDTH", 512), ("N_WARM", 1),
                        ("N_BENCH", 1), ("MAP_CAPACITY", 65536),
                        ("LOCAL_MAP_CAPACITY", 4096), ("BATCHES", ()),
                        ("CHUNK", 1), ("REPS", 1)):
        monkeypatch.setattr(B, name, value)


def _stdout_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_a_diverging_chained_step_is_gated_out(monkeypatch, capsys):
    _small_constants(monkeypatch)
    for phase in ("window15", "ouster", "combined"):
        monkeypatch.setitem(B.HEADROOM_S, phase, math.inf)
    real = P.chained_image_step

    def perturbed(state, xs, cs, cfg, **kw):
        state, poses, n = real(state, xs, cs, cfg, **kw)
        return state, Pose(poses.q, poses.t + 0.01), n

    monkeypatch.setattr(P, "chained_image_step", perturbed)
    assert B.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = [json.loads(x) for x in captured.out.splitlines()]
    assert [r["metric"] for r in lines] == [
        "odometry_scans_per_s_1chip", "odometry_scans_per_s_chained",
        "odometry_scans_per_s_1chip"]
    row, final = lines[1], lines[-1]
    assert row["parity_failed"] is True
    assert row["final_pose_err_vs_per_frame_m"] > B.CHAIN_PARITY_TOL_M
    assert "WARNING: odometry_scans_per_s_chained" in captured.err
    assert not any("chained" in k and "skipped" not in k for k in final)
    assert final["combined_skipped"] and final["window15_skipped"]
    assert not lines[0].get("parity_failed") and final["value"] > 0


def test_no_budget_leaves_the_odometry_row_and_skip_notes(monkeypatch,
                                                          capsys):
    _small_constants(monkeypatch)
    monkeypatch.setattr(B, "BATCHES", (4, 8))
    monkeypatch.setenv("LIODOM_BENCH_BUDGET_S", "0")
    assert B.main(["--device", "cpu"]) == 0
    lines = _stdout_lines(capsys)
    assert len(lines) == 2
    row, final = lines
    assert row["metric"] == final["metric"] == "odometry_scans_per_s_1chip"
    assert row["partial"] and final["value"] == row["value"] > 0
    assert final["combined_skipped"] == B.SKIPPED
    assert {k for k in final if k.endswith("_skipped")} == {
        "chained_skipped", "window15_skipped", "ouster_skipped",
        "combined_skipped", "combined_chained_skipped",
        "batched_B4_skipped", "batched_B8_skipped"}
    assert not any(k.endswith("_scans_per_s") for k in final)


def test_run_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.run()
