"""The plain reference against the port's CPU path at small sizes, and
what the harness, the readers and the reference import."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import port, world
from benchmark.reference import features as RF
from benchmark.reference import mapping as RM
from benchmark.reference import odometry as RO
from benchmark.reference.linalg import angle_between

from conftest import ROOT, small_cell


def _spins(cell, n):
    sc, route = cell.config["scene"], cell.config["route"]
    frames, _, _ = world.make_frames(41, {**route, **sc}, 1, 0, "cpu",
                                     sc["columns"])
    return [frames.spin(0, i) for i in range(n)]


def test_split_and_edges_equal_the_port(cpu_threads):
    from liodom_tpu_torch.ops.features import select_edges, smoothness
    from liodom_tpu_torch.core.frame import RingImage
    cell = small_cell("kitti-odom.replay")
    cfg, _ = port.configs(cell.config)
    prm = RO.Params.of(cell.config["odometry"])
    for raw in _spins(cell, 6)[::2]:
        img, counts, drop = port.split(raw.numpy(), cfg)
        rimg, rcounts, rdrop = RF.split_velodyne(
            raw.numpy(), prm.ring_width, prm.min_range, prm.max_range)
        assert np.array_equal(img, rimg) and np.array_equal(counts, rcounts)
        assert drop == rdrop == 0
        x, c = torch.as_tensor(img), torch.as_tensor(counts)
        ec = select_edges(RingImage(x, c), smoothness(RingImage(x, c), cfg),
                          cfg)
        ex, ev, _, _ = RO.frame_edges(raw, prm)
        assert torch.equal(ec.valid, ev)
        assert torch.equal(ec.xyz, ex)


def test_odometry_course_agrees_with_the_port(cpu_threads):
    cell = small_cell("kitti-odom.replay")
    cfg, mcfg = port.configs(cell.config)
    prm = RO.Params.of(cell.config["odometry"])
    step = port.step_fn(cfg, mcfg)
    state = port.init(cfg, mcfg, "cpu")
    ref = RO.init_state(prm, prm.edge_slots, "cpu")
    for raw in _spins(cell, 6):
        img, counts, _ = port.split(raw.numpy(), cfg)
        state, pose, ne = step(state, torch.as_tensor(img),
                               torch.as_tensor(counts))
        ref, rpose, rne, _ = RO.step(ref, raw, prm, "float32")
        assert int(ne) == rne
        # two float32 courses: an LM step whose cost change sits at
        # rounding can be kept by one and dropped by the other
        assert float(torch.linalg.norm(pose.t - rpose.t)) < 1e-2
        assert angle_between(pose.q, rpose.q) < 1e-3


def _chain(state, rows, raw, prm, mp, cap):
    """One frame of the reference's own course with the map."""
    from benchmark.reference.linalg import transform
    ex, ev, _, _ = RO.frame_edges(raw, prm)
    pose = RO.solve(state, ex, ev, prm, "float32")
    window = RO.push(state.window, transform(pose, ex, "float32"), ev)
    rows = RM.update(rows, ex, ev, pose, mp, "float32")
    local = RM.local_map(rows, pose.t, mp)[:cap]
    rx = torch.zeros((cap, 3))
    rv = torch.zeros(cap, dtype=torch.bool)
    rx[:len(local)], rv[:len(local)] = local, True
    return RO.State(window, pose, state.odom, rx, rv), rows, pose


def test_map_frames_agree_with_the_port(cpu_threads):
    cell = small_cell("kitti-map.replay")
    cfg, mcfg = port.configs(cell.config)
    prm = RO.Params.of(cell.config["odometry"])
    mp = RM.MapParams.of(cell.config["map"])
    step = port.step_fn(cfg, mcfg)
    state = port.init(cfg, mcfg, "cpu")
    rows = torch.zeros((0, 3))
    ref = RO.init_state(prm, prm.edge_slots, "cpu", mcfg.local_map_capacity)
    for raw in _spins(cell, 4):
        img, counts, _ = port.split(raw.numpy(), cfg)
        state, pose, ne = step(state, torch.as_tensor(img),
                               torch.as_tensor(counts))
        ref, rows, rpose = _chain(ref, rows, raw, prm, mp,
                                  mcfg.local_map_capacity)
        o, m = state
        # the two courses' poses differ by rounding, so a point on a leaf
        # boundary may land in the next leaf: leaves within 0.1 %
        assert abs(int(m.valid.sum()) - len(rows)) <= 1e-3 * len(rows)
        got = o.received_xyz[o.received_valid]
        want = RM.local_map(rows, rpose.t, mp)
        assert abs(len(got) - len(want)) <= 1e-3 * len(want)
        assert len(want) > 0
        near = torch.cdist(got.double(), want.double()).min(dim=1).values
        assert float((near < 1e-2).double().mean()) >= 0.99


def test_tf32_rounding():
    from benchmark.reference.linalg import mm, round_tf32
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 30.123456])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2**-9
    assert abs(float(r[3]) - 30.123456) < 30.123456 * 2**-11
    a = torch.randn(64, 3) * 30
    rot = torch.linalg.qr(torch.randn(3, 3)).Q
    gap = (mm(a, rot, "tf32") - mm(a, rot, "float32")).abs().max()
    assert 1e-3 < float(gap) < 0.2


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in"
                          " sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_isolation():
    harness = _top_level(
        "import benchmark.run, benchmark.check, benchmark.control, "
        "benchmark.trace, benchmark.roofline, benchmark.world\n"
        "import benchmark.loops.replay, benchmark.loops.live, "
        "benchmark.loops.fleet\n"
        "from benchmark import spec\n"
        "cell = spec.Cell(spec.load_benchmark(), 'kitti-map.replay')\n"
        "b = spec.load_benchmark()\n"
        "[spec.Cell(b, w['name']) for w in b['workloads']]\n"
        "[cell.reader(m['name']) for m in b['per_layer']]\n"
        "import pathlib\n"
        "[spec.count(p.stem) for p in pathlib.Path('benchmark/counts')"
        ".glob('*.py')]\n"
        "from benchmark import port\n"
        "port.configs(cell.config)")
    assert not harness & {"jax", "jaxlib", "flax", "liodom_tpu"}
    assert "liodom_tpu_torch" in harness          # the port, by port.py
    reference = _top_level(
        "import benchmark.reference.features, benchmark.reference.odometry,"
        " benchmark.reference.mapping, benchmark.reference.linalg")
    assert not reference & {"jax", "jaxlib", "flax", "liodom_tpu",
                            "liodom_tpu_torch"}


@pytest.mark.parametrize("name", ["jax", "liodom_tpu", "liodom_tpu_torch"])
def test_forbidden_names_compare_whole(name, monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, name + ".sub", object())
    found = run.forbidden_modules()
    assert (name in found) == (name != "liodom_tpu_torch")
