"""The long drive over new ground (the benchmark's ``kitti-map.newground``
cell) and what the port counts of its map, on the CPU at small sizes:
``benchmark/streamworld`` renders as the port's ``StreamWorld`` does and a
frame alone as in a batch, the ``drive`` loop's run is judged correct by
the plain reference, the recorder's map and warm-start counters hold what
they count, ``map.probe`` and ``map.fold`` nest in ``map.update``, the
recorder off leaves the map update as it was, and ``run_kitti
--map-capacity`` reaches the map."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu_torch.core.config import MapConfig
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.runtime import tracer

REPO = Path(__file__).resolve().parent.parent
CELL = "kitti-map.newground"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracer.RECORDER.disarm()
    tracer.RECORDER._reset()
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield tracer.RECORDER
    torch.set_num_threads(old)
    tracer.RECORDER.disarm()
    tracer.RECORDER._reset()


def _config(frames=48, columns=360):
    conf = json.loads((REPO / "benchmark" / "configs" /
                       "kitti-hdl64-map-seq00.json").read_text())
    conf["scene"]["columns"] = columns
    conf["route"]["drive_frames"] = frames
    return conf


def small_cell(frames=48):
    """The cell cut to a CPU's size: 360 columns, rings of 1,024, a window of
    3, a 2^14-slot map, 3 drawn and 3 first frames kept."""
    from benchmark import spec
    cell = spec.Cell(spec.load_benchmark(REPO), CELL, REPO)
    conf = _config(frames)
    conf["odometry"].update(ring_width=1024, local_map_size=3)
    conf["map"].update(map_capacity=16384, local_map_capacity=16384)
    cell.config = conf
    kept = cell.traffic["samples"] + cell.traffic["start_frames"]
    cell.traffic = dict(cell.traffic, samples=3, start_frames=3,
                        trace_skip=1, trace_frames=2)
    cell.limits = dict(cell.limits)
    cell.limits["pose_frames_over"] = cell.limits["pose_frames_over"] * 6 \
        // kept
    return cell


@pytest.mark.parametrize("seed", [0, 3])
def test_render_equals_the_ports_streamworld(seed):
    from benchmark import streamworld as SW
    from liodom_tpu_torch.core.synth import StreamWorld, yaw_matrix
    wp = SW.WorldParams(seed=seed)
    pos = np.array([[3.0, -2.0, 0.0], [150.5, 420.0, 0.3],
                    [-1000.0, 77.0, 0.0]])
    rot = np.stack([yaw_matrix(0.3), yaw_matrix(-2.0), yaw_matrix(1.0)])
    sw = StreamWorld(seed=seed)
    sw.set_keepout(pos[:, :2], 3.0)
    objs = SW.Objects.along(wp, pos, pos[:, :2], 3.0, CPU)
    for tx, ty in [(0, 0), (5, 15), (-36, 2), (-35, 1)]:
        p, b = SW.tile_objects(wp, tx, ty, pos[:, :2], 3.0)
        wp_, wb = sw._tile_objects(tx, ty)
        np.testing.assert_array_equal(p, wp_)
        np.testing.assert_array_equal(b, wb)
    pts, t = SW.render(wp, objs, pos, rot, 96, 0.0, [1, 2, 3])
    for f in range(3):
        want = sw.render(pos[f], rot[f], width=96, noise=0.0)
        # float32 rounding, relative to the point's range
        gap = np.abs(pts[f].numpy() - want).max(axis=1)
        assert (gap <= 2e-6 * np.linalg.norm(want, axis=1) + 2e-5).all()
        assert int(torch.isfinite(t[f]).sum()) == int(
            (np.linalg.norm(want, axis=1) < 9e3).sum())
    # a frame alone is the frame in a batch, noise and all
    noisy, _ = SW.render(wp, objs, pos, rot, 96, 0.01, [7, 8, 9])
    for f in range(3):
        alone, _ = SW.render(wp, objs, pos[f:f + 1], rot[f:f + 1], 96, 0.01,
                             [7 + f])
        assert torch.equal(alone[0], noisy[f])
    assert 0.009 < float((noisy - pts).std()) < 0.011


def test_route_turns_without_coming_back():
    from benchmark import streamworld as SW
    conf = _config(4541)
    r = SW.route_from_seed(2**31 + 9, conf["route"])
    pos, rot = r.poses()
    steps = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    np.testing.assert_allclose(steps[:4], [0.205, 0.41, 0.615, 0.82])
    np.testing.assert_allclose(steps[4:], 0.82)
    yaw = np.arctan2(rot[:, 1, 0], rot[:, 0, 0])
    swing = np.unwrap(yaw) - np.unwrap(yaw)[0]
    assert swing.min() >= -1e-9 and swing.max() <= 1.6 + 1e-9
    # frames 800 apart lie far apart: the course never re-enters its path
    far = np.linalg.norm(pos[800:] - pos[:-800], axis=1)
    assert far.min() > 300.0


def test_drive_loop_is_judged_correct(tmp_path, monkeypatch):
    from benchmark import check, run
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    # the harness refuses a process that holds JAX; here other test files
    # of the same worker have imported it
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    cell = small_cell()
    ctx, res, _ = run.measure(cell, 2**31 + 77, 2.0, False, CPU)
    diag = res.extra["diag"]
    assert diag["overflow"] == 0 and res.lossy == 0
    assert diag["occupied_max"] > 0 and diag["received_max"] < 16384
    assert {"world_s", "render_s", "write_s", "capture_s"} <= set(
        ctx.extra_setup)
    checks = check.verdict(run.judge(cell, res, CPU), cell.limits)
    assert check.correct(checks), checks
    assert "program" not in res.extra          # armed only under --trace 1
    assert list(tmp_path.iterdir()) == []       # the drive's files removed


def _drive_images(n, conf):
    from benchmark import port, streamworld as SW
    cfg, _ = port.configs(conf)
    drive = SW.Drive(5, conf, CPU)
    out = []
    for s in drive.spins(0, n):
        img, counts, _ = port.split(s.numpy(), cfg)
        out.append((torch.as_tensor(img), torch.as_tensor(counts)))
    return out


def test_map_counters_and_spans_on_a_drive():
    """``map.claimed`` summed over a drive is the slots occupied at its
    end, ``map.probe_rounds`` the rounds the probe ran, and ``map.probe``
    and ``map.fold`` nest in ``map.update``."""
    from benchmark import port
    from liodom_tpu_torch.ops import probe_insert as PI
    conf = _config(6, 240)
    conf["odometry"].update(ring_width=1024, local_map_size=3)
    conf["map"].update(map_capacity=16384, local_map_capacity=16384)
    cfg, mcfg = port.configs(conf)
    rounds = []
    real = PI.probe_insert_plain

    def counting(*a, **k):
        out = real(*a, **k)
        rounds.append(int(out[-1]))
        return out
    PI_plain, PI.probe_insert_plain = PI.probe_insert_plain, counting
    try:
        tracer.arm(CPU)
        state = port.init(cfg, mcfg, CPU)
        step = port.step_fn(cfg, mcfg)
        for x, c in _drive_images(6, conf):
            state, pose, ne = step(state, x, c)
        tracer.anchor()
        tracer.disarm()
    finally:
        PI.probe_insert_plain = PI_plain
    rec = tracer.snapshot()
    total = {n: v for n, _, v, _ in rec["counts"]}
    occupied = int(state[1].valid.sum())
    assert occupied > 1000 and total["map.claimed"] == occupied
    assert len(rounds) == 6 and total["map.probe_rounds"] == sum(rounds)
    host = rec["host"]
    probes = [h for h in host if h[0] == "map.probe"]
    folds = [h for h in host if h[0] == "map.fold"]
    assert len(probes) == len(folds) == 6
    for h in probes + folds:
        up = host[h[2]]
        assert up[0] == "map.update" and up[3] <= h[3] <= h[4] <= up[4]
    assert all(p[4] <= f[3] for p, f in zip(probes, folds))


def _map_frame(seed=1, n=3000, cap=4096):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-20, 20, (n, 3)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random(n) > 0.1)
    pose = Pose(torch.tensor([1.0, 0.0, 0.0, 0.0]),
                torch.tensor([0.5, -1.0, 0.2]))
    return G.init_map(cap, device="cpu"), pts, valid, pose


@pytest.mark.parametrize("fold", [G._fold, G._sparse_fold],
                         ids=["fold", "sparse"])
def test_recorder_off_leaves_the_map_update_as_it_was(fold, monkeypatch):
    """Off: no event, no counter (``map.folded`` either), the probe called
    as before; the state equal to the update armed and to its two halves
    called directly, with either fold: the dispatcher ``_fold`` or the
    frame-sized plain fold."""
    cfg = MapConfig(map_capacity=4096)
    state, pts, valid, pose = _map_frame()
    calls = []
    real = G.probe_insert

    def probe(*a, **k):
        calls.append(k)
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the recorder was used while off")
    monkeypatch.setattr(G, "probe_insert", probe)
    monkeypatch.setattr(tracer, "count", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    off = G.update_map(state, pts, valid, pose, cfg)
    assert calls == [{}]
    monkeypatch.undo()
    direct = fold(state, valid, G.insert_frame(state, pts, valid, pose, cfg),
                  cfg)
    tracer.arm(CPU)
    on = G.update_map(state, pts, valid, pose, cfg)
    tracer.anchor()
    tracer.disarm()
    for a, b, c in zip(off, on, direct):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    assert int(off.valid.sum()) > 0
    folded = [c for c in tracer.snapshot()["counts"]
              if c[0] == "map.folded"]
    assert folded and folded[-1][2] > 0


def test_copy_bytes_counts_a_replays_copies(monkeypatch):
    """``aot.copy_bytes``: the bytes of the replay's tensor inputs and
    outputs, a host count a replay (the capture faked on the CPU)."""
    from torch.utils._pytree import tree_flatten
    from liodom_tpu_torch.runtime import aot, device_io

    class Graph:
        def replay(self):
            pass

    def capture(call, dev):
        return Graph(), call()
    monkeypatch.setattr(aot, "capture_graph", capture)
    monkeypatch.setattr(device_io, "prepare_kernels", lambda *a, **k: {})

    def fn(state, x, c):
        return (state[0] + 1.0, state[1]), x.sum(), c * 2

    args = ((torch.zeros(1000, 3), torch.zeros(1000, dtype=torch.bool)),
            torch.ones(64, 32, 3), torch.ones(64, dtype=torch.int32))
    leaves, spec = tree_flatten(args)
    tracer.arm(CPU)
    replay = aot._capture(fn, leaves, spec, CPU, [])
    for _ in range(3):
        out = replay(*args)
    tracer.anchor()
    tracer.disarm()
    want = sum(x.nbytes for x in tree_flatten(args)[0] + tree_flatten(out)[0])
    assert want == 12000 + 1000 + 64 * 32 * 12 + 256 + 12000 + 1000 + 4 + 256
    counts = [c for c in tracer.snapshot()["counts"]
              if c[0] == "aot.copy_bytes"]
    assert counts[-1][2] == 3 * want
    # off: nothing counted
    replay(*args)
    assert tracer.snapshot()["counts"][-1][2] == 3 * want


def test_run_kitti_map_capacity_reaches_the_map(monkeypatch):
    from liodom_tpu_torch.apps import run_kitti
    from liodom_tpu_torch.mapping import service
    assert run_kitti.parse_args(["--root", "r"]).map_capacity == 524288
    seen = []

    def stop(cfg, mcfg, device=None):
        seen.append(mcfg)
        raise SystemExit(0)
    monkeypatch.setattr(service, "init_combined", stop)
    monkeypatch.setattr("liodom_tpu_torch.core.io.KittiSequence",
                        lambda root, seq: [None])
    monkeypatch.setattr("liodom_tpu_torch.runtime.device_io.prepare_loader",
                        lambda: {})
    with pytest.raises(SystemExit):
        run_kitti.run(["--root", "r", "--mapping", "--ring-width", "512",
                       "--device", "cpu", "--map-capacity", "4194304"])
    assert seen[0].map_capacity == 4194304
    assert seen[0].local_map_capacity == 65536


@pytest.mark.cuda
def test_map_update_graph_off_keeps_its_nodes():
    """On the card: ``update_map`` captured with the recorder off has the
    nodes of its two halves captured directly (no span, no counter), the
    fold one launch of ``csrc/map_fold.cu`` (and the state's copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    sys.path.insert(0, str(REPO / "scripts"))
    from recorder_cells import _node_count
    from liodom_tpu_torch.runtime import aot
    from liodom_tpu_torch.runtime.device_io import prepare_kernels
    dev = torch.device("cuda")
    prepare_kernels(["probe_insert", "map_fold"], dev)
    cfg = MapConfig(map_capacity=1 << 22)
    state, pts, valid, pose = _map_frame(cap=1 << 22)
    state = G.MapState(*(t.to(dev) for t in state))
    pts, valid = pts.to(dev), valid.to(dev)
    pose = Pose(pose.q.to(dev), pose.t.to(dev))
    real = torch.cuda.CUDAGraph
    counts = []
    torch.cuda.CUDAGraph = lambda: real(keep_graph=True)
    try:
        for fn in (lambda: G.update_map(state, pts, valid, pose, cfg),
                   lambda: G._fold(state, valid, G.insert_frame(
                       state, pts, valid, pose, cfg), cfg)):
            graph, out = aot.capture_graph(fn, dev)
            counts.append(_node_count(graph))
            graph.replay()
            counts.append(out)
    finally:
        torch.cuda.CUDAGraph = real
    assert counts[0] == counts[2]
    assert all(torch.equal(a, b) for a, b in zip(counts[1], counts[3]))
