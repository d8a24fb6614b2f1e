"""The check against its control and its faults, at a size a CPU runs:
a sound run is correct; the reference at TF32 in the program's place, a
step that returns its state unchanged, a pose altered where it is made
and, batched, half the lanes left out or half the lanes given a wrong pose
that their state carries on from, each come out not correct.  The
harness's look for a card is skipped (the cells run on the CPU path)."""

import numpy as np
import pytest
import torch

from benchmark import check, run

from conftest import small_cell

CPU = torch.device("cpu")
SEED = 2**31 + 77


def _verdict(cell, res, subject=None):
    gaps = run.judge(cell, res, CPU, subject)
    checks = check.verdict(gaps, cell.limits)
    return check.correct(checks), checks


def _hooked(wrap):
    def hook(port):
        real = port.step_fn

        def step_fn(cfg, mcfg, lanes=1):
            return wrap(real(cfg, mcfg, lanes), lanes)
        port.step_fn = step_fn
    return hook


def unchanged(step, lanes):
    def broken(s, x, c):
        _, pose, ne = step(s, x, c)
        return s, pose, ne
    return broken


def altered(step, lanes):
    def broken(s, x, c):
        s2, pose, ne = step(s, x, c)
        return s2, pose._replace(t=pose.t + 0.05), ne
    return broken


def half_batch(step, lanes):
    """Lanes of the second half left out: their state comes back as it
    went in and their pose is the one they had."""
    def broken(s, x, c):
        s2, pose, ne = step(s, x, c)
        keep = torch.arange(lanes) < lanes // 2

        def pick(new, old):
            m = keep.reshape((lanes,) + (1,) * (new.dim() - 1))
            return torch.where(m, new, old)
        s2 = torch.utils._pytree.tree_map(pick, s2, s)
        pose = pose._replace(q=pick(pose.q, s.odom.q), t=pick(pose.t,
                                                             s.odom.t))
        return s2, pose, ne
    return broken


def _start_lane(lanes: int) -> int:
    """The lane of the fleet loop's first kept frame, as it draws it."""
    rng = np.random.default_rng(np.random.SeedSequence([SEED, 3]))
    return int(rng.integers(lanes))


def half_lanes_moved(step, lanes):
    """The half of the lanes that leaves out the lane of the first kept
    frame given a pose 5 cm off, and carried on from it as a sound step
    carries on from its pose: the state's pose and the edges pushed into
    the window move with it, so the window agrees with the pose and only
    the pose itself is wrong, on fewer than half of the kept frames."""
    start = _start_lane(lanes)

    def broken(s, x, c):
        s2, pose, ne = step(s, x, c)
        lane = torch.arange(lanes, device=pose.t.device)
        wrong = (lane - start) % lanes >= lanes - lanes // 2
        off = wrong.to(pose.t.dtype)[:, None] * 0.05
        w = s2.window
        slot = s.window.next_slot
        xyz = w.xyz.clone()
        pushed = xyz[lane, slot]
        xyz[lane, slot] = torch.where(w.valid[lane, slot][..., None],
                                      pushed + off[:, None, :], pushed)
        s2 = s2._replace(odom=s2.odom._replace(t=s2.odom.t + off),
                         window=w._replace(xyz=xyz))
        return s2, pose._replace(t=pose.t + off), ne
    return broken


CELLS = ["kitti-odom.replay", "kitti-map.replay", "kitti-odom.live10hz",
         "kitti-odom.fleet8"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_control_is_not(workload, cpu_threads):
    cell = small_cell(workload)
    _, res, _ = run.measure(cell, SEED, 2.0, False, CPU)
    ok, checks = _verdict(cell, res)
    assert ok, checks
    ok, checks = _verdict(cell, res, "tf32")
    assert not ok, checks


@pytest.mark.parametrize("workload,fault", [
    ("kitti-odom.replay", unchanged), ("kitti-odom.replay", altered),
    ("kitti-map.replay", unchanged), ("kitti-map.replay", altered),
    ("kitti-odom.live10hz", unchanged), ("kitti-odom.live10hz", altered),
    ("kitti-odom.fleet8", unchanged), ("kitti-odom.fleet8", altered),
    ("kitti-odom.fleet8", half_batch),
    ("kitti-odom.fleet8", half_lanes_moved)],
    ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(workload, fault, cpu_threads, monkeypatch):
    from benchmark import port
    from liodom_tpu_torch.runtime import aot
    monkeypatch.setattr(port, "step_fn", port.step_fn)
    # the warm start keeps a captured step a process; the broken step
    # must not find the sound one there
    monkeypatch.setattr(aot, "_GRAPHS", {})
    cell = small_cell(workload)
    # a fault on some lanes shows on the frames kept from them: the window
    # has to fill every kept slot
    seconds = 6.0 if fault is half_lanes_moved else 2.0
    out = run.run_cell(cell, SEED, seconds, False, CPU,
                       step_hook=_hooked(fault))
    assert out["correct"] is False, out["checks"]



def test_replay_feed_reopens_over_its_cycle(monkeypatch):
    """A program faster than the list of paths was sized for finds the
    list reopened over its repeating part (whole laps or drives, never the
    ramp again), and a list that gives nothing fails by name."""
    from benchmark import port
    from benchmark.loops import replay

    class Loader:
        def __init__(self, paths, cfg, threads):
            self.left = list(paths)

        def next(self):
            return self.left.pop(0) if self.left else None

        def close(self):
            pass

    monkeypatch.setattr(port, "prefetcher", Loader)
    feed = replay.Feed(["r0", "r1"], ["a", "b", "c"], None, 2)
    got = [feed.next() for _ in range(11)]
    assert got == ["r0", "r1"] + ["a", "b", "c"] * 3
    assert feed.reopened == 2
    with pytest.raises(RuntimeError, match="no frame"):
        replay.Feed([], [], None, 2).next()
