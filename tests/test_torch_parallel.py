"""Port parity: the parallel layer's sharded odometry step, the edge-sharded
solve and the launch smokes, on gloo ranks (``tests/torch_ranks.py``).

The port's ranks run as CPU processes in a gloo group; the JAX package runs
the same programs with ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``.  Both get the same numpy edges (the port's CPU
feature path on rendered BoxWorld scans, 1,280 edge slots a frame).

* ``make_sharded_step`` at (data 1, map 2), a local batch of 2 distinct
  sequences on each rank, and at (data 2, map 2), one sequence for each
  data index: every rank's poses within 1 cm and 1e-3 rad of its rows of
  JAX's, and bit-identical across the ranks of a map group.
* ``lm_solve(group=)`` with the correspondences split over 2 ranks against
  the unsharded solve, to 1e-5.
* ``python -m liodom_tpu_torch.parallel.launch --device cpu`` smoke and
  combined-smoke on 2 ranks: equal checksums on both ranks, the smoke's
  against the JAX smoke on the same mesh.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.parallel import launch as JL
from liodom_tpu.parallel import sharded as JS
from liodom_tpu.parallel.mesh import make_mesh as jax_mesh

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import RawScan, RingImage
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops.solver import lm_solve

from test_torch_odometry import _quat_angle
from torch_ranks import REPO, STEP_KW, _free_port, spawn

torch.set_num_threads(1)

N_FRAMES = 4
BATCH = 2


def ring_images(cfg, seed: int, yaw_rate: float, n_frames: int):
    """Ring images (F, R, W, 3), counts (F, R) of BoxWorld(seed) driven at
    0.8 m and ``yaw_rate`` rad a frame, 256-column spins with 5 mm noise,
    split by the port's CPU loader."""
    world = BoxWorld(seed=seed)
    pos, yaws = drive_trajectory(n_frames, speed=0.8, yaw_rate=yaw_rate)
    imgs, cnts = [], []
    for f in range(n_frames):
        scan = world.render(pos[f], yaw_matrix(yaws[f]), width=256,
                            noise=0.005, seed=100 * seed + f)
        img = F.split_scan(RawScan.from_points(torch.from_numpy(scan),
                                               cfg.max_points, device="cpu"),
                           cfg)
        imgs.append(img.xyz.numpy())
        cnts.append(img.count.numpy())
    return np.stack(imgs), np.stack(cnts)


def edges_of(cfg, imgs, cnts):
    """The port's CPU edge selection on each image: (F, E, 3), (F, E)."""
    xs, vs = [], []
    for x, c in zip(imgs, cnts):
        img = RingImage(torch.from_numpy(x), torch.from_numpy(c))
        ec = F.select_edges(img, F.smoothness(img, cfg), cfg)
        xs.append(ec.xyz.numpy())
        vs.append(ec.valid.numpy())
    return np.stack(xs), np.stack(vs)


@functools.lru_cache(maxsize=1)
def _edges():
    """Edges of BATCH distinct drives: (F, B, E, 3), (F, B, E)."""
    cfg = LiodomConfig(**STEP_KW)
    per = [edges_of(cfg, *ring_images(cfg, s, 0.02 * (s + 1), N_FRAMES))
           for s in range(BATCH)]
    return (np.stack([p[0] for p in per], axis=1),
            np.stack([p[1] for p in per], axis=1))


def _jax_sharded_step(data: int, map_: int):
    """JAX make_sharded_step on a (data, map_) mesh of virtual devices over
    the edges: poses q (F, B, 4), t (F, B, 3)."""
    exyz, evalid = _edges()
    jcfg = JConfig(**STEP_KW)
    mesh = jax_mesh(data=data, map_=map_,
                    devices=jax.devices()[:data * map_])
    step = JS.make_sharded_step(mesh, jcfg)
    state = JS.init_batch_state(jcfg, BATCH)
    qs, ts = [], []
    for x, v in zip(exyz, evalid):
        state, pose = step(state, jnp.asarray(x), jnp.asarray(v))
        qs.append(np.asarray(pose.q))
        ts.append(np.asarray(pose.t))
    return np.stack(qs), np.stack(ts)


def assert_close_poses(q, t, jq, jt, what: str) -> None:
    """Per pose: translation within 1 cm, rotation within 1e-3 rad."""
    dt = np.linalg.norm(t - jt, axis=-1)
    dr = [_quat_angle(a, b) for a, b in zip(q.reshape(-1, 4),
                                            jq.reshape(-1, 4))]
    assert dt.max() < 0.01, f"{what}: {dt.max():.2e} m"
    assert max(dr) < 1e-3, f"{what}: {max(dr):.2e} rad"


@pytest.mark.parametrize("data", [1, 2])
def test_sharded_step_matches_jax_shard_map(data, tmp_path):
    exyz, evalid = _edges()
    assert evalid.sum(-1).min() > 400
    jq, jt = _jax_sharded_step(data, 2)
    outs = spawn("sharded_step", 2 * data, data, 2,
                 {"exyz": exyz, "evalid": evalid}, tmp_path)
    b = BATCH // data
    for r, out in enumerate(outs):
        d = r // 2
        rows = slice(d * b, (d + 1) * b)
        assert_close_poses(out["q"], out["t"], jq[:, rows], jt[:, rows],
                           f"rank {r} vs JAX")
        if r % 2:                       # the other rank of its map group
            np.testing.assert_array_equal(out["t"], outs[r - 1]["t"])
            np.testing.assert_array_equal(out["q"], outs[r - 1]["q"])
    # distinct sequences really differ, and the drive moved
    assert np.linalg.norm(jt[-1, 0] - jt[-1, 1]) > 0.01
    assert np.linalg.norm(jt[-1, 0]) > 1.0


def test_lm_solve_split_over_ranks_matches_unsharded(tmp_path):
    rng = np.random.default_rng(3)
    e = 1001                                 # an odd split
    cp = rng.uniform(-20, 20, (e, 3)).astype(np.float32)
    ang, tr = 0.03, np.array([0.4, -0.2, 0.05])
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    world = cp @ rot.T + tr
    dirs = rng.normal(size=(e, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lpa = (world + rng.normal(size=(e, 3)) * 0.01 - dirs * 0.3).astype(
        np.float32)
    lpb = (lpa + dirs * 0.6).astype(np.float32)
    valid = rng.random(e) > 0.1
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    t0 = np.zeros(3, np.float32)
    inputs = dict(cp=cp, lpa=lpa, lpb=lpb, valid=valid, q=q0, t=t0)
    outs = spawn("lm_solve", 2, 1, 2, inputs, tmp_path)
    full = lm_solve(Pose(torch.from_numpy(q0), torch.from_numpy(t0)),
                    *(torch.from_numpy(inputs[k]) for k in ("cp", "lpa",
                                                            "lpb", "valid")),
                    min_range=3.0, max_range=75.0)
    for out in outs:
        np.testing.assert_allclose(out["t"], full.t.numpy(), atol=1e-5)
        np.testing.assert_allclose(out["q"], full.q.numpy(), atol=1e-5)
    np.testing.assert_array_equal(outs[0]["t"], outs[1]["t"])
    assert np.linalg.norm(full.t.numpy() - tr) < 0.01   # it solved


def _launch(cmd: str, n: int = 2) -> list:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "liodom_tpu_torch.parallel.launch",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(r), "--device", "cpu", cmd],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1",
                                      PYTHONPATH=str(REPO))) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        m = re.search(rf"process {r}/{n}: mesh=\{{'data': 1, 'map': {n}\}} "
                      rf"devices={n}", out)
        assert m, f"rank {r} mesh line missing:\n{out[-2000:]}"
    return outs


@pytest.mark.parametrize("cmd", ["smoke", "combined-smoke"])
def test_launch_on_two_gloo_ranks(cmd):
    label = "smoke step" if cmd == "smoke" else "combined smoke"
    checks = []
    for out in _launch(cmd):
        m = re.search(rf"{label} OK, checksum=([0-9.]+)", out)
        assert m, out[-2000:]
        checks.append(float(m.group(1)))
    assert checks[0] == checks[1]
    if cmd == "smoke":
        want = JL.smoke(jax_mesh(data=1, map_=2, devices=jax.devices()[:2]))
        assert checks[0] == pytest.approx(want, abs=1e-3)
    else:
        assert checks[0] > 0.3                  # the course really moved
