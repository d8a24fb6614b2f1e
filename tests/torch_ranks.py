"""gloo ranks as subprocesses, for the CPU tests of the port's parallel layer.

:func:`spawn` writes a case's inputs (numpy arrays) to an ``.npz``, starts
one process of this file per rank (``parallel.launch.initialize`` on a free
local port, gloo, then a (data, map) mesh on the CPU), runs the named case
of :data:`CASES` on every rank and returns each rank's outputs in rank
order.  The cases import torch and the port only, so a rank never loads
JAX; the test files hold the JAX references.  Rank r sits at mesh
coordinate (r // map, r % map).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# the configurations of the parallel tests: 1,280 edge slots a frame (64
# rings x 4 regions x 5 picks) keep the CPU's brute-force kNN small
STEP_KW = dict(max_points=16384, ring_width=256, local_map_size=3,
               scan_regions=4, edges_per_region=4)
MAP_KW = dict(map_capacity=8192, local_map_capacity=1024)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case: str, world: int, data: int, map_: int, inputs: dict,
          workdir: Path, timeout: float = 240.0) -> list:
    """Run ``CASES[case]`` on ``world`` gloo ranks of a (data, map_) mesh;
    returns one dict of numpy arrays per rank."""
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]).rstrip(
                       os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(workdir), str(r), str(world),
         str(data), str(map_), str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {case} failed "
                                 f"(rc {p.returncode}):\n{out[-4000:]}")
    return [dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]


# ---- the cases: (mesh, inputs) -> outputs, on every rank ------------------

def _pose_arrays(poses) -> dict:
    import torch
    return {"q": torch.stack([p.q for p in poses]).numpy(),
            "t": torch.stack([p.t for p in poses]).numpy()}


def _case_sharded_step(mesh, inp: dict) -> dict:
    """make_sharded_step over frames of edges exyz (F, B, E, 3), evalid
    (F, B, E) of the global batch; this rank steps its data index's rows."""
    import torch
    from liodom_tpu_torch.core.config import LiodomConfig
    from liodom_tpu_torch.parallel.mesh import axis
    from liodom_tpu_torch.parallel.sharded import (init_batch_state,
                                                   make_sharded_step)
    cfg = LiodomConfig(**STEP_KW)
    _, n_data, d = axis(mesh, "data")
    b = inp["exyz"].shape[1] // n_data
    rows = slice(d * b, (d + 1) * b)
    step = make_sharded_step(mesh, cfg)
    state = init_batch_state(cfg, b, device="cpu")
    poses = []
    for x, v in zip(inp["exyz"], inp["evalid"]):
        state, pose = step(state, torch.from_numpy(x[rows]),
                           torch.from_numpy(v[rows]))
        poses.append(pose)
    return _pose_arrays(poses)


def _case_lm_solve(mesh, inp: dict) -> dict:
    """lm_solve with the correspondences split over the map group: this
    rank solves its contiguous half of the rows."""
    import torch
    from liodom_tpu_torch.core.pose import Pose
    from liodom_tpu_torch.ops.solver import lm_solve
    from liodom_tpu_torch.parallel.mesh import axis
    group, n, me = axis(mesh, "map")
    e = inp["cp"].shape[0]
    rows = slice(me * e // n, (me + 1) * e // n)
    t = {k: torch.from_numpy(v[rows]) for k, v in inp.items()
         if k in ("cp", "lpa", "lpb", "valid")}
    pose = lm_solve(Pose(torch.from_numpy(inp["q"]),
                         torch.from_numpy(inp["t"])),
                    t["cp"], t["lpa"], t["lpb"], t["valid"], min_range=3.0,
                    max_range=75.0, group=group)
    return {"q": pose.q.numpy(), "t": pose.t.numpy()}


def _case_combined_image(mesh, inp: dict) -> dict:
    """make_sharded_combined_image_step over ring images imgs (F, R, W, 3),
    cnts (F, R): from the initial state, and from the JAX package's state
    after frame ``k0`` (its stacked layout, taken apart by convert) over the
    frames after it."""
    import torch
    from liodom_tpu_torch import convert
    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.parallel import combined as CB
    from liodom_tpu_torch.parallel.mesh import axis
    cfg = LiodomConfig(mapping=True, **STEP_KW)
    mcfg = MapConfig(**MAP_KW)
    _, _, d = axis(mesh, "data")
    _, _, m = axis(mesh, "map")
    step = CB.make_sharded_combined_image_step(mesh, cfg, mcfg)
    imgs = [(torch.from_numpy(x), torch.from_numpy(c))
            for x, c in zip(inp["imgs"], inp["cnts"])]
    st, ms = CB.init_combined_image_sharded(cfg, mcfg, mesh, device="cpu")
    poses, n_edges = [], []
    for x, c in imgs:
        st, ms, pose, ne = step(st, ms, x, c)
        poses.append(pose)
        n_edges.append(int(ne))
    out = _pose_arrays(poses)
    k0 = int(inp["k0"])
    js = [inp[f"state_{i}"] for i in range(10)]
    jstate = ((js[0], js[1]), (js[2], js[3])) + tuple(js[4:10])
    st2 = convert.sharded_combined_state_from_numpy(jstate, d, m,
                                                    device="cpu")
    ms2 = convert.sharded_map_state_from_numpy(
        tuple(inp[f"map_{i}"] for i in range(6)), (d, m), device="cpu")
    conv = []
    for x, c in imgs[k0 + 1:]:
        st2, ms2, pose, _ = step(st2, ms2, x, c)
        conv.append(pose)
    conv = _pose_arrays(conv)
    out.update(n_edges=np.asarray(n_edges), conv_q=conv["q"],
               conv_t=conv["t"], win_points=int(st.win_valid.sum()),
               map_slots=int(ms.valid.sum()), overflow=int(ms.overflow),
               next_slot=int(st.next_slot), nframes=int(st.nframes))
    return out


def _case_combined_step(mesh, inp: dict) -> dict:
    """make_sharded_combined_step over edges exyz (F, E, 3), evalid (F, E)."""
    import torch
    from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
    from liodom_tpu_torch.parallel import combined as CB
    cfg = LiodomConfig(mapping=True, **STEP_KW)
    mcfg = MapConfig(**MAP_KW)
    step = CB.make_sharded_combined_step(mesh, cfg, mcfg)
    o, ms = CB.init_combined_sharded(cfg, mcfg, mesh, device="cpu")
    poses = []
    for x, v in zip(inp["exyz"], inp["evalid"]):
        o, ms, pose = step(o, ms, torch.from_numpy(x), torch.from_numpy(v))
        poses.append(pose)
    out = _pose_arrays(poses)
    out.update(map_slots=int(ms.valid.sum()), overflow=int(ms.overflow),
               received=int(o.received_valid.sum()))
    return out


def _case_map_fns(mesh, inp: dict) -> dict:
    """make_sharded_map_fns: frames of points pts (F, N, 3), valid (F, N)
    at translations t (F, 3), then the assembled neighbourhood of
    ``position``."""
    import torch
    from liodom_tpu_torch.core.config import MapConfig
    from liodom_tpu_torch.core.pose import Pose
    from liodom_tpu_torch.parallel.mesh import axis
    from liodom_tpu_torch.parallel.sharded_map import (init_sharded_map,
                                                       make_sharded_map_fns)
    mcfg = MapConfig(**MAP_KW)
    _, n, _ = axis(mesh, "map")
    upd, loc = make_sharded_map_fns(mesh, mcfg)
    shard = init_sharded_map(mcfg, n, device="cpu")
    q = torch.tensor([1.0, 0.0, 0.0, 0.0])
    for p, v, t in zip(inp["pts"], inp["valid"], inp["t"]):
        shard = upd(shard, torch.from_numpy(p), torch.from_numpy(v),
                    Pose(q, torch.from_numpy(t)))
    lx, lv = loc(shard, torch.from_numpy(inp["position"]))
    return {"xyz": shard.xyz.numpy(), "valid": shard.valid.numpy(),
            "overflow": int(shard.overflow), "local_xyz": lx.numpy(),
            "local_valid": lv.numpy()}


CASES = {"sharded_step": _case_sharded_step, "lm_solve": _case_lm_solve,
         "combined_image": _case_combined_image,
         "combined_step": _case_combined_step, "map_fns": _case_map_fns}


def _main(argv) -> int:
    case, workdir = argv[0], Path(argv[1])
    rank, world, data, map_, port = (int(a) for a in argv[2:7])
    import torch
    import torch.distributed as dist
    from liodom_tpu_torch.parallel import launch
    torch.set_num_threads(1)
    launch.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = launch.make_global_mesh(data, map_, device="cpu")
        inp = dict(np.load(workdir / "inputs.npz"))
        np.savez(workdir / f"out_{rank}.npz", **CASES[case](mesh, inp))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
