"""The map update's capacity-sized against its frame-sized work on the card,
and ``update_map``'s C-sized fold against ``update_map_sparse_epilogue``'s
E-sized one.

    python3 scripts/map_fold_split.py [--capacities 524288,4194304] \
        [--load 0.62] [--reps 200] [--out FILE]

For each capacity C the map is filled to ``--load`` of its slots with
random leaves (points spread over 2 km x 2 km x 10 m, nearly every one a
leaf of its own, inserted by ``update_map`` in blocks), then one frame of
5,632 edges is taken: half of them on stored leaves (matched), half on new
ground (claimed).  Each piece is captured as a CUDA graph on that state
(``runtime/aot.capture_graph``) and timed with CUDA events over ``--reps``
replays, the variants in turns (fold, sparse, sparse, fold):

* ``update_fold`` / ``update_sparse``: the whole update either way;
* ``insert``: ``grid.insert_frame`` (transform, codes, the probe with its
  copy of the table), and ``table_copy``: the table's copy alone (C);
* ``fold``: ``grid.fold_frame`` on the insert's result, and ``slot_sums``:
  its frame-sized per-slot sums alone (E);
* ``local_map``: ``get_local_map`` (K7 reads every row's key and valid, C);
* ``state_copy``: a copy of the map state in and a clone out, as
  ``runtime/aot`` does each replay (C).

The two updates' slots, keys, validity, table and overflow are held equal
and their centroids within float32 rounding.  One JSON line a capacity,
the card's name and power limit beside it.  Imports torch, numpy and the
port; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.append(str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from liodom_tpu_torch.core.config import MapConfig  # noqa: E402
from liodom_tpu_torch.core.pose import Pose  # noqa: E402
from liodom_tpu_torch.mapping import grid as G  # noqa: E402
from liodom_tpu_torch.runtime import aot  # noqa: E402
from liodom_tpu_torch.runtime.device_io import prepare_kernels  # noqa: E402

EDGES = 5632
BLOCK = 65536


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def filled_map(cap: int, load: float, cfg: MapConfig, dev, rng):
    """A map of ``cap`` slots holding about ``load * cap`` leaves."""
    state = G.init_map(cap, device=dev)
    ident = Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                 torch.zeros(3, device=dev))
    left = int(load * cap)
    while left > 0:
        n = min(BLOCK, left)
        pts = np.column_stack([rng.uniform(-1000, 1000, (n, 2)),
                               rng.uniform(-5, 5, n)])
        pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        state = G.update_map(state, pts, torch.ones(n, dtype=torch.bool,
                                                    device=dev), ident, cfg)
        left -= n
    return state, ident


def frame(state, rng, dev):
    """5,632 edges: half near stored leaves, half on new ground."""
    rows = torch.nonzero(state.valid).squeeze(1)
    pick = rows[torch.as_tensor(rng.integers(0, len(rows), EDGES // 2),
                                device=dev)]
    old = state.xyz[pick] + torch.as_tensor(
        rng.normal(0, 0.02, (EDGES // 2, 3)), dtype=torch.float32,
        device=dev)
    new = torch.as_tensor(np.column_stack([
        rng.uniform(1500, 1600, (EDGES - EDGES // 2, 2)),
        rng.uniform(-5, 5, EDGES - EDGES // 2)]), dtype=torch.float32,
        device=dev)
    return torch.cat([old, new]), torch.ones(EDGES, dtype=torch.bool,
                                             device=dev)


def timed(graph, reps: int) -> float:
    """ms a replay over ``reps`` replays."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def state_copy(state, statics) -> list:
    """What ``runtime/aot`` does to the map state each replay: copied into
    the graph's inputs, its outputs cloned."""
    for s, x in zip(statics, state):
        s.copy_(x)
    return [s.clone() for s in statics]


def one_capacity(cap: int, load: float, reps: int, dev) -> dict:
    rng = np.random.default_rng(cap)
    cfg = MapConfig(voxel_xysize=30.0, voxel_zsize=35.0, resolution=0.4,
                    cells_xy=3, cells_z=2, map_capacity=cap)
    state, pose = filled_map(cap, load, cfg, dev, rng)
    pts, valid = frame(state, rng, dev)
    ins = G.insert_frame(state, pts, valid, pose, cfg)
    seg_slot = torch.where(valid & ~ins.failed, ins.slot.to(torch.int64),
                           cap)
    payload = torch.cat([ins.xyz, valid[:, None].float()], 1)
    calls = {
        "update_fold": lambda: G.update_map(state, pts, valid, pose, cfg),
        "update_sparse": lambda: G.update_map_sparse_epilogue(
            state, pts, valid, pose, cfg),
        "insert": lambda: G.insert_frame(state, pts, valid, pose, cfg),
        "table_copy": lambda: state.code.clone(),
        "fold": lambda: G.fold_frame(state, valid, ins, cfg),
        "slot_sums": lambda: G._slot_sums(seg_slot, payload, cap),
        "local_map": lambda: G.get_local_map(state, pose.t, cfg,
                                             capacity=262144),
        "state_copy": lambda: state_copy(state, statics),
    }
    statics = [x.clone() for x in state]
    graphs, outs = {}, {}
    for name, call in calls.items():
        graphs[name], outs[name] = aot.capture_graph(call, dev)
    ms = {name: [] for name in calls}
    updates = ("update_fold", "update_sparse")
    for name in calls:
        if name not in updates:
            ms[name] += [timed(graphs[name], reps) for _ in range(2)]
    for name in updates + updates[::-1]:          # in turns
        ms[name].append(timed(graphs[name], reps))
    fold, sparse = outs["update_fold"], outs["update_sparse"]
    torch.cuda.synchronize()
    same = (torch.equal(fold.valid, sparse.valid)
            and torch.equal(fold.key, sparse.key)
            and torch.equal(fold.code, sparse.code)
            and torch.equal(fold.overflow, sparse.overflow))
    cgap = float((fold.xyz - sparse.xyz).abs().max())
    return {"capacity": cap, "occupied": int(state.valid.sum()),
            "claimed": int(fold.valid.sum() - state.valid.sum()),
            "ms": {k: [round(v, 6) for v in vs] for k, vs in ms.items()},
            "median_ms": {k: float(np.median(vs)) for k, vs in ms.items()},
            "fold_equals_sparse": same, "centroid_gap_m": cgap,
            "overflow": int(fold.overflow)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacities", default="524288,4194304")
    ap.add_argument("--load", type=float, default=0.62)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("map_fold_split needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    prepare_kernels(["probe_insert", "local_map_compact"], dev)
    card = _card()
    for cap in (int(c) for c in args.capacities.split(",")):
        row = dict(one_capacity(cap, args.load, args.reps, dev), card=card)
        text = json.dumps(row)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
