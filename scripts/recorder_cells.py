"""The benchmark's cells run with the port's span recorder armed, on the
card: what the program's own spans and counters read at the untraced rate.

    python3 scripts/recorder_cells.py run --workload <cell> --seed <n> \
        --seconds <s> --armed 0|1 [--trace 0|1] [--out FILE]
    python3 scripts/recorder_cells.py graphs [--frames N] [--out FILE]

``run`` sets up and measures one cell as ``python3 -m benchmark.run`` does
with ``--trace 0`` (no profiler; with ``--trace 1`` the profiled stretch
too, in which the recorder records nothing, and the cell's own per-layer
metrics), the recorder armed before the loop captures its step
(``--armed 1``) or not, judges the window with the benchmark's check, and
prints one JSON line: ``correct``, the end-to-end metrics, every reader of
``benchmark/metrics`` whose source is the program's record, the ten
longest device gaps with the host span open in each, and per cell a
breakdown: the in-graph layers of each sampled frame
against its ``aot.graph``, for the map cell each whole drive's layer
split and local-map rows, for the live cell each frame's wait before its
stage, its step's host time, its fetch and its due-to-pose latency.

``graphs`` captures the replay and map cells' steps with
``runtime/aot.get_or_compile`` as the benchmark does, counts each graph's
nodes (``cudaGraphGetNodes``), and, where the tree's recorder has
``arm``, captures them again armed, counts those, and holds every output
of ``--frames`` replays of the route's frames armed ``torch.equal`` to
off.  Run it against another tree with ``PYTHONPATH=<tree>``.

Imports torch, numpy, the port and the benchmark; never JAX.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# the checkout's packages, after any tree that PYTHONPATH names
sys.path.append(str(Path(__file__).resolve().parents[1]))

READERS = ("device_idle.program", "loader_idle_ms.replay",
           "graph_device_ms.replay", "aot_copy_ms.replay",
           "lm_solve_device_ms.replay", "knn_device_ms.replay",
           "features_device_ms.replay", "map_device_ms.replay",
           "local_map_rows.replay", "step_host_ms.live",
           "fetch_wait_ms.live")
LAYERS = ("features", "knn", "lm_solve", "window.push", "map.update",
          "map.local")


def _q(values, qs=(0.5, 0.95)):
    if not values:
        return None
    s = sorted(values)
    return [s[min(len(s) - 1, int(q * len(s)))] for q in qs]


def _graph_split(rec, frames) -> dict:
    """Each sampled frame's in-graph layers (ms) against its ``aot.graph``
    and its in-graph ``step``."""
    per = {}
    for n, f, _, s, e, g in rec["device"]:
        if f in frames and (g or n == "aot.graph"):
            key = n if g else "aot.graph"
            per.setdefault(f, {}).setdefault(key, 0.0)
            per[f][key] += (e - s) * 1e-6
    rows = [v for v in per.values() if "aot.graph" in v and "step" in v]
    if not rows:
        return {}
    med = {k: statistics.median(r.get(k, 0.0) for r in rows)
           for k in LAYERS + ("step", "aot.graph")}
    share = [sum(r.get(k, 0.0) for k in LAYERS) / r["aot.graph"]
             for r in rows]
    return {"sampled_frames": len(rows), "median_ms": med,
            "layers_over_graph": [min(share), statistics.median(share),
                                  max(share)],
            "step_over_graph": statistics.median(
                r["step"] / r["aot.graph"] for r in rows)}


def _drives(rec, w, drive: int, drive_ms) -> list:
    """Per whole drive of the window: its host ms a frame (the loop's),
    the median in-graph layers of its sampled frames, its rows a frame."""
    first = min(w.frames)
    out = []
    for d, ms in enumerate(drive_ms):
        lo, hi = first + d * drive, first + (d + 1) * drive
        frames = {f for f in w.frames if lo <= f < hi}
        split = _graph_split(rec, frames)
        got = sorted((f, v) for n, f, v, _ in rec["counts"]
                     if n == "local_map.rows" and lo <= f <= hi)
        rows = ((got[-1][1] - got[0][1]) / (got[-1][0] - got[0][0])
                if len(got) > 1 and got[-1][0] > got[0][0] else None)
        out.append({"drive_ms": ms, "rows_per_frame": rows,
                    **split.get("median_ms", {})})
    return out


def _live(rec, w, t_window: float, rate: float) -> dict:
    """Per frame of the live window: ``stage.put``'s start, the step's
    host time, the fetch's, and the pose's time after the frame was due
    (frames in order, none dropped)."""
    host = [h for h in rec["host"] if h[2] < 0 and w.t0 <= h[3] <= w.t1]
    stage = [h for h in host if h[0] == "stage.put"]
    step = [h for h in host if h[0] == "step"]
    fetch = [h for h in host if h[0] == "fetch"]
    n = min(len(stage), len(step), len(fetch))
    due = [int((t_window + k / rate) * 1e9) for k in range(n)]
    ms = 1e-6
    rows = {"wait_to_stage": [(stage[k][3] - due[k]) * ms for k in range(n)],
            "stage": [(stage[k][4] - stage[k][3]) * ms for k in range(n)],
            "step_host": [(step[k][4] - step[k][3]) * ms for k in range(n)],
            "fetch": [(fetch[k][4] - fetch[k][3]) * ms for k in range(n)],
            "due_to_pose": [(fetch[k][4] - due[k]) * ms for k in range(n)]}
    kids = {}
    idx = {id(h): i for i, h in enumerate(rec["host"])}
    steps = {idx[id(h)] for h in step}
    for h in rec["host"]:
        if h[2] in steps:
            kids.setdefault(h[0], []).append((h[4] - h[3]) * ms)
    dev = {}
    for nme, f, up, s, e, g in rec["device"]:
        if nme == "step" and not g and f in w.frames:
            dev.setdefault("step_device", []).append((e - s) * ms)
    out = {k: _q(v) for k, v in rows.items()}
    out["frames"] = n
    out["step_children_host_p50"] = {k: _q(v)[0] for k, v in kids.items()}
    out["step_children_host_sum_per_frame"] = {
        k: sum(v) / max(n, 1) for k, v in kids.items()}
    out["step_device"] = _q(dev.get("step_device", []))
    return out


def run(args) -> dict:
    import torch

    from benchmark import check, spans, spec
    from benchmark import run as R
    from liodom_tpu_torch.runtime import tracer

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    dev = torch.device(args.device)
    if args.armed:
        tracer.arm(dev)
    ctx, res, peak = R.measure(cell, args.seed, args.seconds,
                               bool(args.trace), dev, T_PROCESS)
    tracer.disarm()
    rec = tracer.snapshot() if args.armed else None
    checks = check.verdict(R.judge(cell, res, dev), cell.limits)
    view = SimpleNamespace(result=res, ctx=ctx, program=rec,
                           trace=ctx.tracer.trace, cfg=ctx.cfg,
                           mcfg=ctx.mcfg, spec=spec)
    out = {"workload": args.workload, "seed": args.seed,
           "armed": args.armed, "correct": check.correct(checks),
           "failed": res.failed + res.lossy,
           "end_to_end": dict(res.end_to_end, setup_s=ctx.setup_s),
           "memory_peak_bytes": int(peak),
           "diag": res.extra.get("diag", {})}
    if args.trace:
        out["traced"] = {m["name"]: cell.reader(m["name"]).read(view)
                         for m in cell.per_layer}
    if rec is not None:
        out["metrics"] = {n: cell.reader(n).read(view) for n in READERS}
        out["program_idle_gaps"] = spans.longest_gaps(view)
        w = spans.window(view)
        out["spans"] = {"host": len(rec["host"]),
                        "device": len(rec["device"]),
                        "window_frames": len(w.frames) if w else 0}
        if w is not None:
            out["graph_split"] = _graph_split(rec, w.frames)
            drive_ms = out["diag"].get("drive_ms")
            if drive_ms:
                drive = (cell.config["route"]["ramp_frames"]
                         + cell.config["route"]["circuit_frames"]
                         * cell.traffic["drive_laps"])
                out["drives"] = _drives(rec, w, drive, drive_ms)
            if "rate_hz" in cell.traffic:
                out["live"] = _live(rec, w, ctx.t_process + ctx.setup_s,
                                    cell.traffic["rate_hz"])
    out["device"] = (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else dev.type)
    return out


def _node_count(graph) -> int:
    import ctypes
    import glob
    import os

    import torch
    names = ["libcudart.so.12", "libcudart.so"] + glob.glob(os.path.join(
        os.path.dirname(torch.__file__), "..", "nvidia", "cuda_runtime",
        "lib", "libcudart.so*"))
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    n = ctypes.c_size_t(0)
    rc = lib.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                               None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetNodes returned {rc}")
    return int(n.value)


def graphs(args) -> dict:
    import torch

    from benchmark import port, spec, world
    from liodom_tpu_torch.runtime import aot, tracer

    kept = []
    real_graph, real_capture = torch.cuda.CUDAGraph, aot.capture_graph

    def keep_graph():
        return real_graph(keep_graph=True)

    def capture(call, dev):
        g, out = real_capture(call, dev)
        kept.append(g)
        return g, out

    torch.cuda.CUDAGraph = keep_graph
    aot.capture_graph = capture
    dev = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    can_arm = hasattr(tracer, "arm")
    out = {"tree": aot.__file__, "can_arm": can_arm}
    for name in ("kitti-odom.replay", "kitti-map.replay"):
        cell = spec.Cell(bench, name)
        cfg, mcfg = port.configs(cell.config)
        sc, route = cell.config["scene"], cell.config["route"]
        frames, _, _ = world.make_frames(11, {**route, **sc}, 1, 0, dev,
                                         sc["columns"])
        imgs = [port.split(frames.lap[j].cpu().numpy(), cfg)
                for j in range(args.frames)]
        port.prepare(mcfg is not None, dev)
        shape = (cfg.scan_lines, cfg.ring_width, 3)
        got = {}
        for armed in ((False, True) if can_arm else (False,)):
            if armed:
                tracer.arm(dev)
            state = port.init(cfg, mcfg, dev)
            example = (state, torch.zeros(shape, device=dev),
                       torch.zeros(shape[:1], dtype=torch.int32, device=dev))
            step = port.captured("nodes_" + name, port.step_fn(cfg, mcfg),
                                 example, f"{cfg}|{mcfg}",
                                 port.path_kernels(mcfg is not None))
            nodes = _node_count(kept[-1])
            outs = []
            for img, cnt, _ in imgs:
                x = torch.as_tensor(img, device=dev)
                c = torch.as_tensor(cnt, device=dev)
                state, pose, ne = step(state, x, c)
                outs += [t for t in torch.utils._pytree.tree_flatten(
                    (state, pose, ne))[0] if isinstance(t, torch.Tensor)]
            torch.cuda.synchronize()
            if armed:
                tracer.disarm()
            got[armed] = (nodes, [t.cpu() for t in outs])
        row = {"nodes_off": got[False][0]}
        if can_arm:
            a, b = got[False][1], got[True][1]
            row.update(nodes_armed=got[True][0],
                       outputs=len(a), equal=len(a) == len(b) and all(
                           x.dtype == y.dtype and torch.equal(x, y)
                           for x, y in zip(a, b)))
        out[name] = row
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--seconds", type=float, default=30.0)
    r.add_argument("--armed", type=int, choices=(0, 1), default=1)
    r.add_argument("--trace", type=int, choices=(0, 1), default=0)
    r.add_argument("--out", default=None)
    r.add_argument("--device", default="cuda:0")
    g = sub.add_parser("graphs")
    g.add_argument("--frames", type=int, default=20)
    g.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args) if args.cmd == "run" else graphs(args)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & {"jax", "jaxlib", "liodom_tpu"})
    if found:
        print(f"the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
