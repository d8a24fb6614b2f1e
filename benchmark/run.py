"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json`` and the
files it names), sets up (the route rendered on the card, the kernels and
the loader built or loaded, the step warmed or captured), measures for
``--seconds`` seconds with the traffic's loop, holds what the window
produced to the plain reference, and prints one JSON line as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number beside its limit, which also end standard error.

Exits non-zero without a result when there is no CUDA card (or fewer than
the cell asks for) and when the process holds JAX or the JAX package once
the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "liodom_tpu")
MARKS = {}      # host clock when set-up passed a mark (``torch``: imported)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``liodom_tpu_torch`` is not ``liodom_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x: float) -> float:
    """JSON has no infinity: a gap that is infinite prints as 1e30."""
    return x if math.isfinite(x) else 1e30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float = T_PROCESS, step_hook=None):
    """Set up and run the cell's loop once: (context, loop result, peak
    device memory in the window).  ``step_hook(port)`` may replace the
    port's step (the fault tests)."""
    import torch

    from benchmark import port
    from benchmark.loops.common import Context
    from benchmark.trace import Tracer

    cfg, mcfg = port.configs(cell.config)
    ctx = Context(cell.config, cell.traffic, cfg, mcfg, device, seed,
                  seconds, Tracer(trace, device), t_process)
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    if step_hook is not None:
        step_hook(port)
    t_in = time.perf_counter()
    if device.type == "cuda":
        torch.empty(1, device=device)     # the allocator exists on it
        torch.cuda.reset_peak_memory_stats(device)
    t_cuda = time.perf_counter()
    ctx.tracer.warm()
    t_prof = time.perf_counter()
    res = loop.run(ctx)
    # what the loop's import_s (process start to the loop) holds
    ctx.extra_setup.update(torch_import_s=MARKS.get("torch", t_in) -
                           t_process, cuda_context_s=t_cuda - t_in,
                           profiler_warm_s=t_prof - t_cuda)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {found} after the window")
    final = res.extra.pop("state")
    diag = res.extra["diag"] = _diagnose(res, final, mcfg is not None)
    if mcfg is not None:
        # a map that dropped points, or a local map as long as its
        # buffer (the cut one), changed the result
        res.lossy += int(diag["overflow"] > 0) + int(
            diag["received_max"] >= mcfg.local_map_capacity)
    del final
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ctx, res, peak


def _diagnose(res, final, mapping: bool) -> dict:
    """What a reader of the run's log wants beside its metrics: edges a
    frame, the drift from the route at the window's end, and with the map
    its occupied slots, rows handed on and points dropped."""
    out = {"edges_per_frame": float(np.mean(res.edge_counts))
           if res.edge_counts is not None and len(res.edge_counts) else 0.0,
           **res.extra.pop("window_diag", {})}
    pos = res.extra.pop("positions", None)
    if pos is not None and len(pos):
        if isinstance(pos, list):          # (route frame, position)
            j, p = pos[-1]
        else:
            j, p = len(pos) - 1, pos[-1]
        if res.extra.get("drive_frames"):
            j %= res.extra["drive_frames"]
        truth = res.frames.truth(res.start_lane, j)
        out.update(end_frame=int(j), end_drift_m=float(
            np.linalg.norm(np.asarray(p) - truth)), end_z_m=float(p[2]))
    if mapping:
        o, m = final
        ends = [e.tolist() for e in res.extra.pop("drive_ends", [])]
        ends.append([int(o.received_valid.sum()), int(m.valid.sum()),
                     int(m.overflow)])
        rec, occ, ovf = np.asarray(ends).T
        out.update(occupied_max=int(occ.max()), received_max=int(rec.max()),
                   overflow=int(ovf.sum()), drives=len(ends))
    return out


def judge(cell, res, device, subject=None, frames=None) -> dict:
    """The compared numbers of a run: the state before the first frame,
    the sampled frames and the first ones, held to the reference;
    ``subject`` ``"tf32"`` puts the reference at TF32 in the program's
    place (the control).  ``frames``, a list, takes each kept frame's
    (translation, rotation) gap."""
    from benchmark import check
    from benchmark.reference import mapping as RM
    from benchmark.reference import odometry as RO

    prm = RO.Params.of(cell.config["odometry"])
    mconf = cell.config.get("map")
    mprm = RM.MapParams.of(mconf) if mconf else None
    j = check.Judge(prm, mprm, mconf["local_map_capacity"] if mconf else 0,
                    subject)
    for s in res.samples:
        j.frame(s, res.frames.spin(s.lane, s.index),
                s.lane if res.batched else None)
    j.init(res.init)
    j.worst("lossy_frames", res.lossy if subject is None else 0)
    if frames is not None:
        frames.extend(j.frame_gaps())
    return j.numbers()


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float = T_PROCESS, step_hook=None) -> dict:
    """Set up, measure and judge one run of ``cell`` on ``device``;
    returns the result's keys."""
    import torch

    from benchmark import check, spec

    ctx, res, peak = measure(cell, seed, seconds, trace, device, t_process,
                             step_hook)
    t_judge = time.perf_counter()
    checks = check.verdict(judge(cell, res, device), cell.limits)
    ctx.extra_setup["check_s"] = time.perf_counter() - t_judge
    out = {"correct": check.correct(checks), "attempted": res.attempted,
           "failed": res.failed + res.lossy}
    run_view = SimpleNamespace(result=res, ctx=ctx, cfg=ctx.cfg,
                               mcfg=ctx.mcfg, trace=ctx.tracer.trace,
                               spec=spec)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(run_view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(res.end_to_end, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": _finite(e2e[m["name"]]),
                                      "unit": m["unit"]}
    out["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    tr = ctx.tracer.trace
    if trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        # the traced stretch's own rate, beside the window's (the profiler
        # slows the host)
        ctx.extra_setup["traced_frames_per_s"] = tr.frames / tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    out["device"] = dev
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    out["setup"] = {"setup_s": ctx.setup_s, **ctx.extra_setup,
                    **res.extra.get("diag", {})}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from benchmark import spec
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    import torch
    MARKS["torch"] = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s): available "
            f"{torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"the process holds {found}: no result")
        return 3
    checks = out.pop("checks")
    setup = out.pop("setup")
    log("setup: " + json.dumps(setup))
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
