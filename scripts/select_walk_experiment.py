#!/usr/bin/env python3
"""K2, the edge selection, on the card: the shipped kernel against an
earlier one, on the same inputs, in one process.

    python3 scripts/select_walk_experiment.py [--earlier DIR]
        [--also LABEL=DIR] [--out FILE]

Builds ``csrc/select.cu`` of this checkout (``shipped``) and, with
``--earlier`` (and ``--also``), ``select.cu`` of other ``csrc``
directories (for example an earlier commit's, unpacked by ``git
archive``: the C entry point is the same), one ``nvcc`` each, together,
into ``kernels/build/experiment/``.

Inputs, at the presets' 8 x 11 = 88 slots a ring (the most the earlier
kernel takes is 128): the bench drive's last frame (lane 0 of
``chip_smoke.py``, 1 cm noise, 64 x 4096 rings) with its smoothness plane;
the same plane quantised to 1/8 (many exact ties); a plane of +0.0 and
-0.0 under a threshold of -0.5 (the picks rest on the column order among
equal zeros); and a plane with -inf columns under -1.0.  The shipped
kernel must give ``select_plain``'s slots and the gathered points bit for
bit on each, also at 8 x 21 = 168 slots, and every other build the shipped
one's bidx, bval and points.  Then each build's time by CUDA events over
50 launches on the bench frame, the builds in turns (forward, then
backward), and the walk's dependent steps a ring on the bench frame
(``select_walk``).  Prints one JSON object (and writes it to ``--out``);
exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.core.frame import RingImage  # noqa: E402
from liodom_tpu_torch.ops import features as F  # noqa: E402
from liodom_tpu_torch.ops import select_pallas as SEL  # noqa: E402

REPS = 50


def build(variants: dict, out_dir: Path) -> dict:
    """{label: (CDLL, ptxas usage)} of ``select.cu`` of each csrc
    directory."""
    nvcc = kernels.nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, csrc in variants.items():
        so = out_dir / f"select-{label}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", str(so),
               str(Path(csrc) / "select.cu")]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for label, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label} select.cu: nvcc exit "
                             f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.liodom_select_edges
        fn.argtypes = SEL._SIG[0][1]
        fn.restype = ctypes.c_int
        libs[label] = (lib, CS.ptxas_usage(log))
    return libs


def select(lib, img: RingImage, sm: torch.Tensor, cfg: LiodomConfig):
    """(bidx, bval, pts) of one build, as the port's wrapper calls it."""
    r, w = sm.shape
    n, mp = cfg.scan_regions, cfg.max_edges_per_region
    bidx = torch.empty((r, n * mp), dtype=torch.int32, device=sm.device)
    bval = torch.empty_like(bidx)
    pts = torch.empty((r, n * mp, 3), dtype=torch.float32, device=sm.device)
    err = lib.liodom_select_edges(
        sm.data_ptr(), img.count.data_ptr(), img.xyz.data_ptr(),
        bidx.data_ptr(), bval.data_ptr(), pts.data_ptr(), r, w, n, mp,
        cfg.min_points_per_scan, SEL.f32(cfg.smoothness_threshold),
        SEL.f32(cfg.neighbor_gap_sq), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "liodom_select_edges")
    return bidx, bval, pts


def planes(img: RingImage, sm: torch.Tensor, cfg: LiodomConfig) -> dict:
    """{name: (smoothness plane, configuration)} of the compared inputs."""
    g = torch.Generator(device="cpu").manual_seed(7)
    u = torch.rand(sm.shape, generator=g).to(sm.device)
    zeros = torch.where(torch.rand(sm.shape, generator=g).to(sm.device)
                        < 0.5, 0.0, -0.0)
    return {"bench": (sm, cfg),
            "quantised": (torch.round(sm * 8.0) / 8.0, cfg),
            "signed_zero": (torch.where(u < 0.8, zeros, -u).contiguous(),
                            cfg.replace(smoothness_threshold=-0.5)),
            "neg_inf": (torch.where(u < 0.4, float("-inf"), sm).contiguous(),
                        cfg.replace(smoothness_threshold=-1.0))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path,
                    help="another csrc directory to build and compare")
    ap.add_argument("--also", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="more csrc directories to build, compare and time")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("select_walk_experiment: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    variants = {"shipped": kernels.CSRC}
    if args.earlier is not None:
        variants["earlier"] = args.earlier
    for spec in args.also:
        label, _, path = spec.partition("=")
        variants[label] = Path(path)
    libs = build(variants, kernels.BUILD_DIR / "experiment")

    cfg = LiodomConfig(local_map_size=5)
    imgs = CS.render_lanes(cfg, dev, [0], noise=0.01)[0][0]
    img = imgs[-1]
    sm = F.smoothness(img, cfg)
    inputs = planes(img, sm, cfg)
    equal, failed = {}, []
    for name, (plane, c) in inputs.items():
        for slots, c_s in ((88, c), (168, c.replace(edges_per_region=20))):
            bidx, bval, pts = select(libs["shipped"][0], img, plane, c_s)
            reach = SEL._reach_plane(img.xyz, c_s.neighbor_gap_sq)
            want_i, want_v = SEL.select_plain(plane, reach, img.count, c_s)
            want = SEL.select_edges_plain(img, plane, c_s)
            ok = (torch.equal(bval != 0, want_v)
                  and torch.equal(torch.where(want_v, bidx, 0), want_i)
                  and torch.equal(pts.reshape(-1, 3), want.xyz))
            equal[f"shipped vs select_plain, {name}, S={slots}"] = ok
            failed += [] if ok else [f"{name} S={slots}"]
        ref = select(libs["shipped"][0], img, plane, c)
        for label in libs:
            if label == "shipped":
                continue
            got = select(libs[label][0], img, plane, c)
            ok = all(torch.equal(a, b) for a, b in zip(got, ref))
            equal[f"{label} vs shipped, {name}"] = ok
            failed += [] if ok else [f"{label} {name}"]
    torch.cuda.synchronize()

    order = list(libs) + list(libs)[::-1]
    times = {label: [] for label in libs}
    for label in order:
        lib = libs[label][0]
        times[label].append(CS.cuda_ms(lambda: select(lib, img, sm, cfg),
                                       REPS))
    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    _, bval, stats = SEL.select_walk(sm.cpu(), reach.cpu(), img.count.cpu(),
                                     cfg)
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "reps": REPS, "turns": order,
           "ms": times,
           "ms_mean": {k: float(np.mean(v)) for k, v in times.items()},
           "edges": int(bval.sum()),
           "walk_steps_per_ring_max": max(stats["steps"]),
           "walk_steps_per_ring_mean": float(np.mean(stats["steps"])),
           "walk_entries_visited_max": max(stats["visited"]),
           "list_entries_L": SEL.walk_list_len(cfg.max_edges_per_region),
           "ptxas": {label: u for label, (_, u) in libs.items()},
           "torch_equal": equal, "failed": failed}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
