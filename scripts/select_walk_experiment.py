#!/usr/bin/env python3
"""K2, the edge selection, on the card: the shipped kernel against an
earlier one, on the same inputs, in one process.

    python3 scripts/select_walk_experiment.py [--earlier DIR]
        [--also LABEL=DIR] [--radix-bits 4,11,...] [--out FILE]

Builds ``csrc/select.cu`` of this checkout (``shipped``) and, with
``--earlier`` (and ``--also``), ``select.cu`` of other ``csrc``
directories (for example an earlier commit's, unpacked by ``git
archive``: the C entry points are the same), and with ``--radix-bits``
copies of this checkout's with another ``kRadixBits`` written in
(``radixN``), one ``nvcc`` each, together, into
``kernels/build/experiment/``.

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
backward), the walk's dependent steps a ring on the bench frame
(``select_walk``), and whether each build's shared-memory kernel is the
``--earlier`` build's instruction for instruction (``cuobjdump -sass``).

The device-memory path (``liodom_select_edges_global``, each build's
scratch sized by its own ``liodom_select_global_shape``) on 64 seeded
rings of ``chip_smoke.wide_planes`` at each of ``chip_smoke.WIDE_RINGS``
and ``SCRATCH_RINGS``, and on the bench frame: the shipped build's slots
and points must equal ``select_plain``'s (the wide shapes) or the
shared-memory kernel's (the bench frame), every other build's the shipped
one's; then each build's time there by CUDA events, in turns.  Prints one
JSON object (and writes it to ``--out``); exits 1 if any output differs.
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
WIDE_REPS = 10
_RADIX_LINE = "constexpr int kRadixBits = "


def radix_copy(bits: int, out_dir: Path) -> Path:
    """A copy of this checkout's ``select.cu`` with ``kRadixBits`` = bits,
    in its own directory; stops if the constant's line is not there
    once."""
    src = (kernels.CSRC / "select.cu").read_text()
    lines = [ln for ln in src.splitlines() if ln.startswith(_RADIX_LINE)]
    if len(lines) != 1:
        raise SystemExit("select_walk_experiment: kRadixBits not found once")
    d = out_dir / f"radix{bits}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "select.cu").write_text(src.replace(lines[0],
                                             f"{_RADIX_LINE}{bits};"))
    return d


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
        for symbol, argtypes in kernels.ABI["select"].items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        libs[label] = (lib, CS.ptxas_usage(log))
    return libs


def global_shape(lib, w: int, cfg: LiodomConfig) -> list:
    """A build's ``liodom_select_global_shape`` (4 values before the top-L
    design, 6 after; the rest left -1 where the build writes 4)."""
    out = (ctypes.c_longlong * 6)(-1, -1, -1, -1, -1, -1)
    kernels.check(lib.liodom_select_global_shape(
        w, cfg.scan_regions, cfg.max_edges_per_region,
        ctypes.addressof(out)), "liodom_select_global_shape")
    return list(out)


def select_global(lib, img: RingImage, sm: torch.Tensor, cfg: LiodomConfig,
                  scratch: torch.Tensor):
    """(bidx, bval, pts) of one build's device-memory path; ``scratch``
    holds the rings x its shape's bytes a ring."""
    r, w = sm.shape
    n, mp = cfg.scan_regions, cfg.max_edges_per_region
    bidx = torch.empty((r, n * mp), dtype=torch.int32, device=sm.device)
    bval = torch.empty_like(bidx)
    pts = torch.empty((r, n * mp, 3), dtype=torch.float32, device=sm.device)
    err = lib.liodom_select_edges_global(
        sm.data_ptr(), img.count.data_ptr(), img.xyz.data_ptr(),
        bidx.data_ptr(), bval.data_ptr(), pts.data_ptr(), scratch.data_ptr(),
        r, w, n, mp, cfg.min_points_per_scan,
        SEL.f32(cfg.smoothness_threshold), SEL.f32(cfg.neighbor_gap_sq),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "liodom_select_edges_global")
    return bidx, bval, pts


def wide_cases(img, sm, cfg, dev) -> dict:
    """{name: (ring image, plane, configuration)} of the device-memory
    path's inputs: chip_smoke's WIDE_RINGS and SCRATCH_RINGS on 64 seeded
    rings (its seeds), and the bench frame at 88 slots."""
    cases = {}
    for seed, (w, picks) in enumerate(CS.WIDE_RINGS):
        c = cfg.replace(edges_per_region=picks, ring_width=w)
        cases[f"wide_{w}x{c.scan_regions * (picks + 1)}"] = (
            *CS.wide_planes(dev, 64, w, seed), c)
    for picks, where in CS.SCRATCH_RINGS:
        c = cfg.replace(edges_per_region=picks, ring_width=49152)
        cases[f"scratch_{where}_49152x{c.scan_regions * (picks + 1)}"] = (
            *CS.wide_planes(dev, 64, 49152, len(CS.WIDE_RINGS)), c)
    cases["bench_frame"] = (img, sm, cfg)
    return cases


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
    ap.add_argument("--radix-bits", default="",
                    help="comma-separated kRadixBits of copies to build")
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
    out_dir = kernels.BUILD_DIR / "experiment"
    for bits in filter(None, args.radix_bits.split(",")):
        variants[f"radix{int(bits)}"] = radix_copy(int(bits), out_dir)
    libs = build(variants, out_dir)

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

    # the device-memory path: equal first, then timed in turns
    wide = {}
    for name, (wimg, wsm, c) in wide_cases(img, sm, cfg, dev).items():
        r, w = wsm.shape
        shapes = {label: global_shape(lib, w, c)
                  for label, (lib, _) in libs.items()}
        scratch = {label: torch.empty(r * shp[3] + 16, dtype=torch.uint8,
                                      device=dev)
                   for label, shp in shapes.items()}
        ref = select_global(libs["shipped"][0], wimg, wsm, c,
                            scratch["shipped"])
        if name == "bench_frame":
            want = select(libs["shipped"][0], wimg, wsm, c)
            ok = all(torch.equal(a, b) for a, b in zip(ref, want))
        else:
            reach = SEL._reach_plane(wimg.xyz, c.neighbor_gap_sq)
            want_i, want_v = SEL.select_plain(wsm, reach, wimg.count, c)
            want = SEL.select_edges_plain(wimg, wsm, c)
            ok = (torch.equal(ref[1] != 0, want_v)
                  and torch.equal(torch.where(want_v, ref[0], 0), want_i)
                  and torch.equal(ref[2].reshape(-1, 3), want.xyz))
        equal[f"global shipped vs plain, {name}"] = ok
        failed += [] if ok else [f"global {name}"]
        for label in libs:
            if label == "shipped":
                continue
            got = select_global(libs[label][0], wimg, wsm, c,
                                scratch[label])
            ok = all(torch.equal(a, b) for a, b in zip(got, ref))
            equal[f"global {label} vs shipped, {name}"] = ok
            failed += [] if ok else [f"global {label} {name}"]
        torch.cuda.synchronize()
        t = {label: [] for label in libs}
        for label in order:
            lib = libs[label][0]
            t[label].append(CS.cuda_ms(
                lambda: select_global(lib, wimg, wsm, c, scratch[label]),
                WIDE_REPS))
        wide[name] = {"rings": r, "width": w,
                      "slots": c.scan_regions * c.max_edges_per_region,
                      "shape": shapes, "ms": t,
                      "ms_mean": {k: float(np.mean(v)) for k, v in t.items()}}
        del scratch

    reach = SEL._reach_plane(img.xyz, cfg.neighbor_gap_sq)
    _, bval, stats = SEL.select_walk(sm.cpu(), reach.cpu(), img.count.cpu(),
                                     cfg)
    # the shared-memory kernel's machine code in each build
    sass = {label: CS.sass_of(out_dir / f"select-{label}.so",
                              "select_kernelILb1E") for label in libs}
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
           "global_path": wide,
           "sass_smem_kernel": {
               label: {"instructions": len(code), "equal_to_earlier":
                       code == sass["earlier"] if "earlier" in sass else None}
               for label, code in sass.items()},
           "ptxas": {label: u for label, (_, u) in libs.items()},
           "torch_equal": equal, "failed": failed}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
