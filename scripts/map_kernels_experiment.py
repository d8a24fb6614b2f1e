#!/usr/bin/env python3
"""The mapping kernels on the card, the probe (``csrc/probe_insert.cu``)
and K7 (``csrc/local_map_compact.cu``): the shipped kernels against
earlier builds, on the same inputs, in one process.

    python3 scripts/map_kernels_experiment.py [--earlier DIR]
        [--also LABEL=DIR] [--fence-bytes 8192,...] [--out FILE]

Builds both sources of this checkout (``shipped``) and, with ``--earlier``
(and ``--also``), of other ``csrc`` directories (for example an earlier
commit's, unpacked by ``git archive``) and, with ``--fence-bytes``, of
copies of this checkout's with another ``kFenceBytes`` written into
``local_map_compact.cu`` (``fenceN``), one ``nvcc`` each, all together,
into ``kernels/build/experiment/``, with a pointer chase that measures one
dependent L2 trip.  A build whose library exports
``liodom_local_map_compact_shape`` / ``liodom_probe_insert_shape`` is
called as the shipped wrappers call it; one without is called through the
earlier entry points (K7 with its ``hit`` and ``block_count`` scratch and
host offsets, at most 128 targets; the probe with its ``flags`` scratch
and no round count).

Inputs: the bench drive of ``chip_smoke.py`` (lane 0, 1 cm noise, 36
frames of ``combined_image_step``, the local map refreshed every frame):
K7 on the map after the last frame at the last pose, the probe on the
table the last frame met with that frame's codes, each with the cases of
``chip_smoke.map_kernel_cases``.  Every output of the shipped kernels must
be ``torch.equal`` to the plain versions (the probe's rounds too), and
every other build's to the shipped one's where it takes the case.  Then
the time of each build's call (the probe's includes its 4 MB table copy,
timed alone beside it) by CUDA events over 100 launches on the bench
inputs, the builds in turns (forward, then backward), and the chase:
cycles and ns a dependent ``ld.global.cg`` over a 4 MB ring of 128-byte
lines in a random order, L2-resident after a warm pass; and whether each
build's K7 shared-memory kernel is the ``--earlier`` build's instruction
for instruction (``cuobjdump -sass``).

K7's device-memory path (``liodom_local_map_compact_global``) on the same
map: at ``cells_xy`` = ``chip_smoke.CELLS_XY_WIDE`` (19,883 targets) at
capacities 16,384 and 1,024, at 75 and 174 targets and either side of the
first fence-stride change (the targets nearest the base).  A build that
exports ``liodom_local_map_fence`` is given the fence ahead of the sorted
offsets at its own stride (``liodom_local_map_fence``), one without the
sorted offsets alone as (3, K).  The shipped
build must equal the plain version, every other build the shipped one;
then each build's time at 19,883, 174 and 75 targets, in turns.  Prints
one JSON object (and writes it to ``--out``); exits 1 if any output
differs.
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
from liodom_tpu_torch.core import pose as se3  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.mapping import grid as G  # noqa: E402
from liodom_tpu_torch.mapping import service as S  # noqa: E402
from liodom_tpu_torch.ops import compact_pallas as K7  # noqa: E402
from liodom_tpu_torch.ops import features as F  # noqa: E402
from liodom_tpu_torch.ops import probe_insert as PI  # noqa: E402

REPS = 100
CHASE_LINES = 32768            # 4 MB of 128-byte lines
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const unsigned* next, int steps, unsigned* sink,
                      long long* cycles) {
  unsigned i = 0;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  const long long t1 = clock64();
  *sink = i;
  *cycles = t1 - t0;
}
extern "C" int liodom_chase(const void* next, int steps, void* sink,
                            void* cycles, void* stream) {
  chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(next), steps,
      static_cast<unsigned*>(sink), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
"""
_OLD_K7 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
_OLD_PROBE = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
              + [ctypes.c_void_p] * 5)


_FENCE_LINE = "constexpr long long kFenceBytes = "


def fence_copy(n_bytes: int, out_dir: Path) -> Path:
    """A copy of this checkout's two mapping sources with ``kFenceBytes`` =
    n_bytes, in its own directory; stops if the constant's line is not
    there once."""
    src = (kernels.CSRC / "local_map_compact.cu").read_text()
    lines = [ln for ln in src.splitlines() if ln.startswith(_FENCE_LINE)]
    if len(lines) != 1:
        raise SystemExit("map_kernels_experiment: kFenceBytes not found once")
    d = out_dir / f"fence{n_bytes}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "local_map_compact.cu").write_text(
        src.replace(lines[0], f"{_FENCE_LINE}{n_bytes};"))
    (d / "probe_insert.cu").write_text(
        (kernels.CSRC / "probe_insert.cu").read_text())
    return d


def build(variants: dict, out_dir: Path):
    """({label: {"k7": CDLL, "probe": CDLL, "new_k7": bool, "new_probe":
    bool, "ptxas": {...}}}, chase CDLL)."""
    nvcc = kernels.nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    chase_cu = out_dir / "chase.cu"
    chase_cu.write_text(CHASE_SRC)
    jobs = {}
    for label, csrc in variants.items():
        for kind, src in (("k7", "local_map_compact"),
                          ("probe", "probe_insert")):
            so = out_dir / f"{src}-{label}.so"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", str(so),
                   str(Path(csrc) / f"{src}.cu")]
            jobs[(label, kind)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    chase_so = out_dir / "chase.so"
    jobs[("chase", "chase")] = (subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-o", str(chase_so), str(chase_cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        chase_so)
    libs = {label: {"ptxas": {}} for label in variants}
    chase = None
    for (label, kind), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label} {kind}: nvcc exit {proc.returncode}"
                             f"\n{log}")
        lib = ctypes.CDLL(str(so))
        if kind == "chase":
            lib.liodom_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
            lib.liodom_chase.restype = ctypes.c_int
            chase = lib
            continue
        if kind == "k7":
            new = hasattr(lib, "liodom_local_map_compact_shape")
            sigs = (list(kernels.ABI["local_map_compact"].items()) if new
                    else [("liodom_local_map_compact", _OLD_K7)])
            libs[label]["k7_global"] = (
                "fenced" if hasattr(lib, "liodom_local_map_fence") else
                "soa" if hasattr(lib, "liodom_local_map_compact_global")
                else None)
            sigs = [(sym, a) for sym, a in sigs if hasattr(lib, sym)]
        else:
            new = hasattr(lib, "liodom_probe_insert_shape")
            sigs = (list(kernels.ABI["probe_insert"].items()) if new
                    else [("liodom_probe_insert", _OLD_PROBE)])
        for symbol, argtypes in sigs:
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        libs[label][kind] = lib
        libs[label][f"new_{kind}"] = new
        libs[label]["ptxas"][kind] = CS.ptxas_usage(log)
    return libs, chase


def k7_call(build_: dict, xyz, key, valid, base, offs, cap):
    """K7 of one build, allocated as its wrapper allocates; None where an
    earlier build does not take the case (more than 128 targets)."""
    dev = xyz.device
    c, n_t = xyz.shape[0], len(offs)
    out = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    out_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build_["k7"]
    if build_["new_k7"]:
        d_offs = K7._device_offsets(
            np.ascontiguousarray(offs, np.int32).tobytes(), dev)
        state = K7._lookback_state(dev, max(1, -(-c // K7.TILE_ROWS)))
        err = lib.liodom_local_map_compact(
            xyz.data_ptr(), key.data_ptr(), valid.data_ptr(),
            base.data_ptr(), d_offs.data_ptr(), n_t, c, cap,
            state.data_ptr(), out.data_ptr(), out_valid.data_ptr(),
            n_hits.data_ptr(), stream)
    else:
        if n_t > 128:
            return None
        host = np.ascontiguousarray(offs, np.int32)
        hit = torch.empty(c, dtype=torch.uint8, device=dev)
        block_count = torch.empty(max(1, -(-c // 4096)), dtype=torch.int32,
                                  device=dev)
        err = lib.liodom_local_map_compact(
            xyz.data_ptr(), key.data_ptr(), valid.data_ptr(),
            base.data_ptr(), host.ctypes.data, n_t, c, cap, hit.data_ptr(),
            block_count.data_ptr(), out.data_ptr(), out_valid.data_ptr(),
            n_hits.data_ptr(), stream)
    kernels.check(err, "liodom_local_map_compact")
    return out, out_valid, n_hits


def k7_global_call(build_: dict, xyz, key, valid, base, offs, cap):
    """K7's device-memory path of one build, its targets laid out as that
    build takes them; None where the build has no such path."""
    kind = build_.get("k7_global")
    if kind is None:
        return None
    dev = xyz.device
    c, n_t = xyz.shape[0], len(offs)
    data = np.ascontiguousarray(offs, np.int32).tobytes()
    if kind == "fenced":
        fence = (ctypes.c_int * 3)()
        build_["k7"].liodom_local_map_fence(n_t, fence)
        d_offs = K7._device_fenced_offsets(data, fence[0], dev)
    else:
        d_offs = K7._device_offsets(data, dev).t().contiguous()
    out = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    out_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    state = K7._lookback_state(dev, max(1, -(-c // K7.TILE_ROWS)))
    err = build_["k7"].liodom_local_map_compact_global(
        xyz.data_ptr(), key.data_ptr(), valid.data_ptr(), base.data_ptr(),
        d_offs.data_ptr(), n_t, c, cap, state.data_ptr(), out.data_ptr(),
        out_valid.data_ptr(), n_hits.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "liodom_local_map_compact_global")
    return out, out_valid, n_hits


def global_cases(kmap, kbase) -> dict:
    """{name: K7 arguments} of the device-memory path on the bench map."""
    m = (kmap.xyz, kmap.key, kmap.valid, kbase)
    cap = CS.MCFG.local_map_capacity
    wide = G.local_map_offsets(CS.MCFG, cells_xy=CS.CELLS_XY_WIDE)
    near = wide[np.argsort(np.abs(wide).sum(1), kind="stable")]
    edge = K7.FENCE_BYTES // 12
    return {f"targets{len(wide)}": (*m, wide, cap),
            f"targets{len(wide)}_cap1024": (*m, wide, 1024),
            "targets174": (*m, G.local_map_offsets(CS.MCFG, cells_xy=6,
                                                   cells_z=3), cap),
            "targets75": (*m, G.local_map_offsets(CS.MCFG, cells_xy=3,
                                                  cells_z=16), cap),
            f"targets{edge}": (*m, near[:edge], cap),
            f"targets{edge + 1}": (*m, near[:edge + 1], cap)}


def probe_call(build_: dict, tab, code, active):
    """The probe of one build on a copy of ``tab``, as its wrapper calls it:
    (table, slot, claimed, failed[, rounds])."""
    dev = tab.device
    n, e = tab.shape[0], code.shape[0]
    out = tab.clone()
    slot = torch.empty(e, dtype=torch.int32, device=dev)
    claimed = torch.empty(e, dtype=torch.bool, device=dev)
    failed = torch.empty(e, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build_["probe"]
    if build_["new_probe"]:
        spill = torch.empty(e, dtype=torch.uint8, device=dev)
        rounds = torch.empty((), dtype=torch.int32, device=dev)
        err = lib.liodom_probe_insert(
            out.data_ptr(), n, code.data_ptr(), active.data_ptr(), e,
            PI.MAX_PROBES, slot.data_ptr(), spill.data_ptr(),
            claimed.data_ptr(), failed.data_ptr(), rounds.data_ptr(), stream)
        res = (out, slot, claimed, failed, rounds)
    else:
        flags = torch.empty(e, dtype=torch.uint8, device=dev)
        err = lib.liodom_probe_insert(
            out.data_ptr(), n, code.data_ptr(), active.data_ptr(), e,
            PI.MAX_PROBES, slot.data_ptr(), flags.data_ptr(),
            claimed.data_ptr(), failed.data_ptr(), stream)
        res = (out, slot, claimed, failed)
    kernels.check(err, "liodom_probe_insert")
    return res


def chase_l2(lib, dev) -> dict:
    """Cycles and ns a dependent L2 trip: a ring over CHASE_LINES 128-byte
    lines in a random order (seed 0), one pass to warm, one timed."""
    perm = np.random.default_rng(0).permutation(CHASE_LINES)
    nxt = np.zeros(CHASE_LINES * 32, np.uint32)
    nxt[perm * 32] = np.roll(perm, -1) * 32
    nxt_d = torch.from_numpy(nxt.view(np.int32)).to(dev)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):      # the warm pass, then the timed one
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.check(lib.liodom_chase(nxt_d.data_ptr(), CHASE_LINES,
                                       sink.data_ptr(), cycles.data_ptr(),
                                       stream), "liodom_chase")
        stop.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    return {"lines": CHASE_LINES, "bytes": CHASE_LINES * 128,
            "cycles_per_trip": int(cycles.item()) / CHASE_LINES,
            "ns_per_trip": ms * 1e6 / CHASE_LINES}


def bench_inputs(dev):
    """(kmap, kbase, pmap, pcode, pvalid, pxyz) of chip_smoke.py's kernels
    phase: the bench drive's map after the last frame and the pose it
    ended at, the map the last frame met and that frame's codes."""
    cfg = LiodomConfig(local_map_size=5)
    ccfg = cfg.replace(mapping=True)
    imgs = CS.render_lanes(cfg, dev, [0], noise=0.01)[0][0]
    states, poses, _ = CS.run_combined(*S.init_combined(ccfg, CS.MCFG), imgs,
                                       ccfg)
    img = imgs[-1]
    ec = F.select_edges(img, F.smoothness(img, cfg), cfg)
    kmap = states[-1][1]
    kbase = G.cell_keys(torch.trunc(poses[-1].t), CS.MCFG)
    pxyz = se3.transform(poses[-1], ec.xyz)
    pcode = G._packed_codes(pxyz, ec.valid, CS.MCFG)
    return kmap, kbase, states[-2][1], pcode, ec.valid, pxyz


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path,
                    help="another csrc directory to build and compare")
    ap.add_argument("--also", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="more csrc directories to build, compare and time")
    ap.add_argument("--fence-bytes", default="",
                    help="comma-separated kFenceBytes of copies to build")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("map_kernels_experiment: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    variants = {"shipped": kernels.CSRC}
    if args.earlier is not None:
        variants["earlier"] = args.earlier
    for spec in args.also:
        label, _, path = spec.partition("=")
        variants[label] = Path(path)
    out_dir = kernels.BUILD_DIR / "experiment"
    for n_bytes in filter(None, args.fence_bytes.split(",")):
        variants[f"fence{int(n_bytes)}"] = fence_copy(int(n_bytes), out_dir)
    libs, chase = build(variants, out_dir)

    kmap, kbase, pmap, pcode, pvalid, pxyz = bench_inputs(dev)
    k7_cases, probe_cases = CS.map_kernel_cases(kmap, kbase, pmap, pcode,
                                                pvalid, pxyz)
    equal, failed, rounds, hits = {}, [], {}, {}

    def record(key: str, ok: bool) -> None:
        equal[key] = ok
        if not ok:
            failed.append(key)

    for name, a in k7_cases.items():
        ref = k7_call(libs["shipped"], *a)
        want = K7.compact_hits_plain(*a)
        hits[name] = int(ref[2])
        record(f"k7 shipped vs plain, {name}",
               all(torch.equal(x, y) for x, y in zip(ref, want)))
        for label in libs:
            if label == "shipped":
                continue
            got = k7_call(libs[label], *a)
            if got is None:
                equal[f"k7 {label} vs shipped, {name}"] = "not taken"
                continue
            record(f"k7 {label} vs shipped, {name}",
                   all(torch.equal(x, y) for x, y in zip(got, ref)))
    g_cases = global_cases(kmap, kbase)
    for name, a in g_cases.items():
        ref = k7_global_call(libs["shipped"], *a)
        want = K7.compact_hits_plain(*a)
        hits[f"global_{name}"] = int(ref[2])
        record(f"k7 global shipped vs plain, {name}",
               all(torch.equal(x, y) for x, y in zip(ref, want)))
        for label in libs:
            if label == "shipped":
                continue
            got = k7_global_call(libs[label], *a)
            if got is None:
                equal[f"k7 global {label} vs shipped, {name}"] = "not taken"
                continue
            record(f"k7 global {label} vs shipped, {name}",
                   all(torch.equal(x, y) for x, y in zip(got, ref)))
    for name, a in probe_cases.items():
        ref = probe_call(libs["shipped"], *a)
        want = PI.probe_insert_plain(*a, with_rounds=True)
        rounds[name] = {"kernel": int(ref[4]), "plain": int(want[4])}
        record(f"probe shipped vs plain, {name}",
               all(torch.equal(x, y) for x, y in zip(ref, want)))
        for label in libs:
            if label == "shipped":
                continue
            got = probe_call(libs[label], *a)
            record(f"probe {label} vs shipped, {name}",
                   all(torch.equal(x, y) for x, y in zip(got[:4], ref[:4])))
    torch.cuda.synchronize()

    order = list(libs) + list(libs)[::-1]
    k7_args, probe_args = k7_cases["bench"], probe_cases["bench"]
    times = {"k7": {label: [] for label in libs},
             "probe": {label: [] for label in libs}, "table_copy": []}
    for label in order:
        b = libs[label]
        times["k7"][label].append(CS.cuda_ms(lambda: k7_call(b, *k7_args),
                                             REPS))
        times["probe"][label].append(CS.cuda_ms(
            lambda: probe_call(b, *probe_args), REPS))
        times["table_copy"].append(CS.cuda_ms(lambda: pmap.code.clone(),
                                              REPS))
    timed = [n for n in g_cases if n in ("targets19883", "targets174",
                                         "targets75")]
    g_times = {n: {label: [] for label in libs
                   if libs[label].get("k7_global")} for n in timed}
    for n in timed:
        for label in order:
            b = libs[label]
            if b.get("k7_global"):
                g_times[n][label].append(CS.cuda_ms(
                    lambda: k7_global_call(b, *g_cases[n]), REPS))
    # K7's shared-memory kernel's machine code in each build
    sass = {label: CS.sass_of(out_dir / f"local_map_compact-{label}.so",
                              "compact_kernelILb1E") for label in libs}
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "reps": REPS, "turns": order,
           "ms": times,
           "ms_mean": {k: {lb: float(np.mean(v)) for lb, v in t.items()}
                       for k, t in times.items() if isinstance(t, dict)},
           "table_copy_ms_mean": float(np.mean(times["table_copy"])),
           "l2_chase": chase_l2(chase, dev),
           "sass_smem_kernel": {
               label: {"instructions": len(code), "equal_to_earlier":
                       code == sass["earlier"] if "earlier" in sass else None}
               for label, code in sass.items()},
           "k7_global_ms": g_times,
           "k7_global_ms_mean": {n: {lb: float(np.mean(v))
                                     for lb, v in t.items()}
                                 for n, t in g_times.items()},
           "k7_shape": K7.compact_shape(kmap.xyz.shape[0],
                                        len(k7_args[4])),
           "k7_global_shape": {n: K7.compact_shape(kmap.xyz.shape[0],
                                                   len(a[4]))
                               for n, a in g_cases.items()},
           "probe_shape": PI.probe_shape(),
           "occupied": int(kmap.valid.sum()), "n_hits": hits,
           "rounds": rounds,
           "ptxas": {label: b["ptxas"] for label, b in libs.items()},
           "torch_equal": equal, "failed": failed}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
