#!/usr/bin/env python3
"""Where the time of the mapping kernels goes on the card: the probe
(``csrc/probe_insert.cu``) and K7 (``csrc/local_map_compact.cu``).

    python3 scripts/map_kernels_trace.py [--out FILE]

Copies both sources into ``kernels/build/trace/`` and adds a timeline to
each copy (``%globaltimer`` read by thread 0 of each block; read back
through an added ``liodom_trace_read`` entry point; the kernels' work is
untouched; each copy adds block barriers to stamp its last phases):

* K7, a block (a tile): its start, every thread's mask in hand (a
  barrier), the targets loaded (the first barrier), the tile counted
  (block scan done), its offset found (the look-back), its hits placed,
  the last tile's tail written;
* the probe, cluster rank 0: its start, the start of each round, the end
  of each round's phase 1 (the claim barrier), for the first 16 rounds,
  and the end.

The timeline is put in at lines of code of the sources (``_PATCHES``),
each of which must appear there once, exactly as written: the script stops
if one does not.  On the bench inputs of ``scripts/map_kernels_experiment.py``
it checks each traced build's output against the shipped one's, runs it 5
times, then once traced, and times it by CUDA events over 100 launches.
Beside them it times empty kernels (one block of 1,024 threads with 0 or
64 KB of dynamic shared memory; one cluster of 16 or 8 such blocks), with
and without a ``cudaFuncSetAttribute`` before each launch: the floor a
launch puts under a kernel; and the cost of one block barrier and one
cluster barrier (200 in a launch, less an empty launch).  Prints one JSON
object (and writes it to ``--out``).  The shipped kernels are not changed.
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
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as CS  # noqa: E402
import map_kernels_experiment as X  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.ops import compact_pallas as K7  # noqa: E402
from liodom_tpu_torch.ops import probe_insert as PI  # noqa: E402

_SLOTS = 64          # timeline entries a block
_TRACE = r"""
__device__ unsigned long long g_trace[256 * 64];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(i) \
  if (threadIdx.x == 0) g_trace[blockIdx.x * 64 + (i)] = trace_now();
"""
_READ = r"""
extern "C" int liodom_trace_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
"""
# (source, [(a line of code, the text put after it, or, with a leading
# "<", before it)])
_PATCHES = {
    "local_map_compact": [
        ("#include <cuda_runtime.h>\n", _TRACE),
        ("  unsigned long long* words = state + 1;\n", "  TRACE(0)\n"),
        ("  unsigned todo = load_mask(valid, row0, rows);   // bit j: row "
         "row0 + j\n", "  __syncthreads();\n  TRACE(6)\n"),
        ("<  unsigned hits = 0;\n", "  TRACE(1)\n"),
        ("<    int w = lane < kWarps ? s_warp[lane] : 0;\n", "    TRACE(2)\n"),
        ("<  // 4. place the hits in row order, kBatch rows' coordinates in "
         "flight\n", "  TRACE(3)\n"),
        ("<  // 5. the last tile: rows past the hit count, and the count\n",
         "  __syncthreads();\n  TRACE(4)\n"),
        ("    if (tid == 0) *n_hits = total;\n  }\n",
         "  __syncthreads();\n  TRACE(5)\n")],
    "probe_insert": [
        ("#include <cuda_runtime.h>\n", _TRACE),
        ("  const int spill_step = n_blocks * kThreads;\n", "  TRACE(0)\n"),
        ("  for (; r < max_probes; ++r) {\n",
         "    if (r < 16) { TRACE(1 + 2 * r) }\n"),
        ("    cluster.sync();   // every claim of round r has landed\n",
         "    if (r < 16) { TRACE(2 + 2 * r) }\n"),
        ("<  if (rank == 0 && tid == 0) *rounds = r;\n",
         "  __syncthreads();\n  TRACE(40)\n"
         "  if (threadIdx.x == 0) g_trace[blockIdx.x * 64 + 41] = r;\n")],
}
_EMPTY = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
// n block barriers, or n cluster barriers in a cluster launch
__global__ void barrier_kernel(int n, int use_cluster) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  for (int i = 0; i < n; ++i) {
    if (use_cluster)
      cluster.sync();
    else
      __syncthreads();
  }
}
extern "C" int liodom_barriers(int cluster, int threads, int n,
                               void* stream) {
  cudaFuncSetAttribute(barrier_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, barrier_kernel, n, cluster > 1 ? 1 : 0);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
// one launch of an empty kernel: `cluster` blocks in one cluster (1: a
// plain launch of one block), `threads` a block, `smem` bytes of dynamic
// shared memory, with cudaFuncSetAttribute before it when `set_attr`
extern "C" int liodom_empty(int cluster, int threads, int smem,
                            int set_attr, void* stream) {
  static int ready = -1;
  if (ready != smem || set_attr) {
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaGetLastError();    // an attribute refused shows in the launch
    ready = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""


def traced_source(name: str, out: Path) -> Path:
    src = (kernels.CSRC / f"{name}.cu").read_text()
    for anchor, text in _PATCHES[name]:
        before = anchor.startswith("<")
        line = anchor[1:] if before else anchor
        if src.count(line) != 1:
            raise SystemExit(f"{name}.cu: the anchor {line!r} is not there "
                             f"once; the timeline needs updating")
        src = src.replace(line, text + line if before else line + text)
    path = out / f"{name}-trace.cu"
    path.write_text(src + _READ)
    return path


def build(out: Path) -> dict:
    nvcc = kernels.nvcc_path()
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(_EMPTY)
    srcs = {"local_map_compact": traced_source("local_map_compact", out),
            "probe_insert": traced_source("probe_insert", out),
            "empty": out / "empty.cu"}
    jobs = {name: (subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-o", str(out / f"{name}-trace.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), out / f"{name}-trace.so") for name, path in srcs.items()}
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} trace build: nvcc exit "
                             f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        if name == "empty":
            lib.liodom_empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.liodom_empty.restype = ctypes.c_int
            lib.liodom_barriers.argtypes = ([ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
            lib.liodom_barriers.restype = ctypes.c_int
        else:
            for symbol, argtypes in kernels.ABI[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.liodom_trace_read.argtypes = [ctypes.c_void_p]
            lib.liodom_trace_read.restype = ctypes.c_int
        libs[name] = lib
    return libs


def read_trace(lib) -> np.ndarray:
    buf = np.zeros(256 * _SLOTS, np.uint64)
    torch.cuda.synchronize()
    kernels.check(lib.liodom_trace_read(buf.ctypes.data), "trace read")
    return buf.reshape(256, _SLOTS).astype(np.int64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("map_kernels_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build(kernels.BUILD_DIR / "trace")
    kmap, kbase, pmap, pcode, pvalid, pxyz = X.bench_inputs(dev)
    k7_cases, probe_cases = CS.map_kernel_cases(kmap, kbase, pmap, pcode,
                                                pvalid, pxyz)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0)}

    # K7 on the bench map: phases of each block, ns from the first start
    k7 = {"k7": libs["local_map_compact"], "new_k7": True}
    k7_args = k7_cases["bench"]
    same = all(torch.equal(a, b) for a, b in zip(
        X.k7_call(k7, *k7_args), K7.compact_hits_cuda(*k7_args)))
    for _ in range(5):
        X.k7_call(k7, *k7_args)
    X.k7_call(k7, *k7_args)
    t = read_trace(libs["local_map_compact"])
    n_b = K7.compact_shape(k7_args[0].shape[0], len(k7_args[4]))["tiles"]
    t = t[:n_b, :7] - t[:n_b, 0].min()
    names = ["start", "loaded", "counted", "looked_back", "placed",
             "written", "masked"]
    res["k7"] = {"equal_to_shipped": same, "blocks": n_b,
                 "span_ns": int(t[:, 5].max()),
                 "ns_median": {nm: float(np.median(t[:, i]))
                               for i, nm in enumerate(names)},
                 "ns_max": {nm: int(t[:, i].max())
                            for i, nm in enumerate(names)},
                 "event_ms": CS.cuda_ms(lambda: X.k7_call(k7, *k7_args),
                                        100)}
    print(json.dumps({"k7": res["k7"]}), flush=True)

    # the probe on the bench frame: the start of each round and the end of
    # its phase 1, ns from the kernel's start
    pb = {"probe": libs["probe_insert"], "new_probe": True}
    p_args = probe_cases["bench"]
    same = all(torch.equal(a, b) for a, b in zip(
        X.probe_call(pb, *p_args),
        PI.probe_insert_cuda(*p_args, with_rounds=True)))
    for _ in range(5):
        X.probe_call(pb, *p_args)
    X.probe_call(pb, *p_args)
    t = read_trace(libs["probe_insert"])[0]
    rounds = int(t[41])
    t0 = t[0]
    res["probe"] = {
        "equal_to_shipped": same, "rounds": rounds,
        "span_ns": int(t[40] - t0),
        "prologue_ns": int(t[1] - t0),
        "round_ns": [int(t[3 + 2 * r] - t[1 + 2 * r]) if r + 1 < rounds
                     else int(t[40] - t[1 + 2 * r])
                     for r in range(min(rounds, 15))],
        "phase1_ns": [int(t[2 + 2 * r] - t[1 + 2 * r])
                      for r in range(min(rounds, 16))],
        "event_ms_with_copy": CS.cuda_ms(lambda: X.probe_call(pb, *p_args),
                                         100),
        "table_copy_ms": CS.cuda_ms(lambda: pmap.code.clone(), 100)}
    print(json.dumps({"probe": res["probe"]}), flush=True)

    # the launch floor: empty kernels launched as the two kernels are
    empty = libs["empty"].liodom_empty
    floor = {}
    for label, (cl, smem) in {"one_block_64KB": (1, 65536),
                              "one_block_0KB": (1, 0),
                              "cluster16": (16, 580),
                              "cluster8": (8, 580)}.items():
        for set_attr in (0, 1):
            key = f"{label}_set_attr{set_attr}"
            try:
                floor[key] = CS.cuda_ms(
                    lambda: kernels.check(empty(cl, 1024, smem, set_attr,
                                                stream), "empty"), 100)
            except RuntimeError as err:
                floor[key] = str(err)
    res["empty_kernel_ms"] = floor

    # a barrier's cost: 200 of them in one launch, less the launch
    bars = libs["empty"].liodom_barriers
    per = {}
    for label, (cl, thr) in {"block_1024": (1, 1024),
                             "cluster8_1024": (8, 1024),
                             "cluster16_1024": (16, 1024),
                             "cluster8_256": (8, 256)}.items():
        ms = [CS.cuda_ms(lambda: kernels.check(bars(cl, thr, n, stream),
                                               "barriers"), 50)
              for n in (0, 200)]
        per[label] = (ms[1] - ms[0]) / 200 * 1e6
    res["barrier_ns"] = per
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
