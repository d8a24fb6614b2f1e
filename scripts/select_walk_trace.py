#!/usr/bin/env python3
"""Where the time of K2, the edge selection, goes, block by block, on the
card.

    python3 scripts/select_walk_trace.py [--out FILE]

Copies ``csrc/select.cu`` into ``kernels/build/trace/``, adds a timeline
to the copy (each block's ``%globaltimer`` at its start, when its regions
are ranked and when the cluster barrier lets it on; for cluster rank 0
also when the walk has ended and when the slots are written; read back
through an added ``liodom_select_trace`` entry point; the kernel's work
is untouched) and builds it as ``scripts/select_walk_experiment.py`` does.
The timeline is put in at five lines of code of ``select.cu``
(``_PATCHES``), each of which must appear there once, exactly as written,
and at the kernel's end: the script stops if one does not.  On the bench
drive's last frame (lane 0 of ``chip_smoke.py``, 64 x 4096 rings, 88 slots
a ring) it runs the build 5 times, then once traced, checks the slots
against the shipped kernel's; then the same for the device-memory path
(``liodom_select_edges_global``, where the rank phase is the top-L lists
and the scratch's tags, and the list of a block's last region is timed in
its phases: keys, radix select, placing, ordering (with the gap flags),
writing; six more anchors) on that frame and on ``chip_smoke.WIDE_RINGS``'s
64 seeded rings; and prints one JSON object (and writes it to ``--out``):
each run's span and, over the rings, the spread of each phase.  The
shipped kernel is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as CS  # noqa: E402
import select_walk_experiment as X  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.ops import features as F  # noqa: E402
from liodom_tpu_torch.ops import select_pallas as SEL  # noqa: E402

_SLOTS = 12    # timeline entries a block (6 on, the top-L phases)
# (a line of code in select.cu, the text put after it, or, with a leading
# "<", before it)
_PATCHES = (
    ("namespace cg = cooperative_groups;\n", """
__device__ unsigned long long g_trace[1 << 18];

__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""),
    ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
     '"memory");\n',
     "  const unsigned long long t_start = trace_now();\n"),
    ("  cluster.sync();                          // every list in rank 0\n",
     """  const unsigned long long t_synced = trace_now();
  if (tid == 0 && blockIdx.x < (1 << 15)) {
    g_trace[blockIdx.x * 12 + 0] = t_start;
    g_trace[blockIdx.x * 12 + 1] = t_ranked;
    g_trace[blockIdx.x * 12 + 2] = t_synced;
  }
"""),
    ("<  cluster.sync();                          // every list in rank 0\n",
     "  const unsigned long long t_ranked = trace_now();\n"),
    ("  __syncthreads();\n\n  for (int k = tid; k < slots; k += kThreads) {\n",
     None),
)
# the device-memory path's top-L list of a region (region_list_topl): its
# phases' durations, the block's last region's, at slots 6-10
_TOPL_PATCHES = (
    ("  const int n = min(cap, len);\n",
     "  const unsigned long long tq0 = trace_now();\n"),
    ("<  // the radix select: prefix/mask the digits found, k the rank left "
     "among\n", "  const unsigned long long tq1 = trace_now();\n"),
    ("<  // the kept entries into buf as key << 32 | column: below the prefix "
     "(and\n", "  const unsigned long long tq2 = trace_now();\n"),
    ("<  // the keys are done: where the entries' neighbourhoods cover the "
     "region\n", "  const unsigned long long tq3 = trace_now();\n"),
    ("<  // (value, column | reach << 24) at its place: a pick at b "
     "suppresses\n", "  const unsigned long long tq4 = trace_now();\n"),
    ("<  __syncthreads();                        // s_key, work, buf reused"
     "\n}\n", None),
)
_TOPL_END = """  __syncthreads();                        // s_key, work, buf reused
  if (threadIdx.x == 0 && blockIdx.x < (1 << 15)) {
    const unsigned long long tq5 = trace_now();
    unsigned long long* g = g_trace + blockIdx.x * 12 + 6;
    g[0] = tq1 - tq0;
    g[1] = tq2 - tq1;
    g[2] = tq3 - tq2;
    g[3] = tq4 - tq3;
    g[4] = tq5 - tq4;
  }
}
"""
_WALKED = """  if (tid == 0 && blockIdx.x < (1 << 15))
    g_trace[blockIdx.x * 12 + 3] = trace_now();
"""
# the kernel's end: its last slot write
_TAIL = """    pts[slot * 3 + 2] = pick ? p[3 * c + 2] : 0.0f;
  }
}
"""
_END = """    pts[slot * 3 + 2] = pick ? p[3 * c + 2] : 0.0f;
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < (1 << 15))
    g_trace[blockIdx.x * 12 + 4] = trace_now();
}
"""
_READ = """
extern "C" int liodom_select_trace(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_trace, sizeof(unsigned long long) * n));
}
"""


def traced_source(out: Path) -> Path:
    """The traced copy of ``select.cu`` in ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / "select.cu").read_text()
    for anchor, text in _PATCHES:
        before = anchor.startswith("<")
        anchor = anchor.lstrip("<")
        if src.count(anchor) != 1:
            raise SystemExit(f"select_walk_trace: anchor not found once: "
                             f"{anchor!r}")
        if text is None:                 # the walk's closing barrier
            src = src.replace(anchor, anchor.replace(
                "  __syncthreads();\n", "  __syncthreads();\n" + _WALKED, 1))
        else:
            src = src.replace(anchor, text + anchor if before
                              else anchor + text)
    for anchor, text in _TOPL_PATCHES:
        before = anchor.startswith("<")
        anchor = anchor.lstrip("<")
        if src.count(anchor) != 1:
            raise SystemExit(f"select_walk_trace: anchor not found once: "
                             f"{anchor!r}")
        if text is None:                 # the list's end
            src = src.replace(anchor, _TOPL_END)
        else:
            src = src.replace(anchor, text + anchor if before
                              else anchor + text)
    if src.count(_TAIL) != 1:
        raise SystemExit("select_walk_trace: the kernel's end not found once")
    src = src.replace(_TAIL, _END) + _READ
    (out / "select.cu").write_text(src)
    return out


def pct(x) -> list:
    return np.percentile(x, [0, 50, 90, 100]).tolist()


def timeline(lib, shipped, img, sm, cfg, call, blocks) -> dict:
    """``call(lib, img, sm, cfg)`` of the traced build 5 times, then once
    traced, its slots against the shipped build's; the timeline's span and
    each phase's spread over the rings (``blocks`` a ring's cluster, rank 0
    the walker)."""
    for _ in range(5):
        call(lib, img, sm, cfg)
    torch.cuda.synchronize()
    got = call(lib, img, sm, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in
               zip(got, call(shipped, img, sm, cfg)))
    rings = img.xyz.shape[0]
    n = rings * blocks
    buf = np.zeros(n * _SLOTS, dtype=np.uint64)
    kernels.check(lib.liodom_select_trace(buf.ctypes.data, n * _SLOTS),
                  "liodom_select_trace")
    t = buf.reshape(rings, blocks, _SLOTS).astype(np.int64)
    t0 = t[:, :, 0].min()
    us = (t[:, :, :5] - t0) / 1e3
    root = us[:, 0]
    topl = t[:, :, 6:11] / 1e3             # durations, us
    topl = topl[topl.sum(-1) > 0]          # the blocks that built a list
    if not len(topl):
        topl = np.zeros((1, 5))
    return {"slots_equal": same, "rings": rings, "cluster_blocks": blocks,
            "span_us": float(root[:, 4].max()),
            "topl_us_percentiles_0_50_90_100": {
                name: pct(topl[:, j]) for j, name in enumerate(
                    ("keys", "radix_select", "placed", "ordered",
                     "written"))},
            "us_percentiles_0_50_90_100": {
                "block_start": pct(us[:, :, 0]),
                "rank_phase_per_block": pct(us[:, :, 1] - us[:, :, 0]),
                "cluster_barrier_wait_rank0": pct(root[:, 2] - root[:, 1]),
                "ring_lists_ready": pct(us[:, :, 1].max(axis=1)),
                "walk_rank0": pct(root[:, 3] - root[:, 2]),
                "slots_written_rank0": pct(root[:, 4] - root[:, 3]),
                "ring_end": pct(root[:, 4])}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("select_walk_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = kernels.BUILD_DIR / "trace"
    libs = X.build({"traced": traced_source(out / "select"),
                    "shipped": kernels.CSRC}, out)
    lib = libs["traced"][0]
    lib.liodom_select_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cfg = LiodomConfig(local_map_size=5)
    img = CS.render_lanes(cfg, dev, [0], noise=0.01)[0][0][-1]
    sm = F.smoothness(img, cfg)
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0),
           **timeline(lib, libs["shipped"][0], img, sm, cfg, X.select,
                      SEL.select_shape(img.xyz.shape[1], cfg.scan_regions,
                                       cfg.max_edges_per_region)[
                                           "cluster_blocks"])}
    # the device-memory path: the bench frame, then WIDE_RINGS on 64
    # seeded rings (chip_smoke's seeds)
    cases = {"bench_frame": (img, sm, cfg)}
    for seed, (w, picks) in enumerate(CS.WIDE_RINGS):
        c = cfg.replace(edges_per_region=picks, ring_width=w)
        cases[f"wide_{w}x{c.scan_regions * (picks + 1)}"] = (
            *CS.wide_planes(dev, 64, w, seed), c)
    res["global_path"] = {}
    for name, (wimg, wsm, c) in cases.items():
        r, w = wsm.shape
        shape = X.global_shape(lib, w, c)
        scratch = torch.empty(r * shape[3] + 16, dtype=torch.uint8,
                              device=dev)
        res["global_path"][name] = {"shape": shape, **timeline(
            lib, libs["shipped"][0], wimg, wsm, c,
            lambda lb, i, s_, c_: X.select_global(lb, i, s_, c_, scratch),
            shape[5])}
    same = res["slots_equal"] and all(
        v["slots_equal"] for v in res["global_path"].values())
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
