#!/usr/bin/env python3
"""Where the time of the kNN walk (K3 and K4) goes, block by block, on the
card.

    python3 scripts/knn_walk_trace.py [--splits 8x2,8x4,...] [--out FILE]

Copies ``csrc/knn_search.cuh`` and ``csrc/knn_coords.cu`` into
``kernels/build/trace/``, adds a timeline to the copy (each block's
``%globaltimer`` when its search starts, when its walk has ended and when
its cluster's merge has ended, its ``%smid`` and its ref tiles, read
back through an added ``liodom_knn_trace`` entry point; the search itself
is untouched) and builds it for each split ``SxG`` as
``scripts/knn_walk_experiment.py`` does.  The timeline is put in at four
lines of code of ``search`` in ``knn_search.cuh`` (``_PATCHES``), each of
which must appear once in the register walk's part of the header (before
``ListWalk``), exactly as written: the script stops if one does not.  On the bench drive's last frame
(K3 on lane 0, K4 on lanes 0-3 at B = 4, as ``chip_smoke.py``'s kernels
phase builds them) it runs each build 5 times, then once traced, and
prints one JSON object (and writes it to ``--out``): per launch the span,
the spread of block start times, block durations, the mean walk time by
number of ref tiles, blocks a SM, the most blocks alive at once, and
the busiest query tile's blocks.  The shipped kernels are not changed.
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
import knn_walk_experiment as X  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402

# (a line of code in knn_search.cuh, the text put after it, or, for the
# last, before it)
_PATCHES = (
    ("namespace cg = cooperative_groups;\n", """
__device__ unsigned long long g_trace[1 << 18];

__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("    extern __shared__ __align__(16) float4 smem[];\n",
     "    const unsigned long long t_start = trace_now();\n"),
    ('    asm volatile("cp.async.wait_all;\\n" ::: "memory");\n',
     "    const unsigned long long t_walked = trace_now();\n"),
    ("    return owner;\n", """    if (threadIdx.x == 0) {
      const size_t blk =
          static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
      unsigned sm;
      asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
      if (blk < (1 << 16)) {
        g_trace[blk * 4 + 0] = t_start;
        g_trace[blk * 4 + 1] = t_walked;
        g_trace[blk * 4 + 2] = trace_now();
        g_trace[blk * 4 + 3] =
            sm | (static_cast<unsigned long long>(tiles) << 16);
      }
    }
"""),
)
# where the register walk's part of knn_search.cuh ends
_LIST_WALK = "// The walk at any k (the *_any_k entry points;"
_READ = """
extern "C" int liodom_knn_trace(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, liodom_knn::g_trace, sizeof(unsigned long long) * n));
}
"""


def traced_sources(out: Path) -> Path:
    """The traced copy of the walk and of K3/K4's source under ``out``
    (the anchors are looked for in the register walk's part of the header,
    before the run-time-k walk ``ListWalk``, which repeats some)."""
    out.mkdir(parents=True, exist_ok=True)
    text_all = (kernels.CSRC / "knn_search.cuh").read_text()
    cut = text_all.index(_LIST_WALK)
    head, rest = text_all[:cut], text_all[cut:]
    for n, (anchor, text) in enumerate(_PATCHES):
        if head.count(anchor) != 1:
            raise SystemExit(f"knn_walk_trace: anchor not found once: "
                             f"{anchor!r}")
        last = n == len(_PATCHES) - 1
        head = head.replace(anchor, text + anchor if last else anchor + text)
    (out / "knn_search.cuh").write_text(head + rest)
    shutil.copy(kernels.CSRC / "knn_coords.cu", out / "knn_coords.cu")
    with open(out / "knn_coords.cu", "a") as f:
        f.write(_READ)
    return out


def summary(t: np.ndarray, flags: torch.Tensor, cluster: int) -> dict:
    t0 = t[:, 0].min()
    start, walked, end = ((t[:, i] - t0) / 1e3 for i in range(3))
    sm = t[:, 3] & 0xFFFF
    tiles = (t[:, 3] >> 16) & 0xFFFF
    steps = sorted([(x, 1) for x in start] + [(x, -1) for x in end])
    alive = np.cumsum([d for _, d in steps])
    out = {"blocks": len(t), "span_us": float(end.max()),
           "start_us_percentiles_0_50_90_100":
               np.percentile(start, [0, 50, 90, 100]).tolist(),
           "block_us_percentiles_0_50_90_99_100":
               np.percentile(end - start, [0, 50, 90, 99, 100]).tolist(),
           "walk_us_mean_by_tiles":
               {int(c): float(np.mean((walked - start)[tiles == c]))
                for c in np.unique(tiles)},
           "blocks_per_sm_max": int(np.bincount(sm).max()),
           "sms_used": int((np.bincount(sm) > 0).sum()),
           "most_blocks_alive": int(alive.max())}
    if flags.ndim == 2:
        et = int(flags.sum(-1).argmax())
        blk = np.arange(et * cluster, (et + 1) * cluster)
        out["busiest_query_tile"] = {
            "tile": et, "flagged_tiles": int(flags[et].sum()),
            "start_us": start[blk].tolist(), "walked_us": walked[blk].tolist(),
            "end_us": end[blk].tolist(), "sm": sm[blk].tolist(),
            "tiles": tiles[blk].tolist()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="8x2")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn_walk_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = kernels.BUILD_DIR / "trace"
    src = traced_sources(out / "base")
    variants = {sg: X.split_csrc(src, out / f"csrc-{sg}", sg)
                for sg in args.splits.split(",")}
    libs = X.build(variants, ("knn_coords",), out)
    cfg = LiodomConfig(local_map_size=5)
    prep, prep_b, _ = X.bench_inputs(cfg, dev, cfg.knn_max_sq_dist ** 0.5)
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0)}
    for sg, lib in libs.items():
        lib = lib["knn_coords"][0]
        lib.liodom_knn_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        cluster = int(sg.split("x")[0])
        for name, p in (("k3", prep), ("k4_b4", prep_b)):
            for _ in range(5):
                X.coords(lib, *p)
            torch.cuda.synchronize()
            X.coords(lib, *p)
            torch.cuda.synchronize()
            n = p[2].shape[-2] * cluster * (p[2].shape[0] if p[2].ndim == 3
                                            else 1)
            buf = np.zeros(n * 4, dtype=np.uint64)
            kernels.check(lib.liodom_knn_trace(buf.ctypes.data, n * 4),
                          "liodom_knn_trace")
            res[f"{sg} {name}"] = summary(
                buf.reshape(n, 4).astype(np.int64), p[2].cpu(), cluster)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
