#!/usr/bin/env python3
"""How many refs enter a list of the run-time-k kNN walk (``ListWalk``,
K3' above k = 16) on the bench frame, counted on the card.

    python3 scripts/list_walk_count.py [--earlier DIR] [--ks 17,64]
        [--out FILE]

Copies ``csrc/knn_search.cuh`` and ``csrc/knn_coords.cu`` (of this checkout,
and with ``--earlier`` of another ``csrc`` directory, for example an
earlier commit's unpacked by ``git archive``) into
``kernels/build/count/``, puts counters into the copy's ``ListWalk`` and
builds it as ``scripts/knn_walk_experiment.py`` does.  The counters are
put in at lines of code that must each appear once, exactly as written
(``_PATCHES``; the script stops if one does not), and add to a device
array that an added ``liodom_knn_count`` entry point reads back:

- a walk that merges 8-ref batches (this design): the batches that pass
  the k-th-best test, the refs that enter in them, and the list entries
  the tail merges read (kChunk at a time);
- a walk that inserts ref by ref (the design before it): the batches that
  pass, the refs inserted, and the slots they shift.

Every count is summed over the threads (walkers) of a launch.  On the bench
drive's last frame (K3 on lane 0, as ``chip_smoke.py``'s kernels phase
builds it) each build runs once at each k; its outputs must be
``torch.equal`` to ``knn_launch_plain``.  Prints one JSON object (and
writes it to ``--out``).  The shipped kernels carry no counter.
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
from liodom_tpu_torch.ops import knn_pallas as KNN  # noqa: E402

SLOTS = 64          # counters a kind, spread over blocks against contention
_HEAD = """
__device__ unsigned long long g_count[3 * 64];

__device__ __forceinline__ void trace_count(int kind,
                                            unsigned long long n) {
  atomicAdd(&g_count[kind * 64 + (blockIdx.x & 63)], n);
}
"""
# (a line of code, the text put after it, or with "before" before it)
_PATCHES = {
    "batch_merge": (
        ("namespace cg = cooperative_groups;\n", _HEAD, "after"),
        ("      if (!(lo < worst)) continue;\n",
         "      trace_count(0, 1);\n", "after"),
        ("      merge(d, e, n, ld, li, k, filled, worst);\n",
         "      trace_count(1, n);\n", "before"),
        ("    float last = kBig;                   "
         "// what lands in slot k - 1\n",
         "    unsigned long long steps = 0;\n", "after"),
        ("      float p[kChunk];\n", "      steps += kChunk;\n", "after"),
        ("    filled = min(k, filled + n);\n",
         "    trace_count(2, steps);\n", "before"),
    ),
    "ref_by_ref": (
        ("namespace cg = cooperative_groups;\n", _HEAD, "after"),
        ("        if (!(lo < worst)) continue;\n",
         "        trace_count(0, 1);\n", "after"),
        ("            insert(d[u], first + i0 + u, ld, li, k);\n",
         "            trace_count(1, 1);\n", "before"),
        ("    ld[s * kTileE] = d;\n    li[s * kTileE] = i;\n",
         "    trace_count(2, static_cast<unsigned long long>(k - 1 - s));\n",
         "before"),
    ),
}
_READ = """
extern "C" int liodom_knn_count(void* host, int reset) {
  if (reset) {
    static const unsigned long long zeros[3 * 64] = {};
    return static_cast<int>(cudaMemcpyToSymbol(liodom_knn::g_count, zeros,
                                               sizeof(zeros)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, liodom_knn::g_count, sizeof(unsigned long long) * 3 * 64));
}
"""
KINDS = {"batch_merge": ("batches_passed", "entrants", "merge_steps"),
         "ref_by_ref": ("batches_passed", "entrants", "shift_steps")}


def counted_sources(src: Path, out: Path) -> tuple:
    """The counted copy of ``src``'s walk and K3/K4 source under ``out``,
    and which design it is."""
    out.mkdir(parents=True, exist_ok=True)
    head = (src / "knn_search.cuh").read_text()
    design = ("ref_by_ref" if "void insert(float d, int i, float* ld,"
              in head else "batch_merge")
    for anchor, text, where in _PATCHES[design]:
        if head.count(anchor) != 1:
            raise SystemExit(f"list_walk_count: {src}: anchor not found "
                             f"once: {anchor!r}")
        head = head.replace(anchor, anchor + text if where == "after"
                            else text + anchor)
    (out / "knn_search.cuh").write_text(head)
    shutil.copy(src / "knn_coords.cu", out / "knn_coords.cu")
    with open(out / "knn_coords.cu", "a") as f:
        f.write(_READ)
    return out, design


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path,
                    help="another csrc directory to count")
    ap.add_argument("--ks", default="17,64")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("list_walk_count: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = kernels.BUILD_DIR / "count"
    dirs = {"shipped": kernels.CSRC}
    if args.earlier is not None:
        dirs["earlier"] = args.earlier
    designs, variants = {}, {}
    for label, src in dirs.items():
        variants[label], designs[label] = counted_sources(src, out / label)
    libs = X.build(variants, ("knn_coords",), out)
    cfg = LiodomConfig(local_map_size=5)
    prep, _, _ = X.bench_inputs(cfg, dev, cfg.knn_max_sq_dist ** 0.5)
    flags = prep[2]
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0),
           "queries": int(prep[0][:, 3].sum()), "query_slots":
           prep[0].shape[0], "flagged_pairs": int(flags.sum()),
           "ref_steps": int(flags.sum()) * KNN.TILE_E * KNN.TILE_M,
           "designs": designs, "failed": []}
    buf = np.zeros(3 * SLOTS, dtype=np.uint64)
    for label, lib in libs.items():
        lib = lib["knn_coords"][0]
        lib.liodom_knn_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for k in (int(x) for x in args.ks.split(",")):
            torch.cuda.synchronize()
            kernels.check(lib.liodom_knn_count(None, 1), "liodom_knn_count")
            got = X.coords_any_k(lib, label, *prep, k)
            torch.cuda.synchronize()
            kernels.check(lib.liodom_knn_count(buf.ctypes.data, 0),
                          "liodom_knn_count")
            sums = buf.reshape(3, SLOTS).sum(1)
            row = dict(zip(KINDS[designs[label]], map(int, sums)))
            row["torch_equal"] = all(
                torch.equal(a, b) for a, b in
                zip(got, KNN.knn_launch_plain(*prep, k=k)))
            if not row["torch_equal"]:
                res["failed"].append(f"{label} k={k}")
            res[f"{label} k={k}"] = row
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
