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
(``_PATCHES``), each of which must appear there once, exactly as written:
the script stops if one does not.  On the bench drive's last frame (lane
0 of ``chip_smoke.py``, 64 x 4096 rings, 88 slots a ring) it runs the
build 5 times, then once traced, checks the slots against the shipped
kernel's, and prints one JSON object (and writes it to ``--out``): the
span and, over the rings, the spread of each phase.  The shipped kernel
is not changed.
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

_SLOTS = 6     # timeline entries a block
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
    g_trace[blockIdx.x * 6 + 0] = t_start;
    g_trace[blockIdx.x * 6 + 1] = t_ranked;
    g_trace[blockIdx.x * 6 + 2] = t_synced;
  }
"""),
    ("<  cluster.sync();                          // every list in rank 0\n",
     "  const unsigned long long t_ranked = trace_now();\n"),
    ("  __syncthreads();\n\n  for (int k = tid; k < slots; k += kThreads) {\n",
     None),
)
_WALKED = """  if (tid == 0 && blockIdx.x < (1 << 15))
    g_trace[blockIdx.x * 6 + 3] = trace_now();
"""
_END = """  __syncthreads();
  if (tid == 0 && blockIdx.x < (1 << 15))
    g_trace[blockIdx.x * 6 + 4] = trace_now();
}

}  // namespace
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
    tail = "}\n\n}  // namespace\n"
    if src.count(tail) != 1:
        raise SystemExit("select_walk_trace: the kernel's end not found once")
    src = src.replace(tail, _END) + _READ
    (out / "select.cu").write_text(src)
    return out


def pct(x) -> list:
    return np.percentile(x, [0, 50, 90, 100]).tolist()


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
    for _ in range(5):
        X.select(lib, img, sm, cfg)
    torch.cuda.synchronize()
    got = X.select(lib, img, sm, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in
               zip(got, X.select(libs["shipped"][0], img, sm, cfg)))
    rings = img.xyz.shape[0]
    blocks = SEL.select_shape(img.xyz.shape[1], cfg.scan_regions,
                              cfg.max_edges_per_region)["cluster_blocks"]
    n = rings * blocks
    buf = np.zeros(n * _SLOTS, dtype=np.uint64)
    kernels.check(lib.liodom_select_trace(buf.ctypes.data, n * _SLOTS),
                  "liodom_select_trace")
    t = buf.reshape(rings, blocks, _SLOTS).astype(np.int64)
    t0 = t[:, :, 0].min()
    us = (t - t0) / 1e3
    root = us[:, 0]
    res = {"nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0), "slots_equal": same,
           "rings": rings, "cluster_blocks": blocks,
           "span_us": float(root[:, 4].max()),
           "us_percentiles_0_50_90_100": {
               "block_start": pct(us[:, :, 0]),
               "rank_phase_per_block": pct(us[:, :, 1] - us[:, :, 0]),
               "cluster_barrier_wait_rank0": pct(root[:, 2] - root[:, 1]),
               "ring_lists_ready": pct(us[:, :, 1].max(axis=1)),
               "walk_rank0": pct(root[:, 3] - root[:, 2]),
               "slots_written_rank0": pct(root[:, 4] - root[:, 3]),
               "ring_end": pct(root[:, 4])}}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
