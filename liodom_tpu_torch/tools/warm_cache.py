"""Deploy-time warm cache of the port (port of ``scripts/warm_cache.py``).

    python -m liodom_tpu_torch.tools.warm_cache [RING_WIDTH] [--dir DIR]
        [--device cpu]

Run once when a container is deployed, so that an app's first frame pays
no compile.  The JAX tool serialises the compiled step programs; a CUDA
graph cannot outlive its process (``runtime/aot.py``), so what persists
here is the build: every kernel source of ``kernels.SOURCES`` (one
``nvcc`` a source, all started together) into
``runtime/cache.enable_persistent_cache``'s directory, or ``DIR``, each
library then loaded, and the native loader (``runtime/native.py``, g++),
which keeps its library beside its source.  Then the production programs
of the JAX tool (``scripts/warm_cache.py:44-70``) are captured through
``runtime/aot.get_or_compile``, to show that they start:

* ``image_step`` at window 5 (``bench.py``, ``params.cc``'s default);
* ``image_step`` at window 15 (the launch file's window);
* ``combined_image_step`` at window 15 with ``run_kitti --mapping``'s map:
  40/50 m cells, 0.4 m leaves, 3/2 cells and a 65,536-row local map.

``RING_WIDTH`` (default 4,096, as in JAX) must be the ring width of the
run to come.  Printed: for each source its build seconds, cold (compiled
now) or warm (found built); for each program the seconds of the CUDA
context (the first program creates it), the libraries' load, the first
and the second eager call on zero images, and the capture (two warm calls
on a side stream and the capture itself).  Run in a new process after a
warm build, these lines say what fills an app's first frame.  The last
line is one JSON report.  With ``--device cpu`` the programs run on the
plain versions through ``get_or_compile``'s CPU route and nothing is
built.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.mapping.service import combined_image_step, init_combined
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.runtime import aot, cache, native
from liodom_tpu_torch.runtime.device_io import (device_name, path_kernels,
                                                prepare_kernels)

RING_WIDTH = 4096
# run_kitti --mapping's map (scripts/warm_cache.py:63-64)
KITTI_MCFG = MapConfig(voxel_xysize=40.0, voxel_zsize=50.0, resolution=0.4,
                       cells_xy=3, cells_z=2, local_map_capacity=65536)


class Program(NamedTuple):
    """One production step program, as the JAX tool builds it."""
    label: str                  # the JAX tool's line
    name: str                   # its get_or_compile name
    cfg: LiodomConfig
    mcfg: Optional[MapConfig]   # None: odometry only
    extra: str                  # its get_or_compile extra


def programs(ring_width: int = RING_WIDTH) -> List[Program]:
    """``scripts/warm_cache.py:44-70``: ``image_step`` at windows 5 and 15,
    ``combined_image_step`` at window 15 with :data:`KITTI_MCFG`, the map
    refreshed every frame."""
    out = []
    for window in (5, 15):
        cfg = LiodomConfig(local_map_size=window, ring_width=ring_width)
        out.append(Program(f"image_step window={window}", "kitti_image_step",
                           cfg, None, str(cfg)))
    cfg = LiodomConfig(local_map_size=15, mapping=True, ring_width=ring_width)
    out.append(Program("combined window=15", "kitti_combined", cfg,
                       KITTI_MCFG, f"{cfg}|{KITTI_MCFG}|every=1"))
    return out


def step_and_args(prog: Program, dev: torch.device):
    """(the program's step, its example args: the initial state and a zero
    image and counts, as the JAX tool's)."""
    cfg, mcfg = prog.cfg, prog.mcfg
    img = torch.zeros((cfg.scan_lines, cfg.ring_width, 3), dtype=torch.float32,
                      device=dev)
    cnt = torch.zeros((cfg.scan_lines,), dtype=torch.int32, device=dev)
    if mcfg is None:
        return ((lambda s, x, c: P.image_step(s, x, c, cfg)),
                (P.init_state(cfg, device=dev), img, cnt))
    return ((lambda s, m, x, c, i: combined_image_step(
        s, m, x, c, cfg, mcfg, step=i, local_map_every=1)),
        init_combined(cfg, mcfg, device=dev) + (img, cnt, 0))


def build_sources(names: Sequence[str] = kernels.SOURCES) -> Dict[str, dict]:
    """Build every named kernel source that has no library yet, one ``nvcc``
    a source, all started together: ``{name: {"seconds", "build": "cold"
    or "warm"}}``; raises if a compile fails."""
    nvcc = kernels.nvcc_path()

    def one(name):
        t0 = time.perf_counter()
        warm = kernels.library_path(name, nvcc).exists()
        kernels.build_all([name])
        return name, {"seconds": time.perf_counter() - t0,
                      "build": "warm" if warm else "cold"}

    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        return dict(ex.map(one, names))


def build_loader() -> dict:
    """Build (g++) and load the native loader: ``{"seconds", "build",
    "loaded"}``; without a toolchain it is not loaded and the loader's NumPy
    fallbacks serve."""
    t0 = time.perf_counter()
    warm = os.path.exists(native.library_path())
    ok = native.native_available()
    return {"seconds": time.perf_counter() - t0,
            "build": "warm" if warm else "cold", "loaded": ok}


def _timed(fn: Callable[[], object], dev: torch.device) -> float:
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def start_program(prog: Program, dev: torch.device) -> dict:
    """The program's seconds: the CUDA context, the libraries' load, the
    first and second eager call, the capture (``get_or_compile``); on the
    CPU the first two are None and the capture is the CPU route's one warm
    call."""
    cuda = dev.type == "cuda"
    out = {"context_s": None, "load_s": None}
    if cuda:
        out["context_s"] = _timed(
            lambda: torch.zeros(1, device=dev), dev)
        out["load_s"] = _timed(lambda: prepare_kernels(
            path_kernels(prog.mcfg is not None), dev), dev)
    fn, args = step_and_args(prog, dev)
    out["first_call_s"] = _timed(lambda: fn(*args), dev)
    out["second_call_s"] = _timed(lambda: fn(*args), dev)
    out["capture_s"] = _timed(lambda: aot.get_or_compile(
        prog.name, fn, args, extra=prog.extra), dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ring_width", nargs="?", type=int, default=RING_WIDTH,
                    help="the ring width of the run to come (default 4096)")
    ap.add_argument("--dir", default=None,
                    help="the kernels' library directory (default: "
                         "runtime/cache.enable_persistent_cache's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report = {"device": device_name(dev), "ring_width": args.ring_width,
              "sources": {}, "compiled": [], "native_loader": None,
              "programs": {}}
    if dev.type == "cuda":
        report["directory"] = cache.enable_persistent_cache(args.dir)
        t0 = time.perf_counter()
        report["sources"] = build_sources()
        report["build_s"] = time.perf_counter() - t0
        for name, b in report["sources"].items():
            print(f"{name}: {b['seconds']:.2f} s ({b['build']})", flush=True)
        report["native_loader"] = build_loader()
        nl = report["native_loader"]
        print(f"native loader: {nl['seconds']:.2f} s ({nl['build']}"
              f"{'' if nl['loaded'] else ', not loaded'})", flush=True)
        report["compiled"] = sorted(n for n, b in report["sources"].items()
                                    if b["build"] == "cold")
        print(f"libraries in {report['directory']}", flush=True)
    for prog in programs(args.ring_width):
        s = start_program(prog, dev)
        report["programs"][prog.label] = s
        print(f"{prog.label}: " + ", ".join(
            f"{k[:-2]} {v:.3f} s" for k, v in s.items() if v is not None),
            flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
