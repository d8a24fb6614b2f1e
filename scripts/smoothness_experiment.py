#!/usr/bin/env python3
"""K1, the smoothness stencil (``csrc/smoothness.cu``), on the card: the
shipped kernel against an earlier build and other block sizes, on the same
inputs, in one process.

    python3 scripts/smoothness_experiment.py [--earlier DIR]
        [--threads 128,512] [--out FILE]

Builds this checkout's ``smoothness.cu`` (``shipped``), copies of it with
``kThreads`` (the threads a block; a block owns 4 columns a thread) set to
each of ``--threads``, and, with ``--earlier``, another ``csrc``
directory's (for example an earlier commit's, unpacked by ``git
archive``), one ``nvcc`` each, all together, into
``kernels/build/experiment/``.  Every build takes the same C entry point.

Inputs: the last frame of the bench drive of ``chip_smoke.py`` (lane s:
``BoxWorld(seed=s)``, 1.2 m/frame, 0.01 (s + 1) rad/frame, 1 cm noise,
split on the card) for lanes 0-7, and ``chip_smoke.smoothness_cases`` on
them: the bench frame (64 x 4,096), the folded B = 4 and 8 (256 and 512
rings), the Ouster path (128 rings from lane 0's spin), a width of 1,801,
counts 0, <= 10 and the full width, one full ring, an unaligned tensor.
Every build's output must be ``torch.equal`` to ``smoothness_plain`` on
every case.  Then each build's time by CUDA events over 200 launches, the
builds in turns (forward, then backward, twice), beside the case's two
byte bounds.  Prints one JSON object (and writes it to ``--out``); exits 1
if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.core.frame import RawScan  # noqa: E402
from liodom_tpu_torch.core import organize  # noqa: E402
from liodom_tpu_torch.core import synth  # noqa: E402
from liodom_tpu_torch.ops import features as F  # noqa: E402
from liodom_tpu_torch.ops import smoothness_pallas as SM  # noqa: E402

REPS = 200
LANES = 8
THREADS_LINE = "constexpr int kThreads = 128;"


def build(variants: dict, out_dir: Path) -> dict:
    """{label: (CDLL, ptxas usage)} for {label: path of a smoothness.cu}."""
    nvcc = kernels.nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, src in variants.items():
        so = out_dir / f"smoothness-{label}.so"
        jobs[label] = (subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.liodom_smoothness
        fn.argtypes = list(kernels.ABI["smoothness"]["liodom_smoothness"])
        fn.restype = ctypes.c_int
        libs[label] = (lib, CS.ptxas_usage(log))
    return libs


def launch(lib, xyz: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    out = torch.empty(xyz.shape[:2], dtype=torch.float32, device=xyz.device)
    err = lib.liodom_smoothness(xyz.data_ptr(), count.data_ptr(),
                                out.data_ptr(), xyz.shape[0], xyz.shape[1],
                                torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "liodom_smoothness")
    return out


def bench_frames(dev):
    """The bench drive's last frame for each lane, split on the card, and
    lane 0's spin."""
    cfg = LiodomConfig(local_map_size=5)
    imgs, spin0 = [], None
    for s in range(LANES):
        pos, yaws = synth.drive_trajectory(CS.N_FRAMES, speed=1.2,
                                           yaw_rate=0.01 * (s + 1))
        i = CS.N_FRAMES - 1
        spin = synth.BoxWorld(seed=s).render(
            pos[i], synth.yaw_matrix(yaws[i]), width=1800, noise=0.01,
            seed=1000 * s + i)
        spin0 = spin if s == 0 else spin0
        imgs.append(F.split_scan(RawScan.from_points(
            torch.from_numpy(spin), cfg.max_points, device=dev), cfg))
    return imgs, spin0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path,
                    help="another csrc directory to build and compare")
    ap.add_argument("--threads", default="",
                    help="comma-separated kThreads values to build besides "
                         "the shipped one")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("smoothness_experiment: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out_dir = kernels.BUILD_DIR / "experiment"
    shipped = kernels.CSRC / "smoothness.cu"
    variants = {"shipped": shipped}
    text = shipped.read_text()
    for t in (int(x) for x in args.threads.split(",") if x):
        if THREADS_LINE not in text:
            raise SystemExit(f"{shipped}: no line '{THREADS_LINE}'")
        copy = out_dir / f"smoothness_t{t}.cu"
        out_dir.mkdir(parents=True, exist_ok=True)
        copy.write_text(text.replace(THREADS_LINE,
                                     f"constexpr int kThreads = {t};"))
        variants[f"threads_{t}"] = copy
    if args.earlier is not None:
        variants["earlier"] = args.earlier / "smoothness.cu"
    libs = build(variants, out_dir)

    imgs, spin0 = bench_frames(dev)
    folded = [F.RingImage(torch.stack([im.xyz for im in imgs[:n]]),
                          torch.stack([im.count for im in imgs[:n]]))
              for n in (4, LANES)]
    ouster = F.split_scan_ouster(torch.from_numpy(
        organize.organized_from_unorganized(
            spin0, CS.OUSTER_CFG.scan_lines, CS.OUSTER_COLS)).to(dev),
        CS.OUSTER_CFG)
    cases = CS.smoothness_cases(imgs[0], folded[0], folded[1], ouster, dev)

    ok, res = True, {"nvidia_smi": CS.nvidia_smi_line(),
                     "kind": torch.cuda.get_device_name(0),
                     "ptxas": {k: v[1] for k, v in libs.items()},
                     "cases": {}}
    for name, (x, c) in cases.items():
        want = SM.smoothness_plain(x, c)
        equal = {label: torch.equal(launch(lib, x, c), want)
                 for label, (lib, _) in libs.items()}
        ok &= all(equal.values())
        whole, needed = CS.smoothness_bounds(x, c)
        times = {label: [] for label in libs}
        order = list(libs) + list(libs)[::-1]
        for label in order + order:
            lib = libs[label][0]
            times[label].append(CS.cuda_ms(lambda: launch(lib, x, c), REPS))
        res["cases"][name] = {
            "rings": x.shape[0], "width": x.shape[1],
            "points": int(torch.clamp(c, max=x.shape[1]).sum()),
            "equal_to_plain": equal, "ms_in_turns": times,
            "bound_ms": needed[0], "whole_image_bound_ms": whole[0]}
    res["all_equal"] = ok
    line = json.dumps(res)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
