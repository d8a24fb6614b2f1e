"""The readings a cell's limits are set from, for many seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--out FILE]

For each seed: one run of the cell's loop (``--seconds`` of window), its
compared numbers held to the reference (the program's readings, whose
largest over the seeds is a limit's lower reading), and the same frames
with the reference at TF32 in the program's place (the control, whose
smallest over the seeds is the upper reading; only for the seeds in
``--control-seeds`` when it is given).  Each kept frame's pose gaps are
written too, for both.  One JSON line a seed on
standard output (and appended to ``--out``).  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also run the control (all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("the control runs on a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    with_control = (None if args.control_seeds is None else
                    {int(s) for s in args.control_seeds.split(",")})
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, res, peak = run.measure(cell, seed, args.seconds, False, dev,
                                     time.perf_counter())
        t0 = time.perf_counter()
        frames_p, frames_c = [], []
        program = run.judge(cell, res, dev, frames=frames_p)
        t1 = time.perf_counter()
        control = None
        if with_control is None or seed in with_control:
            control = run.judge(cell, res, dev, "tf32", frames=frames_c)
        line = {"workload": args.workload, "seed": seed,
                "program": program, "control": control,
                "program_frames": frames_p, "control_frames": frames_c,
                "judge_s": [t1 - t0, time.perf_counter() - t1],
                "end_to_end": res.end_to_end, "setup_s": ctx.setup_s,
                "attempted": res.attempted, "failed": res.failed,
                "lossy": res.lossy, "memory_peak_bytes": peak,
                "samples": len(res.samples), **res.extra.get("diag", {})}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
