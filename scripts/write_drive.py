"""Write one drive of a benchmark cell's world as a KITTI odometry sequence,
for ``run_kitti`` to replay.

    python3 scripts/write_drive.py --root DIR [--seq 00] [--seed N] \
        [--workload kitti-map.newground]

Renders the cell's drive for ``--seed`` on the card
(``benchmark/streamworld.py``, the ``drive`` loop's files) into
``DIR/sequences/<seq>/velodyne/000000.bin`` .. and a ``times.txt`` at the
sensor's rate, then prints one JSON line: frames, bytes, seconds.  Then,
for example:

    python3 -m liodom_tpu_torch.apps.run_kitti --root DIR --mapping \
        --map-capacity 4194304 --local-map-capacity 262144 --aot

Imports torch, numpy and the benchmark; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.append(str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import spec, streamworld  # noqa: E402
from benchmark.loops.drive import write_drive  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workload", default="kitti-map.newground")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("write_drive renders on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    seq = Path(args.root) / "sequences" / args.seq
    velo = seq / "velodyne"
    velo.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    drive = streamworld.Drive(args.seed, cell.config, torch.device("cuda"))
    paths, render_s, write_s, written = write_drive(drive, velo)
    rate = cell.config["scene"]["rate_hz"]
    np.savetxt(seq / "times.txt", np.arange(len(paths)) / rate, fmt="%.6e")
    print(json.dumps({"frames": len(paths), "bytes": written,
                      "render_s": render_s, "write_s": write_s,
                      "seconds": time.perf_counter() - t0,
                      "root": args.root, "seed": args.seed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
