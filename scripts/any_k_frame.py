#!/usr/bin/env python3
"""``image_step``'s graph ms a frame at several ``knn_k`` on the bench
drive, on the card, for this checkout or another tree of the repository.

    python3 scripts/any_k_frame.py [--tree DIR] [--ks 20,5] [--out FILE]

Imports ``liodom_tpu_torch`` and ``chip_smoke.py`` from ``--tree`` (a
checkout, for example an earlier commit unpacked by ``git archive``;
default this one), so that its kernels and step are the ones timed.
Renders the bench drive of ``chip_smoke.py`` (lane 0: ``BoxWorld(seed=0)``,
36 frames of 1,800 columns at 1 cm noise, split on the card), captures
``image_step`` at each k through ``runtime/aot.get_or_compile`` and times
the graphs in turns (``chip_smoke.timed_in_turns``: 6 frames unmeasured,
then 30 between two CUDA events; each k twice, A B B A).  Each graph's
poses are held ``torch.equal`` to an eager drive at the same k.  Prints
one JSON object (and writes it to ``--out``).  Comparing two trees: run
the script once for each, in turns, in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="the checkout whose package and kernels to time")
    ap.add_argument("--ks", default="20,5")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import torch
    if not torch.cuda.is_available():
        print("any_k_frame: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    import liodom_tpu_torch
    from liodom_tpu_torch import kernels
    from liodom_tpu_torch.core.config import LiodomConfig
    from liodom_tpu_torch.odometry import pipeline as P
    from liodom_tpu_torch.runtime import aot
    if Path(liodom_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"any_k_frame: liodom_tpu_torch is not {tree}'s",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    cfg = LiodomConfig(local_map_size=5)
    imgs = CS.render_lanes(cfg, dev, [0], noise=0.01)[0][0]
    drives, equal, capture_s = {}, {}, {}
    for k in (int(x) for x in args.ks.split(",")):
        ck = cfg.replace(knn_k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = aot.get_or_compile(
            f"image_step_k{k}", lambda s, x, c, ck=ck: P.image_step(
                s, x, c, ck), (P.init_state(ck), imgs[0].xyz, imgs[0].count),
            str(ck))
        torch.cuda.synchronize()
        capture_s[f"k={k}"] = time.perf_counter() - t0
        _, gposes, _ = CS.graph_drive(graph, P.init_state(ck), imgs)
        _, eposes, _ = CS.run_course(P.init_state(ck), imgs, ck, keep=False)
        equal[f"k={k}"] = all(torch.equal(a.t, b.t) and torch.equal(a.q, b.q)
                              for a, b in zip(gposes, eposes))
        drives[f"k={k}"] = (
            lambda st, fr, first, graph=graph: CS.graph_drive(
                graph, st, fr, first)[0],
            lambda ck=ck: P.init_state(ck), imgs)
    runs = CS.timed_in_turns(drives, CS.N_WARM)
    res = {"tree": str(tree), "nvidia_smi": CS.nvidia_smi_line(),
           "kind": torch.cuda.get_device_name(0), "build_s": build_s,
           "capture_s": capture_s, "frames": len(imgs),
           "warm_frames": CS.N_WARM,
           "graph_ms_per_frame": {name: [r[0] for r in v]
                                  for name, v in runs.items()},
           "host_ms_per_frame": {name: [r[1] for r in v]
                                 for name, v in runs.items()},
           "graph_equals_eager": equal}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
