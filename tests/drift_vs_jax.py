"""The port's CPU path against the JAX engine over the chip smoke test's drive.

``chip_smoke.py`` drives the port for 36 frames of the noise-free BoxWorld
course at the bench configuration and gates the ATE over the first 20
frames only.  This script shows why: it runs the same ring images through
JAX ``image_step`` and the port's ``image_step`` (CPU, plain versions of the
kernels) and prints, per frame, both edge counts, both position errors
against the known trajectory and the distance between the two poses, then
both ATEs.  If both engines drift alike past frame 20, the drift is the
algorithm's.  It takes several minutes; it is not collected by pytest.

    JAX_PLATFORMS=cpu python tests/drift_vs_jax.py [--frames 36]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from liodom_tpu.core.config import LiodomConfig as JConfig  # noqa: E402
from liodom_tpu.core.frame import RawScan as JRawScan  # noqa: E402
from liodom_tpu.core.synth import (BoxWorld, drive_trajectory,  # noqa: E402
                                   yaw_matrix)
from liodom_tpu.odometry import pipeline as JP  # noqa: E402
from liodom_tpu.ops import features as JF  # noqa: E402

from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.odometry import pipeline as P  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=36)
    args = ap.parse_args()
    jcfg, cfg = JConfig(local_map_size=5), LiodomConfig(local_map_size=5)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(args.frames, speed=1.2, yaw_rate=0.01)
    jstate, state = JP.init_state(jcfg), P.init_state(cfg, device="cpu")
    err_j, err_t = [], []
    for i in range(args.frames):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=1800,
                            noise=0.0, seed=i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        jstate, jpose, jn = JP.image_step(jstate, img.xyz, img.count, jcfg)
        state, pose, n = P.image_step(
            state, torch.from_numpy(np.array(img.xyz)),
            torch.from_numpy(np.array(img.count)), cfg)
        jt, t = np.asarray(jpose.t), pose.t.numpy()
        err_j.append(float(np.linalg.norm(jt - pos[i])))
        err_t.append(float(np.linalg.norm(t - pos[i])))
        print(json.dumps({"frame": i, "edges_jax": int(jn), "edges_port": int(n),
                          "err_jax_m": err_j[-1], "err_port_m": err_t[-1],
                          "jax_vs_port_m": float(np.linalg.norm(jt - t))}),
              flush=True)
    ej, et = np.array(err_j), np.array(err_t)
    print(json.dumps({
        "ate_first_20_jax_m": float(np.sqrt(np.mean(ej[:20] ** 2))),
        "ate_first_20_port_m": float(np.sqrt(np.mean(et[:20] ** 2))),
        "ate_all_jax_m": float(np.sqrt(np.mean(ej ** 2))),
        "ate_all_port_m": float(np.sqrt(np.mean(et ** 2)))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
