"""``full_step`` of the port and of JAX against the float64 oracle over the
20-frame planar course of ``tests/test_torch_full_step.py``.

That test holds the port to ``test_pipeline_golden.py``'s 5 mm / 2e-4 rad
band over its 6 frames and to ``test_pipeline_golden_6dof.py``'s 2 cm /
2e-3 rad band over all 20.  This script shows why: it prints, per frame,
the port's and JAX's distance and rotation angle from the recorded oracle
poses (``GOLDEN_PLANAR``).  If JAX itself leaves the 5 mm band past frame
6, the band's horizon is the algorithm's.  It takes about a minute on the
CPU; it is not collected by pytest.

    JAX_PLATFORMS=cpu python tests/oracle_band_vs_jax.py
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from liodom_tpu.core.config import LiodomConfig as JConfig  # noqa: E402
from liodom_tpu.core.frame import RawScan as JRawScan  # noqa: E402
from liodom_tpu.odometry import pipeline as JP  # noqa: E402

from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.core.frame import RawScan  # noqa: E402
from liodom_tpu_torch.odometry import pipeline as P  # noqa: E402

import test_torch_full_step as T  # noqa: E402


def main() -> int:
    scans, _ = T._scans("planar", T.N_GOLDEN)
    cfg, jcfg = LiodomConfig(**T.KW), JConfig(**T.KW)
    state, jstate = P.init_state(cfg, device="cpu"), JP.init_state(jcfg)
    rows = []
    for i, scan in enumerate(scans):
        raw = RawScan.from_points(torch.from_numpy(scan), cfg.max_points,
                                  device="cpu")
        state, pose, _ = P.full_step(state, raw.xyz, raw.valid, cfg)
        jraw = JRawScan.from_points(jnp.asarray(scan), jcfg.max_points)
        jstate, jpose, _ = JP.full_step(jstate, jraw.xyz, jraw.valid, jcfg)
        g = T.GOLDEN_PLANAR[i]
        row = {"frame": i}
        for name, q, t in (("port", pose.q.numpy(), pose.t.numpy()),
                           ("jax", np.asarray(jpose.q), np.asarray(jpose.t))):
            row[f"{name}_dt_m"] = float(np.linalg.norm(
                t.astype(np.float64) - g[4:]))
            row[f"{name}_drot_rad"] = float(T._rot_angle(q, g[:4]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({k: max(r[k] for r in rows) for k in rows[0]
                      if k != "frame"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
