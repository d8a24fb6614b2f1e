"""Run statistics and result dumps (the port's copy of
``liodom_tpu/runtime/stats.py``; the five files are byte for byte the JAX
package's for the same inputs).

Parity with the reference ``Stats`` singleton (stats.h/.cc): collects
per-frame poses, stage timings and feature counts, and writes the same five
text files (stats.cc:73-132):

* ``poses.txt``           — KITTI 3x4 row-major poses (stats.cc:75-95)
* ``feat_ext_times.txt``  — feature-extraction ms per frame
* ``laser_odom_times.txt``— odometry ms per frame
* ``nfeats.txt``          — edge count per frame
* ``frame_times.txt``     — end-to-end ms per frame

so external KITTI ATE/RPE tooling works unchanged.

Stage-semantics note for the fused engine: the reference times feature
extraction and odometry as two separate threads (stats.cc:41-54).  Here
smoothness + edge selection run INSIDE the odometry step (kernels K1 and
K2 on the card), so ``laser_odom_times`` covers the whole step, and
``feat_ext_times`` records what remains host-visible for that stage —
loader dequeue + host->device staging in the image-input apps
(runtime.native ring-splits in prefetch threads), or a measured re-dispatch
of the extraction alone in the raw-scan apps.

Sampling contract for ``laser_odom_times`` (the apps dispatch frames
asynchronously to keep the device pipelined): every Kth frame
(``--time-every``) is timed with a blocking pose fetch — its row is the
TRUE ingest->pose latency of that frame — and the untimed frames in
between carry the most recent sample.  Row count still equals the frame
count, and means/medians reflect real device latency (the reference writes
real per-frame ms, stats.cc:97-131; a naive async timestamp would write
~0.1 ms dispatch stubs instead).  So per-row truth is self-describing,
``laser_odom_times.txt`` carries a second column — 1 for a measured row,
0 for a carried copy — plus a ``#``-prefixed header line; single-column
tooling (``np.loadtxt(usecols=0)``) keeps working, and the reference's
one-value-per-row layout is a strict subset (every reference row is
"measured").
``frame_times`` pairs ``start_frame`` (scan ingest) with ``stop_frame``
(pose fetched back to the host), exactly like the reference's queue pairing
(stats.cc:55-71).
"""

from __future__ import annotations

import os
import threading
from typing import List

import numpy as np


class Stats:
    """Thread-safe run statistics collector."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.poses: List[np.ndarray] = []
        self.feat_ext_times: List[float] = []
        self.laser_odom_times: List[float] = []
        self.laser_odom_measured: List[int] = []  # 1 sampled, 0 carried
        self.num_feats: List[int] = []
        self.frame_times: List[float] = []
        self._frame_starts: List[float] = []

    # --- accumulation (Stats::add*, stats.cc:37-53) ---
    def add_pose(self, mat4: np.ndarray) -> None:
        with self._lock:
            self.poses.append(np.asarray(mat4, dtype=np.float64))

    def add_feature_extraction_time(self, ms: float) -> None:
        with self._lock:
            self.feat_ext_times.append(float(ms))

    def add_laser_odometry_time(self, ms: float, measured: bool = True
                                ) -> None:
        """``measured=False`` marks a carried copy of the last blocking
        sample (the inter-sample rows of the ``--time-every`` contract);
        the flag lands as the row's second column in
        ``laser_odom_times.txt``."""
        with self._lock:
            self.laser_odom_times.append(float(ms))
            self.laser_odom_measured.append(1 if measured else 0)

    def add_num_feats(self, n: int) -> None:
        with self._lock:
            self.num_feats.append(int(n))

    def add_frame_time(self, ms: float) -> None:
        with self._lock:
            self.frame_times.append(float(ms))

    # --- start/stop pairing (stats.cc:55-71) ---
    def start_frame(self, t: float) -> None:
        with self._lock:
            self._frame_starts.append(float(t))

    def stop_frame(self, t: float) -> None:
        with self._lock:
            if self._frame_starts:
                start = self._frame_starts.pop(0)
                self.frame_times.append((float(t) - start) * 1e3)

    # --- dump (Stats::writeResults, stats.cc:73-132) ---
    def write_results(self, directory: str) -> None:
        directory = os.path.expanduser(directory)
        os.makedirs(directory, exist_ok=True)

        def path(name):
            return os.path.join(directory, name)

        with open(path("poses.txt"), "w") as f:
            for m in self.poses:
                row = m[:3, :4].reshape(-1)
                f.write(" ".join(f"{float(v):.9g}" for v in row) + "\n")
        for name, vals in (("feat_ext_times.txt", self.feat_ext_times),
                           ("nfeats.txt", self.num_feats),
                           ("frame_times.txt", self.frame_times)):
            with open(path(name), "w") as f:
                for v in vals:
                    f.write(f"{v}\n")
        with open(path("laser_odom_times.txt"), "w") as f:
            f.write("# ms measured  (measured: 1 = blocking-fetch sample of "
                    "this frame, 0 = carried copy of the last sample; see "
                    "runtime/stats.py sampling contract)\n")
            flags = self.laser_odom_measured
            for i, v in enumerate(self.laser_odom_times):
                m = flags[i] if i < len(flags) else 1
                f.write(f"{v} {m}\n")


def load_kitti_poses(path: str) -> np.ndarray:
    """Read a KITTI poses.txt into (F, 3, 4)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error (translation RMSE), no alignment."""
    d = est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over a frame gap: returns (trans_rmse_per_frame,
    rot_rmse_rad_per_frame) — the standard KITTI-style drift metrics."""
    def to44(p):
        out = np.tile(np.eye(4), (len(p), 1, 1))
        out[:, :3, :4] = p
        return out

    e, g = to44(est), to44(gt)
    t_errs, r_errs = [], []
    for i in range(len(e) - delta):
        de = np.linalg.inv(e[i]) @ e[i + delta]
        dg = np.linalg.inv(g[i]) @ g[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        c = (np.trace(err[:3, :3]) - 1.0) / 2.0
        r_errs.append(abs(float(np.arccos(np.clip(c, -1.0, 1.0)))))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
