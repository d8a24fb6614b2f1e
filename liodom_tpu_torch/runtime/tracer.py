"""Tracing / profiling (port of ``liodom_tpu/runtime/tracer.py``).

The reference's tracing is wall-clock stage timing via ``Clock``
(defs.h:39) around feature extraction (feature_extractor.cc:55-60) and
odometry (laser_odometry.cc:140,237), paired end-to-end frame latency
(stats.cc:55-71), all dumped as text (stats.cc:97-131).  Here:

* :class:`StageTimer` — the same per-stage host timers, feeding
  :class:`liodom_tpu_torch.runtime.stats.Stats` so the five reference result
  files come out identical in shape;
* :class:`DeviceTrace` — ``torch.profiler`` over a region: the host's
  operators and, on the card, its kernels (CUPTI), written as a Chrome
  trace, which the reference has no equivalent of;
* :func:`annotate` — ``torch.profiler.record_function``, labelling a
  host-side section inside a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity

from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.runtime.stats import Stats


class StageTimer:
    """Wall-clock stage timing routed into :class:`Stats`.

    Usage::

        timer = StageTimer(stats)
        with timer.stage("feature_extraction"):
            ...
    """

    _ROUTES = {
        "feature_extraction": "add_feature_extraction_time",
        "laser_odometry": "add_laser_odometry_time",
        "frame": "add_frame_time",
    }

    def __init__(self, stats: Optional[Stats] = None):
        self.stats = stats
        self.last_ms: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.last_ms[name] = ms
            if self.stats is not None and name in self._ROUTES:
                getattr(self.stats, self._ROUTES[name])(ms)


class DeviceTrace:
    """``torch.profiler`` trace of a region, written on exit as the Chrome
    trace ``<logdir>/trace.json`` (chrome://tracing, Perfetto).

    ``device`` is where the traced code runs: CUDA unless the caller names
    another, as every entry point of the port.  On CUDA the trace records
    the card's kernels beside the host's operators; on the CPU it records
    the host only (the CUDA tracer has no card to attach to).  Unlike the
    JAX package's class, a profiler that cannot start raises: a trace that
    was asked for is never silently empty."""

    def __init__(self, logdir: str, device=None):
        self.logdir = logdir
        self.path = os.path.join(logdir, "trace.json")
        self.activities = [ProfilerActivity.CPU]
        if resolve_device(device).type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self.profiler: Optional[torch.profiler.profile] = None

    def __enter__(self):
        os.makedirs(self.logdir, exist_ok=True)
        self.profiler = torch.profiler.profile(activities=self.activities)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        self.profiler.export_chrome_trace(self.path)
        return False


def annotate(name: str):
    """Label a host-side region inside a trace."""
    return torch.profiler.record_function(name)
