"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the window, reduced to what the per-layer readers take.

The device's busy time is the union of the intervals of every operation
on the device (kernels, copies, sets), so work on two streams at once
counts once.  Host spans are the benchmark's own ``bench.*`` labels,
put around the calls into the program; they cost nothing when the run
is not traced.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

LABEL = "bench."


@dataclass
class Trace:
    """What the profiler saw over the traced stretch."""
    window_s: float                      # host clock, synchronised ends
    busy_s: float                        # union of device intervals
    frames: int                          # frames (steps) in the stretch
    kernels: Dict[str, Tuple[float, int]]  # name: (seconds, launches)
    host_ops: int                        # host-side events, not ours
    device_ops: List[Tuple[str, float]]  # the longest by total time
    idle_gaps: List[Tuple[str, float]]   # the longest, by host label
    records: List[dict] = field(default_factory=list)   # per traced frame

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds
        ``pattern``."""
        t = n = 0
        for name, (s, c) in self.kernels.items():
            if pattern in name:
                t, n = t + s, n + c
        return t, n


def _union(iv: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals and the gaps
    between its pieces."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(iv):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            dev = ev.device_type() == torch.autograd.DeviceType.CUDA
            start = ev.start_ns()
            yield ev.name(), dev, start, start + ev.duration_ns()
        return
    for ev in prof.events():
        dev = ev.device_type == torch.autograd.DeviceType.CUDA
        yield (ev.name, dev, int(ev.time_range.start * 1e3),
               int(ev.time_range.end * 1e3))


class Tracer:
    """Labels host spans and profiles one stretch of the window, when
    ``enabled``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self._t0 = 0.0
        self.trace: Optional[Trace] = None
        self.active = False

    def label(self, name: str):
        if self.enabled and self.active:
            return torch.profiler.record_function(LABEL + name)
        return contextlib.nullcontext()

    @property
    def finished(self) -> bool:
        """Nothing (more) to trace: the window may close."""
        return not self.enabled or self.trace is not None

    def warm(self) -> None:
        """Start and stop the profiler once around a trivial operation, so
        the window's start pays no first initialisation (CUPTI's, seconds
        on the card)."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device=self.device).sum().item()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self, frames: int, records: List[dict]) -> None:
        if not self.active:
            return
        self._sync()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.active = False
        self.trace = reduce(self._prof, window, frames, records)
        self._prof = None


def reduce(prof, window_s: float, frames: int, records: List[dict]) -> Trace:
    """The profiler's events reduced to a :class:`Trace`."""
    dev_iv, kernels, host_ops, labels, host = [], {}, 0, [], []
    for name, dev, s, e in _events(prof):
        if dev and name.startswith(LABEL):
            continue            # a host label's copy on the device's rows
        if dev:
            dev_iv.append((s, e))
            t, n = kernels.get(name, (0.0, 0))
            kernels[name] = (t + (e - s) * 1e-9, n + 1)
        elif name.startswith(LABEL):
            labels.append((s, e, name[len(LABEL):]))
        else:
            host_ops += 1
            host.append((s, e, name))
    busy, gaps = _union(dev_iv)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for s, e in longest:
        mid = (s + e) // 2
        inner = [(le - ls, n) for ls, le, n in labels if ls <= mid <= le]
        if not inner:
            inner = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        idle.append((min(inner)[1] if inner else "host", (e - s) * 1e-9))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return Trace(window_s, busy * 1e-9, frames, kernels, host_ops,
                 [(n[:120], t) for n, (t, _) in top], idle, records)
