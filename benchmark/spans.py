"""The program's own record of spans and counters, reduced to the window,
for the readers of the ``program_span`` and ``program_counter`` metrics.

The record is the port's span recorder's snapshot
(``liodom_tpu_torch/runtime/tracer.snapshot``), times in host ns on
``time.perf_counter_ns``, the benchmark's own clock:

* ``host``: ``(name, frame, parent index or -1, t0, t1, thread)``;
* ``device``: ``(name, frame, parent name, t0, t1, in_graph)``: a device
  span resolved to the host clock at the next pose fetch; an in-graph one
  comes from the captured step's last replay before a fetch, one sampled
  frame a block;
* ``counts``: ``(name, frame, running total, t)`` at each fetch;
* ``anchors``: ``(frame, t)``;
* ``quiet``: ``(t0, t1)`` of each stretch under ``torch.profiler`` (a
  ``--trace 1`` run's traced stretch), in which the program recorded
  nothing: the window's idle leaves them out.

A run's view carries it as ``program``; a run without one (the recorder
not armed, or a program without it) reads ``None`` in every reader here.

The window runs from the process's start plus its set-up
(``ctx.t_process + ctx.setup_s``) to the end of the last top-level
``fetch`` span; its frames are those whose frame step (a top-level
``step`` or ``aot.replay`` span) starts inside it.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.trace import _union

FRAME_STEPS = ("step", "aot.replay")


class Window:
    """The record cut to the window: ``t0``, ``t1`` (ns), its ``frames``."""

    def __init__(self, rec: dict, t0: int, t1: int, frames: set):
        self.rec, self.t0, self.t1, self.frames = rec, t0, t1, frames

    def device_ms(self, names: Iterable[str], in_graph: Optional[bool]
                  ) -> Dict[int, float]:
        """ms a frame of the device spans called ``names`` (in the graph,
        outside it, or either for ``None``), summed over each frame that
        has one."""
        names = set(names)
        out: Dict[int, float] = {}
        for n, f, _, s, e, g in self.rec["device"]:
            if n in names and f in self.frames and (in_graph is None
                                                    or g == in_graph):
                out[f] = out.get(f, 0.0) + (e - s) * 1e-6
        return out

    def host_ms(self, names: Iterable[str], top: bool = True
                ) -> Dict[int, float]:
        """ms a frame of the host spans called ``names`` that start in
        the window (top-level ones alone with ``top``), summed over each
        frame that has one (a fetch's frame is the one after the step it
        waits for)."""
        names = set(names)
        out: Dict[int, float] = {}
        for n, f, up, s, e, _ in self.rec["host"]:
            if (n in names and self.t0 <= s <= self.t1
                    and (up < 0 or not top)):
                out[f] = out.get(f, 0.0) + (e - s) * 1e-6
        return out

    def _clip(self, intervals) -> List[Tuple[int, int]]:
        return [(max(s, self.t0), min(e, self.t1)) for s, e in intervals
                if e > self.t0 and s < self.t1]

    def quiet_ns(self) -> int:
        return _union(self._clip(self.rec.get("quiet", [])))[0]

    def gaps(self) -> List[Tuple[int, int, str]]:
        """``(start, end, host span)`` of every stretch of the window that
        no device span and no quiet stretch covers, each given to the
        innermost host span open at its midpoint (``"host"`` where none
        is)."""
        iv = self._clip([(s, e) for _, _, _, s, e, _ in self.rec["device"]]
                        + list(self.rec.get("quiet", [])))
        _, gaps = _union(iv + [(self.t0, self.t0), (self.t1, self.t1)])
        host = sorted((s, e, n) for n, _, _, s, e, _ in self.rec["host"]
                      if e >= self.t0 and s <= self.t1)
        starts = [h[0] for h in host]
        longest = max((e - s for s, e, _ in host), default=0)
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            inner = []
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and host[i][0] >= mid - longest:
                hs, he, n = host[i]
                if he >= mid:
                    inner.append((he - hs, n))
                i -= 1
            out.append((s, e, min(inner)[1] if inner else "host"))
        return out

    def idle_share(self) -> float:
        """Share of the window, quiet stretches left out, in gaps."""
        idle = sum(e - s for s, e, _ in self.gaps())
        return idle / (self.t1 - self.t0 - self.quiet_ns())


def window(run) -> Optional[Window]:
    """The window of the run's record, or ``None`` without a record or a
    frame in it."""
    rec = getattr(run, "program", None)
    ctx = getattr(run, "ctx", None)
    if not rec or ctx is None:
        return None
    t0 = int((ctx.t_process + ctx.setup_s) * 1e9)
    ends = [e for n, _, up, _, e, _ in rec["host"]
            if n == "fetch" and up < 0 and e > t0]
    if not ends:
        return None
    t1 = max(ends)
    frames = {f for n, f, up, s, _, _ in rec["host"]
              if n in FRAME_STEPS and up < 0 and t0 <= s <= t1}
    if not frames:
        return None
    return Window(rec, t0, t1, frames)


def _median(per_frame: Dict[int, float]) -> Optional[float]:
    return statistics.median(per_frame.values()) if per_frame else None


def device_median_ms(run, names: Iterable[str], in_graph: Optional[bool]
                     ) -> Optional[float]:
    """Median over the window's frames of the frame's device ms in
    ``names``."""
    w = window(run)
    return None if w is None else _median(w.device_ms(names, in_graph))


def host_median_ms(run, names: Iterable[str]) -> Optional[float]:
    """Median over the window's frames of the frame's host ms in the
    top-level spans ``names``."""
    w = window(run)
    return None if w is None else _median(w.host_ms(names))


def idle_share(run) -> Optional[float]:
    """% of the window that no device span covers."""
    w = window(run)
    if w is None or not w.rec["device"]:
        return None
    return 100.0 * w.idle_share()


def idle_ms_in(run, names: Iterable[str]) -> Optional[float]:
    """Device idle ms a frame whose gaps fall to a host span in
    ``names``."""
    w = window(run)
    if w is None or not w.rec["device"]:
        return None
    names = set(names)
    idle = sum(e - s for s, e, n in w.gaps() if n in names)
    return idle * 1e-6 / len(w.frames)


def longest_gaps(run, n: int = 10) -> Optional[List[Tuple[str, float]]]:
    """The ``n`` longest device gaps of the window: ``(host span, ms)``."""
    w = window(run)
    if w is None or not w.rec["device"]:
        return None
    gaps = sorted(w.gaps(), key=lambda g: g[0] - g[1])[:n]
    return [(name, (e - s) * 1e-6) for s, e, name in gaps]


def count_per_frame(run, name: str) -> Optional[float]:
    """The counter ``name``'s growth a frame over the window: from the last
    reading at or before its start to the last inside it."""
    w = window(run)
    if w is None:
        return None
    got = sorted((t, f, v) for n, f, v, t in w.rec["counts"]
                 if n == name and t <= w.t1)
    before = [g for g in got if g[0] <= w.t0]
    inside = [g for g in got if g[0] > w.t0]
    if not inside:
        return None
    _, f0, v0 = before[-1] if before else inside[0]
    _, f1, v1 = inside[-1]
    return (v1 - v0) / (f1 - f0) if f1 > f0 else None
