"""The program's own spans and counters, on the host clock and the card's.

One :data:`RECORDER` a process, off until :func:`arm`.  While it is off,
:func:`span` returns one shared null context and :func:`count` returns at
once: one attribute check each, no event, no tensor, no graph node, so a
step captured while it is off is the graph it always was.

While it is on:

* :func:`span` keeps a host span: its name, its start and end on
  ``time.perf_counter_ns``, its parent and its frame, the number of frame
  steps (a top-level ``step`` or ``aot.replay`` span) that ended before
  it.  A span opened with ``device=True`` also records two CUDA timing
  events on the current stream: in eager code from a pool; under stream
  capture ``external=True`` events, which become event nodes of the graph
  and are recorded anew by every replay.  Under capture no host span is
  kept: capture time is no frame's time.
* :func:`count` adds a host int, or a tensor into a zero-dimensional int64
  accumulator on the tensor's device (no host sync; under capture the add
  is a node of the graph, so every replay adds).
* :func:`anchor`, called where the host has already waited for the card
  (``device_io.fetch_poses``), records one more event, waits for it and
  reads the host clock.  Every pending event then resolves to host time as
  ``t_anchor - event.elapsed_time(anchor)``; the error is the anchor
  wait's latency, shared by the block.  A captured graph's spans are read
  there, from its last replay since the previous anchor (the next replay
  records its events anew): one sample of its layer split a block.  Each
  counter's running total is read there too.  The eager events, a few a
  frame, are resolved later, :data:`RESOLVE_PER_FRAME` spans each time a
  frame step has been dispatched, while the card has work: resolved at the
  anchor they would keep the card idle while the host reads them.

While a ``torch.profiler`` runs the recorder records nothing (it still
counts frames), so its events never become profiler events.  :func:`snapshot` returns the record
as plain data, :func:`idle_gaps` the stretches of it that no device span
covers, :func:`write_chrome` a Chrome trace of it (:func:`exported`: for
the length of a block, as the apps' ``--trace-out`` does).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from liodom_tpu_torch.core.device import resolve_device

FRAME_STEPS = ("step", "aot.replay")     # a top-level one ends a frame
RESOLVE_PER_FRAME = 32                   # eager spans resolved a frame step
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    """One open span; its host record is the list ``[name, frame, parent
    record, t0, t1, thread]``."""

    __slots__ = ("rec", "name", "device", "host", "events", "frame",
                 "captured", "parent")

    def __init__(self, rec: "Recorder", name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        self.frame = rec.frame
        self.host = self.events = None
        stack.append(self)
        if _profiling():        # kept on the stack alone: frames still count
            self.captured = False
            if rec._quiet_from is None:
                rec._quiet_from = time.perf_counter_ns()
            return self
        if rec._quiet_from is not None:
            rec._quiet.append((rec._quiet_from, time.perf_counter_ns()))
            rec._quiet_from = None
        self.captured = rec._cuda and torch.cuda.is_current_stream_capturing()
        if not self.captured:
            up = self.parent.host if self.parent is not None else None
            self.host = [self.name, self.frame, up, time.perf_counter_ns(), 0,
                         threading.get_ident()]
            rec._host.append(self.host)
        if self.device and rec._cuda:
            if self.captured:
                self.events = (torch.cuda.Event(enable_timing=True,
                                                external=True),
                               torch.cuda.Event(enable_timing=True,
                                                external=True))
            else:
                self.events = (rec._event(), rec._event())
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.events is not None:
            self.events[1].record()
            up = self.parent.name if self.parent is not None else ""
            if self.captured:
                rec._captured.append((self.name, up) + self.events)
            else:
                rec._pending.append((self.name, self.frame, up)
                                    + self.events)
        stack = rec._stack()
        stack.pop()
        if self.host is not None:
            self.host[4] = time.perf_counter_ns()
        if not stack and not self.captured and self.name in FRAME_STEPS:
            rec.frame += 1
            if self.host is not None and rec._due:
                rec._resolve(RESOLVE_PER_FRAME)
        return False


class Recorder:
    """Spans and counters in memory while :attr:`on` (module docstring)."""

    def __init__(self):
        self.on = False
        self._cuda = False
        self._local = threading.local()
        self._reset()

    def _reset(self) -> None:
        self.frame = 0
        self._host: List[list] = []
        self._device: List[tuple] = []
        self._counts: List[tuple] = []
        self._anchors: List[tuple] = []
        self._pending: List[tuple] = []      # eager events since the anchor
        self._due: List[list] = []           # [anchor, t, spans] to resolve
        self._captured: List[tuple] = []     # spans of the capture under way
        self._replays: Dict[int, tuple] = {}  # graph: (frame, its spans)
        self._pool: List[torch.cuda.Event] = []
        self._acc: Dict[str, torch.Tensor] = {}
        self._host_counts: Dict[str, int] = {}
        self._quiet: List[tuple] = []        # stretches under the profiler
        self._quiet_from: Optional[int] = None

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _event(self) -> torch.cuda.Event:
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def arm(self, device=None) -> None:
        """Start recording afresh.  Device spans are recorded when
        ``device`` (CUDA unless named, as every entry point) is a card."""
        dev = resolve_device(device)
        self._reset()
        self._cuda = dev.type == "cuda"
        self.on = True

    def disarm(self) -> None:
        """Stop recording; the record stays for :meth:`snapshot`."""
        self.on = False

    def span(self, name: str, device: bool = False):
        """A context manager timing ``name`` (module docstring)."""
        if not self.on:
            return _NULL
        return _Span(self, name, device)

    def count(self, name: str, value) -> None:
        """Add ``value``, a host int or a tensor of one element, to the
        counter ``name``."""
        if not self.on or _profiling():
            return
        if not isinstance(value, torch.Tensor):
            self._host_counts[name] = self._host_counts.get(name, 0) + \
                int(value)
            return
        acc = self._acc.get(name)
        if acc is None:
            if self._cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"counter {name!r} first met under "
                                   "stream capture: count it in a warm "
                                   "call first")
            acc = self._acc[name] = torch.zeros((), dtype=torch.int64,
                                                device=value.device)
        acc.add_(value.reshape(()))

    def take_captured(self) -> tuple:
        """The device spans recorded under the capture that just ended
        (``runtime/aot``), to be handed to :meth:`replayed`."""
        out, self._captured = tuple(self._captured), []
        return out

    def replayed(self, spans: tuple) -> None:
        """A graph whose spans are ``spans`` was just replayed."""
        if not self.on or not spans:
            return
        if _profiling():
            # its events are recorded anew, unseen: the last note is stale
            self._replays.pop(id(spans), None)
            return
        self._replays[id(spans)] = (self.frame, spans)

    def anchor(self) -> None:
        """Resolve the pending device events and read the counters, once
        the host has waited for the card (module docstring)."""
        if not self.on or _profiling():
            return
        mark = None
        if self._cuda:
            mark = self._event()
            mark.record()
            mark.synchronize()
        t = time.perf_counter_ns()
        for frame, spans in self._replays.values():
            for name, up, s, e in spans:
                got = _resolve(s, e, mark, t)
                if got is not None:
                    self._device.append((name, frame, up) + got + (True,))
        self._replays.clear()
        if self._pending:
            self._due.append([mark, t, self._pending])
            self._pending = []
        elif mark is not None:
            self._pool.append(mark)
        totals = dict(self._host_counts)
        if self._acc:
            names = list(self._acc)
            values = torch.stack([self._acc[n] for n in names]).tolist()
            totals.update(zip(names, values))
        for name, total in totals.items():
            self._counts.append((name, self.frame, int(total), t))
        self._anchors.append((self.frame, t))

    def _resolve(self, limit: Optional[int] = None) -> None:
        """Resolve up to ``limit`` (all by default) of the eager spans
        that anchors have passed, oldest first; their events go back to
        the pool."""
        while self._due and (limit is None or limit > 0):
            mark, t, spans = self._due[0]
            n = len(spans) if limit is None else min(limit, len(spans))
            keep = []
            for name, frame, up, s, e in spans[:n]:
                got = _resolve(s, e, mark, t)
                if got is None:        # not done at the anchor: the next
                    keep.append((name, frame, up, s, e))
                    continue
                self._device.append((name, frame, up) + got + (False,))
                self._pool += [s, e]
            self._pending[:0] = keep
            del spans[:n]
            if limit is not None:
                limit -= n
            if not spans:
                self._due.pop(0)
                if mark is not None:
                    self._pool.append(mark)

    def snapshot(self) -> dict:
        """The record as plain data, times in host ns:

        * ``host``: ``(name, frame, parent index or -1, t0, t1, thread)``
          of every ended host span;
        * ``device``: ``(name, frame, parent name, t0, t1, in_graph)`` of
          every resolved device span;
        * ``counts``: ``(name, frame, running total, t)`` at each anchor;
        * ``anchors``: ``(frame, t)``;
        * ``quiet``: ``(t0, t1)`` of each stretch under ``torch.profiler``,
          in which nothing was recorded (from its first span to the first
          span after it)."""
        self._resolve()
        index = {id(h): i for i, h in enumerate(self._host)}
        host = [(n, f, index.get(id(up), -1) if up is not None else -1,
                 t0, t1, th) for n, f, up, t0, t1, th in self._host]
        return {"host": [h for h in host if h[4]],
                "device": list(self._device),
                "counts": list(self._counts),
                "anchors": list(self._anchors),
                "quiet": list(self._quiet) + (
                    [] if self._quiet_from is None
                    else [(self._quiet_from, time.perf_counter_ns())])}


def _resolve(start, end, mark, t: int) -> Optional[Tuple[int, int]]:
    """The host times of two events from the anchor ``mark`` read at host
    time ``t``; ``None`` for an event not done (another stream's)."""
    try:
        return (t - int(round(start.elapsed_time(mark) * 1e6)),
                t - int(round(end.elapsed_time(mark) * 1e6)))
    except RuntimeError:
        return None


def union(intervals: Sequence[Tuple[int, int]]
          ) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of ``[start, end)`` intervals and the gaps
    between its pieces."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
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


def idle_gaps(record: dict, t0: Optional[int] = None,
              t1: Optional[int] = None) -> List[Tuple[int, int, str]]:
    """``(start, end, host span)`` of each stretch of ``[t0, t1]`` (the
    whole record by default) that no device span covers, attributed to the
    innermost host span open at its midpoint (``"host"`` where none is)."""
    dev = [(s, e) for _, _, _, s, e, _ in record["device"]]
    if not dev:
        return []
    t0 = min(s for s, _ in dev) if t0 is None else t0
    t1 = max(e for _, e in dev) if t1 is None else t1
    clipped = [(max(s, t0), min(e, t1)) for s, e in dev if e > t0 and s < t1]
    _, gaps = union(clipped + [(t0, t0), (t1, t1)])
    host = sorted((h[3], h[4], h[0]) for h in record["host"])
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


def write_chrome(path: str, record: dict) -> None:
    """The record as a Chrome trace (chrome://tracing, Perfetto): a track
    of host spans a thread, one of eager device spans, one of in-graph
    device spans, one of device idle gaps named by the host span open in
    them, and the counters; one clock, in µs from the first event."""
    host, dev = record["host"], record["device"]
    times = [h[3] for h in host] + [d[3] for d in dev] + [
        a[1] for a in record["anchors"]]
    base = min(times) if times else 0

    def us(t: int) -> float:
        return (t - base) / 1e3

    threads = sorted({h[5] for h in host})
    tid = {th: i for i, th in enumerate(threads)}
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "host"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "device"}}]
    ev += [{"ph": "M", "name": "thread_name", "pid": 1, "tid": i,
            "args": {"name": f"thread {th}"}} for th, i in tid.items()]
    ev += [{"ph": "M", "name": "thread_name", "pid": 2, "tid": i,
            "args": {"name": n}}
           for i, n in enumerate(("spans", "graph spans", "idle"))]
    for name, frame, _, t0, t1, th in host:
        ev.append({"ph": "X", "name": name, "pid": 1, "tid": tid[th],
                   "ts": us(t0), "dur": (t1 - t0) / 1e3,
                   "args": {"frame": frame}})
    for name, frame, _, t0, t1, graph in dev:
        ev.append({"ph": "X", "name": name, "pid": 2, "tid": int(graph),
                   "ts": us(t0), "dur": (t1 - t0) / 1e3,
                   "args": {"frame": frame}})
    eager = {**record, "device": [d for d in dev if not d[5]]}
    for s, e, name in idle_gaps(eager):
        ev.append({"ph": "X", "name": name, "pid": 2, "tid": 2,
                   "ts": us(s), "dur": (e - s) / 1e3})
    for name, frame, total, t in record["counts"]:
        ev.append({"ph": "C", "name": name, "pid": 1, "ts": us(t),
                   "args": {name: total}})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def exported(path: str, device=None):
    """The recorder armed for the block (:meth:`Recorder.arm`), its record
    written to ``path`` as a Chrome trace at the end, an error's too."""
    RECORDER.arm(device)
    try:
        yield
    finally:
        RECORDER.disarm()
        write_chrome(path, RECORDER.snapshot())


RECORDER = Recorder()
arm = RECORDER.arm
disarm = RECORDER.disarm
span = RECORDER.span
count = RECORDER.count
anchor = RECORDER.anchor
snapshot = RECORDER.snapshot
