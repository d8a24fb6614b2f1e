"""Host-side runtime: typed channels, latest-value slots, rate watchdog
(the port's copy of ``liodom_tpu/runtime/channels.py``).

Parity with the reference's shared runtime layer (SURVEY.md L1):

* :class:`Channel` — the FIFO the two pipeline stages exchange clouds
  through (``SharedData::push/popPointCloud`` / ``push/popFeatures``,
  shared_data.cc:37-89).  Unlike the reference's unbounded queue this one is
  **bounded** and blocking (backpressure instead of silent memory growth),
  and pops block on a condition variable instead of the reference's 2 ms
  poll loops (feature_extractor.cc:80, laser_odometry.cc:270).
* :class:`LatestValue` — latest-value slots for the received local map and
  IMU orientation (``set/getLocalMap``, ``set/getLastIMUOri``,
  shared_data.cc:91-117).
* :class:`FrequencyMonitor` — the output-rate watchdog: 5-sample moving
  average of input and output frequency, warn when output < 0.8x input
  (laser_odometry.cc:83-90, 239-256).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Deque, Generic, Optional, TypeVar

from liodom_tpu_torch.runtime import tracer

T = TypeVar("T")

log = logging.getLogger("liodom_tpu_torch")


class Closed(Exception):
    """Channel was closed and drained."""


class Channel(Generic[T]):
    """Bounded blocking FIFO between pipeline stages."""

    def __init__(self, maxsize: int = 8):
        self._q: Deque[T] = collections.deque()
        # a 0/negative size would make offer_latest pop an empty deque;
        # the smallest meaningful channel is the reference's queue of 1
        self._maxsize = max(int(maxsize), 1)
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._closed = False
        self.dropped = 0    # items evicted by offer_latest (counted loss)

    def push(self, item: T, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(self._q) >= self._maxsize and not self._closed:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._not_full.wait(rem)
            if self._closed:
                raise Closed()
            self._q.append(item)
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> T:
        with self._not_empty:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._q:
                if self._closed:
                    raise Closed()
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise TimeoutError()
                self._not_empty.wait(rem)
            item = self._q.popleft()
            self._not_full.notify()
            return item

    def offer_latest(self, item: T) -> int:
        """Non-blocking push with the ROS-subscriber drop-oldest semantics
        the reference deploys with (liodom_node.cc:98-103 subscribes the
        point-cloud topic with queue size 1): when the consumer lags, the
        OLDEST queued frame is evicted and the newest kept.  Evictions are
        counted in :attr:`dropped` — loss is the deployment's backpressure
        policy, but it is never silent.  Returns the number evicted."""
        with self._mu:
            if self._closed:
                raise Closed()
            n = 0
            while len(self._q) >= self._maxsize:
                self._q.popleft()
                n += 1
            self._q.append(item)
            self.dropped += n
            if n:
                tracer.count("channel.dropped", n)
            self._not_empty.notify()
            return n

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._mu:
            return len(self._q)


class LatestValue(Generic[T]):
    """Thread-safe latest-value slot (shared_data.cc:91-117)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._val: Optional[T] = None

    def set(self, v: T) -> None:
        with self._mu:
            self._val = v

    def get(self) -> Optional[T]:
        with self._mu:
            return self._val

    def take(self) -> Optional[T]:
        """Get and clear — the reference clears the local map after merging
        it? (it does not; it re-reads the latest each frame).  Provided for
        consumers that want move semantics."""
        with self._mu:
            v, self._val = self._val, None
            return v


class FrequencyMonitor:
    """Output-vs-input rate watchdog (laser_odometry.cc:83-90, 239-256).

    Both trackers are primed with ``prime_hz`` x ``window`` samples like the
    reference's constructor priming to 20 Hz."""

    def __init__(self, window: int = 5, prime_hz: float = 20.0,
                 ratio: float = 0.8):
        self.window = window
        self.ratio = ratio
        self._in: Deque[float] = collections.deque(
            [prime_hz] * window, maxlen=window)
        self._out: Deque[float] = collections.deque(
            [prime_hz] * window, maxlen=window)
        self._last_in: Optional[float] = None
        self._last_out: Optional[float] = None

    def tick_input(self, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        if self._last_in is not None and t > self._last_in:
            self._in.append(1.0 / (t - self._last_in))
        self._last_in = t

    def tick_output(self, t: Optional[float] = None) -> Optional[str]:
        """Record an output; returns a warning string when lagging."""
        t = time.monotonic() if t is None else t
        if self._last_out is not None and t > self._last_out:
            self._out.append(1.0 / (t - self._last_out))
        self._last_out = t
        if self.output_hz() < self.ratio * self.input_hz():
            msg = (f"odometry output {self.output_hz():.1f} Hz < "
                   f"{self.ratio:.0%} of input {self.input_hz():.1f} Hz")
            log.warning(msg)
            return msg
        return None

    def input_hz(self) -> float:
        return sum(self._in) / len(self._in)

    def output_hz(self) -> float:
        return sum(self._out) / len(self._out)
