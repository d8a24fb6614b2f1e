"""The traffic between the host and the card in the apps' frame loops.

* :class:`Stager` — each frame's ring image and counts, copied to the card
  from a ring of pinned host buffers with ``non_blocking=True``.  A copy
  from pageable memory (``torch.as_tensor(img, device="cuda")``) ends in a
  stream synchronisation, so the host would wait for every queued step each
  frame; the JAX apps' ``jnp.asarray`` does not wait.
* :func:`fetch_poses` — the pending poses and edge counts of a block of
  frames fetched in one device-to-host copy, so ``--sync-every`` costs one
  round trip a block and not one a frame.
* :class:`SyncAudit` — counts the host synchronisations a frame loop makes
  outside its due points (a pose fetch, a timing sample, a checkpoint).
* :func:`prepare_kernels` and :func:`prepare_loader` — build and load the
  kernels a path launches and the native loader before the first frame,
  so a cold start is not counted as a frame.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from liodom_tpu_torch import kernels
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.ops.neighbors import resolve_knn_impl
from liodom_tpu_torch.runtime import tracer

_SYNC_WARNING = "called a synchronizing"


class Stager:
    """Frames of fixed shape (an image ``(R, W, 3)`` float32 and counts
    ``(R,)`` int32) put on ``device``.

    On CUDA each frame goes through one of ``slots`` pinned host buffers: the
    frame is written into it, copied to a fresh device tensor with
    ``non_blocking=True`` and a CUDA event is recorded after the copy.  A
    slot is refilled only once its event has completed; if the host has run
    ``slots`` frames ahead of the card it waits on that event, and counts
    the wait in :attr:`waits` (torch's sync debug mode does not see an event
    wait).  On the CPU the frame is copied into a new tensor."""

    def __init__(self, image_shape: Sequence[int], device: torch.device,
                 slots: int = 4):
        self.device = device
        self.image_shape = tuple(image_shape)
        self.waits = 0
        self._next = 0
        self._slots = []
        if device.type == "cuda":
            for _ in range(max(int(slots), 2)):
                self._slots.append((
                    torch.empty(self.image_shape, dtype=torch.float32,
                                pin_memory=True),
                    torch.empty(self.image_shape[:1], dtype=torch.int32,
                                pin_memory=True),
                    torch.cuda.Event()))

    def put(self, img: np.ndarray, counts: np.ndarray
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(image, counts)`` on the device, without a host
        synchronisation unless the host is ``slots`` frames ahead.  Spans
        ``stage.put`` and, on the card, ``stage.copy``; a wait is counted
        as ``stage.waits`` too."""
        with tracer.span("stage.put"):
            img = np.asarray(img, np.float32).reshape(self.image_shape)
            counts = np.asarray(counts, np.int32).reshape(
                self.image_shape[:1])
            if not self._slots:
                return torch.tensor(img), torch.tensor(counts)
            h_img, h_cnt, done = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            if not done.query():            # an unrecorded event reads done
                self.waits += 1
                tracer.count("stage.waits", 1)
                done.synchronize()
            h_img.numpy()[...] = img
            h_cnt.numpy()[...] = counts
            d_img = torch.empty(self.image_shape, dtype=torch.float32,
                                device=self.device)
            d_cnt = torch.empty(self.image_shape[:1], dtype=torch.int32,
                                device=self.device)
            with tracer.span("stage.copy", device=True):
                d_img.copy_(h_img, non_blocking=True)
                d_cnt.copy_(h_cnt, non_blocking=True)
            done.record()
            return d_img, d_cnt


def staging_slots(chunk: int, due_every: Sequence[int],
                  ahead: bool) -> int:
    """The pinned buffers a frame loop stages through: two dispatches and
    two spare.  With ``ahead`` (a captured step, ``--aot``: the host
    outruns the card) also every frame between two due points, each of
    which drains the queue (``due_every``: the loop's cadences in frames,
    0 for one it does not keep), so the ring never makes the host wait."""
    slots = 2 * chunk + 2
    gaps = [d for d in due_every if d > 0]
    if ahead and gaps:
        slots = max(slots, min(gaps) + chunk + 1)
    return slots


def fetch_poses(pending: List[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The pending frames' poses and edge counts on the host.

    ``pending``: ``(q, t, n_edges)`` per dispatch, a frame (``(4,)``,
    ``(3,)``, ``()``) or a chunk (a leading frame axis).  The matrices are
    made on the device in the poses' float32, as the JAX apps'
    ``np.asarray(pose.matrix(), np.float64)``, and come back with the edge
    counts (exact in float32: at most 2^24) in one copy.  Returns
    ``((F, 4, 4) float64, (F,) int64)``.

    Spans ``fetch`` and, on the card, ``fetch.copy``; the host has then
    waited for the card, so the span recorder anchors its clock here
    (``runtime/tracer.anchor``)."""
    with tracer.span("fetch"):
        with tracer.span("fetch.copy", device=True):
            q = torch.cat([p[0].reshape(-1, 4) for p in pending])
            t = torch.cat([p[1].reshape(-1, 3) for p in pending])
            ne = torch.cat([p[2].reshape(-1) for p in pending])
            mats = Pose(q, t).matrix().reshape(-1, 16)
            block = torch.cat([mats, ne[:, None].to(mats.dtype)],
                              dim=1).cpu().numpy()
        tracer.anchor()
    return (block[:, :16].reshape(-1, 4, 4).astype(np.float64),
            block[:, 16].astype(np.int64))


class SyncAudit:
    """Counts the host synchronisations a frame loop makes between its due
    points.

    On CUDA, inside ``with audit:`` torch's sync debug mode is ``"warn"``
    and every call that makes the host wait for the card warns; the
    warnings of every thread are caught and counted into :attr:`count`
    (the first kept in :attr:`first`, a thread's own in :attr:`by_thread`),
    other warnings are re-issued.  A due point — a pose fetch, a timing
    sample, a checkpoint, a mapper thread's read of its overflow count —
    runs under :meth:`allowed`: its synchronisations are counted in
    :attr:`due` and not in :attr:`count`.  The mode is process-wide, so a
    due point of one thread neither hides nor is charged with another
    thread's synchronisations: each warning is judged by the thread that
    raised it.  On the CPU there is nothing to count."""

    def __init__(self, device: torch.device):
        self.enabled = device.type == "cuda"
        self.count = 0
        self.due = 0
        self.by_thread: dict = {}
        self.first: Optional[str] = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self._catch = None
        self._show = None
        self._mode = 0

    def __enter__(self):
        if self.enabled:
            self._catch = warnings.catch_warnings()
            self._catch.__enter__()
            warnings.simplefilter("always")
            self._show = warnings.showwarning
            warnings.showwarning = self._record
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._catch.__exit__(*exc)
        return False

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if _SYNC_WARNING not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        with self._lock:
            if getattr(self._local, "due", 0):
                self.due += 1
                return
            name = threading.current_thread().name
            self.count += 1
            self.by_thread[name] = self.by_thread.get(name, 0) + 1
            self.first = self.first or f"{name}: {message}"

    @contextlib.contextmanager
    def allowed(self):
        """A due point of the calling thread: it may wait for the card
        here."""
        self._local.due = getattr(self._local, "due", 0) + 1
        try:
            yield
        finally:
            self._local.due -= 1


def path_kernels(mapping: bool, sharded: bool = False) -> Tuple[str, ...]:
    """The kernel sources an image step launches: K1, K2, the kNN (K3 or
    K4, or K6 under ``LIODOM_KNN_IMPL=pallas_lines``; K5 on the sharded
    steps of ``parallel/``, whatever the setting) and the LM solve (not on
    the sharded steps, whose solve all-reduces between rounds and stays
    plain), and with the map K7, the probe kernel and the map fold."""
    if sharded:
        step = ("knn_index",)
    elif resolve_knn_impl() == "pallas_lines":
        step = ("knn_lines", "lm_solve")
    else:
        step = ("knn_coords", "lm_solve")
    return ("smoothness", "select") + step + (
        ("local_map_compact", "probe_insert", "map_fold") if mapping else ())


def prepare_kernels(names: Sequence[str], device: torch.device) -> dict:
    """On CUDA, build every named source that has no library yet (one
    ``nvcc`` a source, all started together) and load each library, before
    the first frame, and print the seconds on a line of their own.  Returns
    ``{"kernel_build_s", "kernel_build": "cold" or "warm", "compiled":
    [...], "kernels": [...]}`` (cold when any source was compiled); on the
    CPU, where the plain versions need no build, ``{}``."""
    if device.type != "cuda":
        return {}
    t0 = time.perf_counter()
    compiled = sorted(kernels.build_all(names))
    for name in names:
        kernels.load(name)
    out = {"kernel_build_s": time.perf_counter() - t0,
           "kernel_build": "cold" if compiled else "warm",
           "compiled": compiled, "kernels": list(names)}
    print(f"kernels {', '.join(names)}: built and loaded in "
          f"{out['kernel_build_s']:.2f} s ({out['kernel_build']})")
    return out


def prepare_loader() -> dict:
    """Build (g++, at first use) and load the native loader before the
    first frame, and print the seconds.  Returns ``{"native_loader": built
    and loaded, "native_loader_s": seconds}``; without a toolchain the
    loader's NumPy fallbacks serve."""
    from liodom_tpu_torch.runtime import native
    t0 = time.perf_counter()
    ok = native.native_available()
    out = {"native_loader": ok, "native_loader_s": time.perf_counter() - t0}
    print("native loader: " + ("built and loaded" if ok
                               else "unavailable (NumPy fallback)")
          + f" in {out['native_loader_s']:.2f} s")
    return out


def device_name(device: torch.device) -> str:
    """The name a report gives the device: the card's, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
