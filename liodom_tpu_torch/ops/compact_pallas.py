"""K7, local-map extraction: CUDA kernel wrapper + plain version.

Port of ``scripts/compact_pallas_experiment.py:compact_rows_pallas`` (the TPU
kernel that was measured and left unwired) together with the membership test
of ``liodom_tpu/mapping/grid.py:get_local_map``, which is what K7 serves.
The function: rows of the map whose cell key equals one of the
neighbourhood's target keys (``base + offsets``) and that are valid are
"hits"; the first ``capacity`` hits, in ascending row order, fill a
``(capacity, 3)`` buffer, the rest of it is zero, and ``n_hits`` counts every
hit.  The cut at capacity is exact, as in ``get_local_map``.

:func:`compact_hits` dispatches on the tensors' device: a CUDA tensor
launches ``csrc/local_map_compact.cu`` (a block a tile counts its hits,
finds its offset by a look-back over the tiles before and places them;
:func:`compact_hits_tiled` models its schedule) with the targets in shared
memory, or above :data:`MAX_TARGETS` of them with the targets in device
memory (:func:`compact_hits_global_cuda`, whose search is fenced: every
s-th sorted offset staged in shared memory, :func:`compact_hits_fenced`
models it); a CPU tensor takes :func:`compact_hits_plain` (membership as a
broadcast compare over chunks of rows, ranks by ``cumsum``, a scatter).
All move values and compare integers, so they are bit-exact with each
other.
Neither synchronises with the host: no ``nonzero``, no data-dependent shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from liodom_tpu_torch import kernels

THREADS = 256           # threads a block in csrc/local_map_compact.cu
ROWS_PER_THREAD = 8     # contiguous rows a thread (one 8-byte mask load)
TILE_ROWS = THREADS * ROWS_PER_THREAD   # rows a block
SMEM_LIMIT = 232448     # a block's shared memory on Hopper (227 KB)
# targets the kernel holds in shared memory, 12 bytes each beside 256
MAX_TARGETS = (SMEM_LIMIT - 256) // 12

# the models' fence: at most this many bytes of a block's shared memory,
# 12 an entry, as csrc/local_map_compact.cu's kFenceBytes (the launches
# take the built library's stride, liodom_local_map_fence)
FENCE_BYTES = 32768

# (rows x targets) compares a chunk of the plain membership
MEMBERSHIP_CHUNK = 1 << 24

_SIG = [("liodom_local_map_compact", [ctypes.c_void_p] * 5
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5),
        ("liodom_local_map_compact_global", [ctypes.c_void_p] * 5
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5),
        ("liodom_local_map_compact_shape", [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]),
        ("liodom_local_map_fence", [ctypes.c_int, ctypes.c_void_p])]


def compact_rows_plain(xyz: torch.Tensor, hit: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of the ``hit`` rows of ``xyz`` (C, 3) into
    ``capacity`` rows: ``(out (capacity, 3), out_valid (capacity,),
    n_hits () int32)``.  Rows past the hit count are zero."""
    n_hits = hit.sum(dtype=torch.int32)
    rank = torch.cumsum(hit.to(torch.int64), dim=0) - 1
    dest = torch.where(hit & (rank < capacity), rank, capacity)
    out = torch.zeros((capacity + 1, 3), dtype=xyz.dtype, device=xyz.device)
    out = out.index_copy_(0, dest, xyz)[:capacity]   # row `capacity`: dropped
    out_valid = torch.arange(capacity, device=xyz.device) < n_hits
    return out, out_valid, n_hits


def _membership(key: torch.Tensor, valid: torch.Tensor, base: torch.Tensor,
                offsets: np.ndarray, chunk: int = MEMBERSHIP_CHUNK
                ) -> torch.Tensor:
    """(C,) bool: the row is valid and its key is one of ``base + offsets``,
    compared a chunk of rows at a time so that no more than about ``chunk``
    (row, target) pairs are held at once."""
    offs = torch.as_tensor(np.asarray(offsets, np.int32), device=key.device)
    targets = base[None, :] + offs.reshape(-1, 3)            # (K, 3)
    rows = max(1, chunk // max(1, targets.shape[0]))
    hit = torch.empty(key.shape[0], dtype=torch.bool, device=key.device)
    for r0 in range(0, key.shape[0], rows):
        eq = torch.all(key[r0:r0 + rows, None, :] == targets[None, :, :],
                       dim=-1)
        hit[r0:r0 + rows] = torch.any(eq, dim=-1)
    return hit & valid


def compact_hits_plain(xyz: torch.Tensor, key: torch.Tensor,
                       valid: torch.Tensor, base: torch.Tensor,
                       offsets: np.ndarray, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's function in plain PyTorch: membership of each row's ``key``
    against ``base (3,) + offsets (K, 3)``, then :func:`compact_rows_plain`."""
    return compact_rows_plain(xyz, _membership(key, valid, base, offsets),
                              capacity)


def compact_hits_tiled(xyz: torch.Tensor, key: torch.Tensor,
                       valid: torch.Tensor, base: torch.Tensor,
                       offsets: np.ndarray, capacity: int,
                       threads: int = THREADS,
                       rows_per_thread: int = ROWS_PER_THREAD
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's schedule as torch ops, a model of ``csrc/local_map_compact.cu``
    with ``threads`` threads a block and ``rows_per_thread`` contiguous
    rows a thread: each thread counts the hits of its rows, a scan over the
    block's threads gives its offset in the tile, the look-back over the
    tiles before gives the tile's offset (their counts summed: the
    exclusive prefix), and a hit goes to the sum plus its rank among the
    thread's hits, dropped at or past ``capacity``.  Same contract as
    :func:`compact_hits_plain`."""
    c = xyz.shape[0]
    tile = threads * rows_per_thread
    tiles = max(1, -(-c // tile))
    hit = _membership(key, valid, base, offsets)
    padded = torch.zeros(tiles * tile, dtype=torch.int64, device=xyz.device)
    padded[:c] = hit.to(torch.int64)
    h = padded.reshape(tiles, threads, rows_per_thread)
    mine = h.sum(-1)                                   # a thread's count
    in_tile = torch.cumsum(mine, -1) - mine            # the block scan
    count = mine.sum(-1)                               # published, a tile
    before = torch.cumsum(count, 0) - count            # the look-back
    rank = torch.cumsum(h, -1) - h                     # among the thread's
    dst = (before[:, None, None] + in_tile[..., None] + rank).reshape(-1)[:c]
    dst = torch.where(hit & (dst < capacity), dst, capacity)
    out = torch.zeros((capacity + 1, 3), dtype=xyz.dtype, device=xyz.device)
    out = out.index_copy_(0, dst, xyz)[:capacity]
    n_hits = count.sum().to(torch.int32)
    out_valid = torch.arange(capacity, device=xyz.device) < n_hits
    return out, out_valid, n_hits


def fence_stride(n_targets: int) -> int:
    """The models' fence stride for ``n_targets`` targets: the smallest
    power of two s for which ceil(K / s) fence entries of 12 bytes fit
    :data:`FENCE_BYTES` (``csrc/local_map_compact.cu`` ``fence_shift``;
    the launches take :func:`_library_fence`'s)."""
    s = 1
    while -(-n_targets // s) * 12 > FENCE_BYTES:
        s *= 2
    return s


def _sorted_offsets(offsets: np.ndarray) -> np.ndarray:
    """(K, 3) int32 offsets sorted by (x, y, z)."""
    offs = np.asarray(offsets, np.int32).reshape(-1, 3)
    return offs[np.lexsort((offs[:, 2], offs[:, 1], offs[:, 0]))]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the card's int32 sums wrap."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _lex_below(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(t < k) in (x, y, z) order, rows of (..., 3) int32."""
    a, b, c = t.unbind(-1)
    x, y, z = k.unbind(-1)
    return (a < x) | ((a == x) & ((b < y) | ((b == y) & (c < z))))


def fenced_membership(key: torch.Tensor, valid: torch.Tensor,
                      base: torch.Tensor, offsets: np.ndarray,
                      stride: int) -> torch.Tensor:
    """(C,) bool, each row searched as the global path searches it: its key
    shifted by ``-base`` (wrapping int32), then g = the fence entries
    (every ``stride``-th sorted offset) below it by a fixed-step binary
    search, then log2 ``stride`` fixed steps among the sorted offsets from
    entry (g - 1) ``stride``, bounded only by the array's end, then the
    compare at the lower bound."""
    if stride < 1 or stride & (stride - 1):
        raise ValueError(f"fence stride {stride} is not a power of two")
    offs = torch.from_numpy(_sorted_offsets(offsets)).to(key.device)
    count = offs.shape[0]
    if count == 0:
        return torch.zeros_like(valid)
    fence = offs[::stride]
    n_f = fence.shape[0]
    k = _wrap32(key.to(torch.int64) - base.to(torch.int64)[None, :])
    g = torch.zeros(key.shape[0], dtype=torch.int64, device=key.device)
    step = 1 << (n_f.bit_length() - 1) if n_f > 0 else 0
    while step > 0:
        m = g + step - 1
        below = _lex_below(fence[torch.clamp(m, max=max(n_f - 1, 0))], k)
        g = torch.where((m < n_f) & below, g + step, g)
        step //= 2
    pos = (g - 1) * stride
    step = stride // 2
    while step > 0:
        m = pos + step
        ok = (g > 0) & (m < count)
        below = _lex_below(offs[torch.where(ok, m, 0)], k)
        pos = torch.where(ok & below, m, pos)
        step //= 2
    lb = torch.where(g > 0, pos + 1, 0)
    hit = (lb < count) & torch.all(
        offs[torch.where(lb < count, lb, 0)] == k, dim=-1)
    return hit & valid


def compact_hits_fenced(xyz: torch.Tensor, key: torch.Tensor,
                        valid: torch.Tensor, base: torch.Tensor,
                        offsets: np.ndarray, capacity: int,
                        stride: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's global path as torch ops, a model of
    ``liodom_local_map_compact_global``: membership by the fenced search
    (:func:`fenced_membership`, at ``stride``, by default the launch's
    :func:`fence_stride`), then :func:`compact_rows_plain`.  Same contract
    as :func:`compact_hits_plain`."""
    offs = np.asarray(offsets, np.int32).reshape(-1, 3)
    s = fence_stride(len(offs)) if stride is None else stride
    return compact_rows_plain(
        xyz, fenced_membership(key, valid, base, offs, s), capacity)


@functools.lru_cache(maxsize=None)
def _device_offsets(data: bytes, device: torch.device) -> torch.Tensor:
    """The (K, 3) int32 offsets of ``data`` sorted by (x, y, z), the
    order the kernel's binary search takes (adding the base keeps it), on
    ``device``: copied once per neighbourhood and device and kept for the
    life of the process (a captured CUDA graph holds their address), from
    pinned memory without waiting, so no step synchronises with the host
    for them."""
    offs = _sorted_offsets(np.frombuffer(data, np.int32))
    return _pinned_to(np.ascontiguousarray(offs), device)


def _pinned_to(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``, from pinned memory without waiting (an empty
    array by a plain copy)."""
    t = torch.from_numpy(host)
    if not host.size:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def _device_fenced_offsets(data: bytes, stride: int,
                           device: torch.device) -> torch.Tensor:
    """The global path's targets on ``device``: (3 F + 3 K,) int32, the
    fence (every ``stride``-th sorted offset, F of them) as x, y and z
    rows, then the sorted offsets as x, y and z rows; kept alike."""
    offs = _sorted_offsets(np.frombuffer(data, np.int32))
    rows = np.concatenate([offs[::stride].T.reshape(-1), offs.T.reshape(-1)])
    return _pinned_to(np.ascontiguousarray(rows, np.int32), device)


def _lookback_state(device: torch.device, tiles: int) -> torch.Tensor:
    """K7's look-back status words on ``device``: an epoch word and one word
    a tile, zeroed when first needed (or outgrown) and then left to the
    kernel, which tags each launch's words with the next epoch, so no call
    clears them.  Launches on one device must therefore be ordered (one
    stream).  An outgrown buffer is kept alive: a captured CUDA graph may
    still launch K7 on it."""
    return kernels.device_scratch("local_map_compact", device, 1 + tiles,
                                  torch.int64, floor=257, zeroed=True)


@functools.lru_cache(maxsize=None)
def _library_fence(n_targets: int) -> Tuple[int, int, int]:
    """(stride, entries, shared-memory bytes) of the global path's fence
    for ``n_targets`` targets, as the built library lays it out
    (``liodom_local_map_fence``): the stride the wrapper lays the buffer
    out at is the one the kernel searches at."""
    lib = kernels.load("local_map_compact", _SIG)
    fence = (ctypes.c_int * 3)()
    lib.liodom_local_map_fence(n_targets, fence)
    return fence[0], fence[1], fence[2]


def compact_shape(rows: int, n_targets: int) -> dict:
    """K7's launch as the built library sets it for ``rows`` rows and
    ``n_targets`` targets (CUDA only); ``fence_*`` the global path's."""
    lib = kernels.load("local_map_compact", _SIG)
    out = (ctypes.c_int * 5)()
    lib.liodom_local_map_compact_shape(rows, n_targets, out)
    fence = _library_fence(n_targets)
    return {"tiles": out[0], "threads": out[1], "rows_per_thread": out[2],
            "smem_bytes": out[3], "max_targets": out[4],
            "fence_stride": fence[0], "fence_entries": fence[1],
            "fence_smem_bytes": fence[2]}


def _checked(what, xyz, key, valid, base, offsets, capacity):
    """The launch's inputs, checked: (offsets (K, 3) int32 numpy, xyz, key,
    valid (16-byte aligned), base), contiguous."""
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    if offs.ndim != 2 or offs.shape[1] != 3:
        raise ValueError(f"{what} takes (K, 3) offsets, got {offs.shape}")
    if not all(t.is_cuda and t.device == xyz.device
               for t in (xyz, key, valid, base)):
        raise ValueError(f"{what} needs all tensors on one CUDA device")
    if (xyz.dtype != torch.float32 or key.dtype != torch.int32
            or valid.dtype != torch.bool or base.dtype != torch.int32):
        raise TypeError(f"{what} takes float32 xyz, int32 keys and base, "
                        f"and a bool mask")
    c = xyz.shape[0]
    if (xyz.shape != (c, 3) or key.shape != (c, 3) or valid.shape != (c,)
            or base.shape != (3,)):
        raise ValueError(f"{what} shapes: xyz {tuple(xyz.shape)}, key "
                         f"{tuple(key.shape)}, valid {tuple(valid.shape)}, "
                         f"base {tuple(base.shape)}")
    if capacity < 0 or c >= 2**31 or capacity >= 2**31:
        raise ValueError(f"{what}: {c} rows, capacity {capacity}")
    xyz, key, valid, base = (t.contiguous() for t in (xyz, key, valid, base))
    if valid.data_ptr() % 16:            # the kernel reads 16 rows a load
        valid = valid.clone()
    return offs, xyz, key, valid, base


def _launch(symbol, xyz, key, valid, base, offs, d_offs, capacity):
    """One launch of K7's ``symbol`` -> (out, out_valid, n_hits)."""
    dev, c = xyz.device, xyz.shape[0]
    state = _lookback_state(dev, max(1, -(-c // TILE_ROWS)))
    out = torch.empty((capacity, 3), dtype=torch.float32, device=dev)
    out_valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    lib = kernels.load("local_map_compact", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            xyz.data_ptr(), key.data_ptr(), valid.data_ptr(), base.data_ptr(),
            d_offs.data_ptr(), len(offs), c, capacity, state.data_ptr(),
            out.data_ptr(), out_valid.data_ptr(), n_hits.data_ptr(), stream)
    kernels.check(err, symbol)
    return out, out_valid, n_hits


def compact_hits_cuda(xyz: torch.Tensor, key: torch.Tensor,
                      valid: torch.Tensor, base: torch.Tensor,
                      offsets: np.ndarray, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 on CUDA tensors; same contract as
    :func:`compact_hits_plain`.  ``offsets`` (host numpy) go to the card
    once per neighbourhood and device (:func:`_device_offsets`); the
    kernel holds the targets in shared memory, at most
    :data:`MAX_TARGETS` of them; more launch
    :func:`compact_hits_global_cuda`."""
    offs, xyz, key, valid, base = _checked("compact_hits_cuda", xyz, key,
                                           valid, base, offsets, capacity)
    if len(offs) > MAX_TARGETS:
        return compact_hits_global_cuda(xyz, key, valid, base, offs,
                                        capacity)
    out = _launch("liodom_local_map_compact", xyz, key, valid, base, offs,
                  _device_offsets(offs.tobytes(), xyz.device), capacity)
    compact_hits_cuda.launches += 1
    return out


compact_hits_cuda.launches = 0


def compact_hits_global_cuda(xyz: torch.Tensor, key: torch.Tensor,
                             valid: torch.Tensor, base: torch.Tensor,
                             offsets: np.ndarray, capacity: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K7 with its targets in device memory (``liodom_local_map_compact_
    global``), any number of them; same contract as
    :func:`compact_hits_plain`.  The fence and the sorted offsets go to the
    card once per neighbourhood and device (:func:`_device_fenced_offsets`
    at the library's stride, :func:`_library_fence`) and each key is
    searched as ``key - base`` (:func:`compact_hits_fenced` models the
    search)."""
    offs, xyz, key, valid, base = _checked("compact_hits_global_cuda", xyz,
                                           key, valid, base, offsets,
                                           capacity)
    out = _launch("liodom_local_map_compact_global", xyz, key, valid, base,
                  offs, _device_fenced_offsets(
                      offs.tobytes(), _library_fence(len(offs))[0],
                      xyz.device),
                  capacity)
    compact_hits_global_cuda.launches += 1
    return out


compact_hits_global_cuda.launches = 0


def compact_hits(xyz: torch.Tensor, key: torch.Tensor, valid: torch.Tensor,
                 base: torch.Tensor, offsets: np.ndarray, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if xyz.is_cuda:
        return compact_hits_cuda(xyz, key, valid, base, offsets, capacity)
    kernels.require_cpu(xyz, "compact_hits")
    return compact_hits_plain(xyz, key, valid, base, offsets, capacity)
