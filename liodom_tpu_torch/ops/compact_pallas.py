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
launches ``csrc/local_map_compact.cu`` (membership fused into a counting
pass, then a placing pass), a CPU tensor takes :func:`compact_hits_plain`
(membership as a broadcast compare, ranks by ``cumsum``, a scatter).  Both
move values and compare integers, so they are bit-exact with each other.
Neither synchronises with the host: no ``nonzero``, no data-dependent shape.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from liodom_tpu_torch import kernels

TILE_ROWS = 4096      # rows per block in csrc/local_map_compact.cu
MAX_TARGETS = 128     # target keys the kernel takes by value

_SIG = [("liodom_local_map_compact", [ctypes.c_void_p] * 5
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)]


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


def compact_hits_plain(xyz: torch.Tensor, key: torch.Tensor,
                       valid: torch.Tensor, base: torch.Tensor,
                       offsets: np.ndarray, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's function in plain PyTorch: membership of each row's ``key``
    against ``base (3,) + offsets (K, 3)``, then :func:`compact_rows_plain`."""
    offs = torch.as_tensor(np.asarray(offsets, np.int32), device=key.device)
    targets = base[None, :] + offs                           # (K, 3)
    eq = torch.all(key[:, None, :] == targets[None, :, :], dim=-1)
    hit = torch.any(eq, dim=-1) & valid
    return compact_rows_plain(xyz, hit, capacity)


def compact_hits_cuda(xyz: torch.Tensor, key: torch.Tensor,
                      valid: torch.Tensor, base: torch.Tensor,
                      offsets: np.ndarray, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 on CUDA tensors; same contract as
    :func:`compact_hits_plain`.  ``offsets`` stays on the host: the kernel
    takes the target offsets by value, so no copy to the card is made."""
    if not all(t.is_cuda and t.device == xyz.device
               for t in (key, valid, base)):
        raise ValueError("compact_hits_cuda needs all tensors on one CUDA "
                         "device")
    if (xyz.dtype != torch.float32 or key.dtype != torch.int32
            or valid.dtype != torch.bool or base.dtype != torch.int32):
        raise TypeError("compact_hits_cuda takes float32 xyz, int32 keys and "
                        "base, and a bool mask")
    c = xyz.shape[0]
    if (xyz.shape != (c, 3) or key.shape != (c, 3) or valid.shape != (c,)
            or base.shape != (3,)):
        raise ValueError(f"compact_hits_cuda shapes: xyz {tuple(xyz.shape)}, "
                         f"key {tuple(key.shape)}, valid "
                         f"{tuple(valid.shape)}, base {tuple(base.shape)}")
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    if offs.ndim != 2 or offs.shape[1] != 3 or len(offs) > MAX_TARGETS:
        raise ValueError(f"compact_hits_cuda takes at most {MAX_TARGETS} "
                         f"(dx, dy, dz) offsets, got {offs.shape}")
    if capacity < 0 or c >= 2**31 or capacity >= 2**31:
        raise ValueError(f"compact_hits_cuda: {c} rows, capacity {capacity}")
    xyz, key, valid, base = (t.contiguous() for t in (xyz, key, valid, base))
    dev = xyz.device
    n_blocks = max(1, -(-c // TILE_ROWS))
    hit = torch.empty(c, dtype=torch.uint8, device=dev)
    block_count = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    out = torch.empty((capacity, 3), dtype=torch.float32, device=dev)
    out_valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    lib = kernels.load("local_map_compact", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_local_map_compact(
            xyz.data_ptr(), key.data_ptr(), valid.data_ptr(), base.data_ptr(),
            offs.ctypes.data, len(offs), c, capacity, hit.data_ptr(),
            block_count.data_ptr(), out.data_ptr(), out_valid.data_ptr(),
            n_hits.data_ptr(), stream)
    kernels.check(err, "liodom_local_map_compact")
    compact_hits_cuda.launches += 1
    return out, out_valid, n_hits


compact_hits_cuda.launches = 0


def compact_hits(xyz: torch.Tensor, key: torch.Tensor, valid: torch.Tensor,
                 base: torch.Tensor, offsets: np.ndarray, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if xyz.is_cuda:
        return compact_hits_cuda(xyz, key, valid, base, offsets, capacity)
    kernels.require_cpu(xyz, "compact_hits")
    return compact_hits_plain(xyz, key, valid, base, offsets, capacity)
