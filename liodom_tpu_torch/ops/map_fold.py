"""The map update's fold: CUDA kernel wrapper.

The second half of ``mapping/grid.py:update_map``: a frame's points, found
or inserted in the table by the probe (``ops/probe_insert.py``), folded into
the centroids of the slots they hit, the slots they claimed stamped with
their cell key and marked valid, and the dropped points counted.  The JAX
package has no TPU kernel for it (XLA ops).  On CUDA it is one launch of
``csrc/map_fold.cu`` (a stable radix sort of the frame's rows by slot in
shared memory, then, over a cluster of up to 16 blocks, one thread a slot
adding its rows in row order); its plain PyTorch version, which CPU
tensors take, is ``grid._sparse_fold``, and the two are bit-exact with
each other.  Every pass is frame-sized except the
three copies of the state that the result starts from.
"""

from __future__ import annotations

from typing import Tuple

import torch

from liodom_tpu_torch import kernels

# The most rows a launch takes: csrc/map_fold.cu's kBlockRows * kMaxCluster
# (12,288 rows a sorting block, 16 blocks), which its entry point refuses
# past and map_fold_shape reports as ``max_rows``.
MAX_ROWS = 12288 * 16


def map_fold_shape(e: int) -> dict:
    """The fold kernel's launch for ``e`` rows as the built library reports
    it (CUDA only): blocks of its one cluster, of them the blocks that sort
    the rows, threads a block, rows a sorting block, a block's dynamic
    shared memory in bytes, the most rows a launch takes."""
    out = kernels.query("map_fold", "liodom_map_fold_shape", e, size=6)
    return {"cluster_blocks": out[0], "sort_blocks": out[1],
            "threads": out[2], "rows_per_block": out[3],
            "smem_bytes": out[4], "max_rows": out[5]}


def map_fold_cuda(xyz: torch.Tensor, key: torch.Tensor, valid: torch.Tensor,
                  overflow: torch.Tensor, pts: torch.Tensor,
                  pts_valid: torch.Tensor, slot: torch.Tensor,
                  claimed: torch.Tensor, failed: torch.Tensor,
                  voxel_xysize: float, voxel_zsize: float,
                  with_folded: bool = False) -> Tuple[torch.Tensor, ...]:
    """The fold as one launch of ``csrc/map_fold.cu`` on CUDA tensors.

    ``xyz`` (C, 3), ``key`` (C, 3) int32, ``valid`` (C,), ``overflow`` ()
    int32: the stored state; ``pts`` (E, 3) the frame in the world frame,
    ``pts_valid`` (E,); ``slot`` (E,) int32, ``claimed`` and ``failed``
    (E,): the probe's result.  Returns the new ``(xyz, key, valid,
    overflow)``, copies of the state with the frame's slots rewritten, and
    with ``with_folded`` the slots folded (() int32) after them.  The
    inputs are left untouched."""
    dev = xyz.device
    ts = (xyz, key, valid, overflow, pts, pts_valid, slot, claimed, failed)
    if not (xyz.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError("map_fold_cuda needs all tensors on one CUDA device")
    if (xyz.dtype != torch.float32 or pts.dtype != torch.float32
            or key.dtype != torch.int32 or overflow.dtype != torch.int32
            or slot.dtype != torch.int32
            or any(t.dtype != torch.bool
                   for t in (valid, pts_valid, claimed, failed))):
        raise TypeError("map_fold_cuda takes float32 points, int32 keys, "
                        "slots and overflow, and bool masks")
    c, e = xyz.shape[0], pts.shape[0]
    if (xyz.shape != (c, 3) or key.shape != (c, 3) or valid.shape != (c,)
            or overflow.shape != () or pts.shape != (e, 3) or c < 1
            or any(t.shape != (e,)
                   for t in (pts_valid, slot, claimed, failed))):
        raise ValueError(f"map_fold_cuda shapes: xyz {tuple(xyz.shape)}, "
                         f"key {tuple(key.shape)}, pts {tuple(pts.shape)}")
    if e > MAX_ROWS:
        raise ValueError(f"map_fold_cuda: a frame of {e} rows exceeds the "
                         f"kernel's {MAX_ROWS}")
    fmt = torch.contiguous_format
    xyz_in, valid_in = xyz.contiguous(), valid.contiguous()
    out_xyz = xyz_in.clone(memory_format=fmt)
    out_key = key.clone(memory_format=fmt)
    out_valid = valid_in.clone(memory_format=fmt)
    if e == 0:                      # the library launches nothing
        res = (out_xyz, out_key, out_valid, overflow.clone())
        return res + (torch.zeros((), dtype=torch.int32, device=dev),) \
            if with_folded else res
    out_overflow = torch.empty((), dtype=torch.int32, device=dev)
    folded = torch.empty((), dtype=torch.int32, device=dev) \
        if with_folded else None
    pts, pts_valid, slot = pts.contiguous(), pts_valid.contiguous(), \
        slot.contiguous()
    claimed, failed = claimed.contiguous(), failed.contiguous()
    kernels.launch(
        "liodom_map_fold", dev, xyz_in.data_ptr(), valid_in.data_ptr(),
        overflow.data_ptr(), pts.data_ptr(), pts_valid.data_ptr(),
        slot.data_ptr(), claimed.data_ptr(), failed.data_ptr(), c, e,
        voxel_xysize, voxel_xysize / 2.0, voxel_zsize, voxel_zsize / 2.0,
        out_xyz.data_ptr(), out_key.data_ptr(), out_valid.data_ptr(),
        out_overflow.data_ptr(), folded.data_ptr() if with_folded else None)
    res = (out_xyz, out_key, out_valid, out_overflow)
    return res + (folded,) if with_folded else res
