"""Sliding-window local map as a fixed-shape ring buffer.

Port of ``liodom_tpu/odometry/local_map.py``.  The reference's
``LocalMapManager`` (laser_odometry.cc:24-69) keeps the concatenated cloud of
the last N feature frames and evicts the oldest; here eviction overwrites a
slot, and the write pointer is a device tensor so that no step waits on the
host.  A batch of independent windows carries a leading dimension on every
field (``batch_image_step``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class WindowState(NamedTuple):
    xyz: torch.Tensor        # (..., K, E, 3) per-frame edge clouds
    valid: torch.Tensor      # (..., K, E) bool
    next_slot: torch.Tensor  # (...) int64 — ring write pointer
    nframes: torch.Tensor    # (...) int64 — frames currently held (<= K)

    @staticmethod
    def create(max_frames: int, capacity: int, dtype=torch.float32,
               device=None) -> "WindowState":
        return WindowState(
            torch.zeros((max_frames, capacity, 3), dtype=dtype, device=device),
            torch.zeros((max_frames, capacity), dtype=torch.bool,
                        device=device),
            torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
        )

    @property
    def max_frames(self) -> int:
        return self.xyz.shape[-3]


def compact(xyz: torch.Tensor, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Valid rows of (..., E, 3) moved to the front, order kept, padding
    zeroed: the point set is unchanged, and the kNN kernels skip the
    all-padding tiles at the end."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    valid_c = valid.gather(-1, order)
    xyz_c = xyz.gather(-2, order[..., None].expand(xyz.shape))
    xyz_c = torch.where(valid_c[..., None], xyz_c, torch.zeros_like(xyz))
    return xyz_c, valid_c


def push(state: WindowState, xyz: torch.Tensor,
         valid: torch.Tensor) -> WindowState:
    """Add a frame, evicting the oldest when full (LocalMapManager::
    addPointCloud, laser_odometry.cc:34-60).

    The frame is compacted on the way in (:func:`compact`).  Each batch
    element writes its own slot, by a select against the slot index (no
    host read of the pointer).  Returns a new state; the old one is
    untouched."""
    k = state.max_frames
    slot = state.next_slot
    xyz_c, valid_c = compact(xyz, valid)
    hit = torch.arange(k, device=slot.device) == slot[..., None]   # (..., K)
    return WindowState(
        torch.where(hit[..., None, None], xyz_c[..., None, :, :], state.xyz),
        torch.where(hit[..., None], valid_c[..., None, :], state.valid),
        (slot + 1) % k,
        torch.clamp(state.nframes + 1, max=k),
    )


def flatten(state: WindowState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenated window cloud (..., K*E, 3) + mask (slots beyond nframes
    off)."""
    k, e, _ = state.xyz.shape[-3:]
    lead = state.xyz.shape[:-3]
    slot_live = (torch.arange(k, device=state.xyz.device)
                 < state.nframes[..., None])
    mask = state.valid & slot_live[..., None]
    return (state.xyz.reshape(lead + (k * e, 3)),
            mask.reshape(lead + (k * e,)))
