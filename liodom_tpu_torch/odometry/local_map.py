"""Sliding-window local map as a fixed-shape ring buffer.

Port of ``liodom_tpu/odometry/local_map.py``.  The reference's
``LocalMapManager`` (laser_odometry.cc:24-69) keeps the concatenated cloud of
the last N feature frames and evicts the oldest; here eviction overwrites a
slot, and the write pointer is a device tensor so that no step waits on the
host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class WindowState(NamedTuple):
    xyz: torch.Tensor        # (K, E, 3) per-frame edge clouds
    valid: torch.Tensor      # (K, E) bool
    next_slot: torch.Tensor  # () int64 — ring write pointer
    nframes: torch.Tensor    # () int64 — frames currently held (<= K)

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
        return self.xyz.shape[0]


def push(state: WindowState, xyz: torch.Tensor,
         valid: torch.Tensor) -> WindowState:
    """Add a frame, evicting the oldest when full (LocalMapManager::
    addPointCloud, laser_odometry.cc:34-60).

    The frame is compacted on the way in (valid points moved to the front,
    order kept), so the kNN kernel can skip whole all-padding tiles; the
    point set is unchanged.  Returns a new state; the old one is untouched."""
    k = state.max_frames
    slot = state.next_slot
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    valid_c = valid[order]
    xyz_c = torch.where(valid_c[:, None], xyz[order], torch.zeros_like(xyz))
    at = slot.reshape(1)
    return WindowState(
        state.xyz.index_copy(0, at, xyz_c[None]),
        state.valid.index_copy(0, at, valid_c[None]),
        (slot + 1) % k,
        torch.clamp(state.nframes + 1, max=k),
    )


def flatten(state: WindowState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenated window cloud (K*E, 3) + mask (slots beyond nframes
    off)."""
    k, e, _ = state.xyz.shape
    slot_live = torch.arange(k, device=state.xyz.device) < state.nframes
    mask = state.valid & slot_live[:, None]
    return state.xyz.reshape(k * e, 3), mask.reshape(k * e)
