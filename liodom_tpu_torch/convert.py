"""Carry engine state across from numpy arrays.

The JAX engine's ``OdomState`` (window xyz/valid/next_slot/nframes, odom,
prev_odom, received map, imu_ori), turned into numpy arrays by its caller,
becomes the port's :class:`~liodom_tpu_torch.odometry.pipeline.OdomState`,
and its ``MapState`` the port's :class:`~liodom_tpu_torch.mapping.grid.
MapState`, so both engines can continue from the same mid-course state.  The
system has no weights; this is their counterpart.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from liodom_tpu_torch.core.device import resolve_device
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping.grid import EMPTY, MapState
from liodom_tpu_torch.odometry.local_map import WindowState
from liodom_tpu_torch.odometry.pipeline import OdomState

STATE_KEYS = ("window_xyz", "window_valid", "next_slot", "nframes",
              "odom_q", "odom_t", "prev_q", "prev_t", "received_xyz",
              "received_valid", "imu_ori")
MAP_KEYS = ("xyz", "key", "valid", "overflow", "code1", "code2")


def pose_from_numpy(q, t, device=None) -> Pose:
    """A pose from a wxyz quaternion and a translation given as numpy
    arrays."""
    dev = resolve_device(device)
    return Pose(torch.as_tensor(np.asarray(q, np.float32), device=dev),
                torch.as_tensor(np.asarray(t, np.float32), device=dev))


def _flat(np_state) -> dict:
    if isinstance(np_state, Mapping):
        missing = [k for k in STATE_KEYS if k not in np_state]
        if missing:
            raise KeyError(f"state dict lacks {missing}")
        return dict(np_state)
    window, odom, prev, rxyz, rvalid, imu = np_state
    wxyz, wvalid, slot, nframes = window
    return dict(zip(STATE_KEYS, (wxyz, wvalid, slot, nframes, odom[0],
                                 odom[1], prev[0], prev[1], rxyz, rvalid,
                                 imu)))


def state_from_numpy(np_state: Union[Mapping, Sequence], device=None
                     ) -> OdomState:
    """The port's state from the JAX engine's, as numpy arrays: either a
    dict with :data:`STATE_KEYS`, or a nested tuple in ``OdomState`` field
    order (``((xyz, valid, next_slot, nframes), (q, t), (q, t),
    received_xyz, received_valid, imu_ori)``, e.g. the JAX state mapped
    through ``np.asarray``).  A batched JAX state (``init_batch_state``,
    ``batch_image_step``) keeps its leading batch dimension on every
    field."""
    s = _flat(np_state)
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    window = WindowState(f32(s["window_xyz"]), flag(s["window_valid"]),
                         idx(s["next_slot"]), idx(s["nframes"]))
    return OdomState(window,
                     Pose(f32(s["odom_q"]), f32(s["odom_t"])),
                     Pose(f32(s["prev_q"]), f32(s["prev_t"])),
                     f32(np.reshape(s["received_xyz"],
                                    np.shape(s["received_valid"]) + (3,))),
                     flag(s["received_valid"]),
                     f32(s["imu_ori"]))


def map_state_from_numpy(np_map: Union[Mapping, Sequence], device=None
                         ) -> MapState:
    """The port's map from the JAX engine's ``MapState`` as numpy arrays:
    a dict with :data:`MAP_KEYS` or a tuple in that field order.  The
    uint32 code words ``(code1, code2)`` become one int64 code
    ``code1 << 26 | code2``; the all-ones empty pair becomes
    :data:`~liodom_tpu_torch.mapping.grid.EMPTY`.  Both engines can then
    continue from the same mid-course map, slot for slot."""
    if isinstance(np_map, Mapping):
        missing = [k for k in MAP_KEYS if k not in np_map]
        if missing:
            raise KeyError(f"map dict lacks {missing}")
        xyz, key, valid, overflow, c1, c2 = (np_map[k] for k in MAP_KEYS)
    else:
        xyz, key, valid, overflow, c1, c2 = np_map
    dev = resolve_device(device)
    c1 = np.asarray(c1, np.uint32).astype(np.int64)
    c2 = np.asarray(c2, np.uint32).astype(np.int64)
    full = c1 != 0xFFFFFFFF
    if np.any(c2[full] >= (1 << 26)):
        raise ValueError("code2 of an occupied slot holds more than 26 bits")
    code = np.where(full, (c1 << 26) | c2, EMPTY)
    return MapState(torch.tensor(np.asarray(xyz, np.float32), device=dev),
                    torch.tensor(np.asarray(key, np.int32), device=dev),
                    torch.tensor(np.asarray(valid, bool), device=dev),
                    torch.tensor(np.asarray(overflow, np.int32), device=dev),
                    torch.tensor(code, device=dev))
