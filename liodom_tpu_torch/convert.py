"""Carry engine state across from numpy arrays.

The JAX engine's ``OdomState`` (window xyz/valid/next_slot/nframes, odom,
prev_odom, received map, imu_ori), turned into numpy arrays by its caller,
becomes the port's :class:`~liodom_tpu_torch.odometry.pipeline.OdomState`,
so both engines can continue from the same mid-course state.  The system has
no weights; this is their counterpart.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.odometry.local_map import WindowState
from liodom_tpu_torch.odometry.pipeline import OdomState, resolve_device

STATE_KEYS = ("window_xyz", "window_valid", "next_slot", "nframes",
              "odom_q", "odom_t", "prev_q", "prev_t", "received_xyz",
              "received_valid", "imu_ori")


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
    through ``np.asarray``)."""
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
                     f32(np.reshape(s["received_xyz"], (-1, 3))),
                     flag(s["received_valid"]),
                     f32(s["imu_ori"]))
