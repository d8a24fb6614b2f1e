"""Carry engine state across from numpy arrays.

The JAX engine's ``OdomState`` (window xyz/valid/next_slot/nframes, odom,
prev_odom, received map, imu_ori), turned into numpy arrays by its caller,
becomes the port's :class:`~liodom_tpu_torch.odometry.pipeline.OdomState`,
and its ``MapState`` the port's :class:`~liodom_tpu_torch.mapping.grid.
MapState`, so both engines can continue from the same mid-course state; the
sharded layouts of the parallel layer are taken apart rank by rank, and a
JAX run's checkpoint becomes the port's (:func:`checkpoint_from_numpy`).
The system has no weights; this is their counterpart.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

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


def sharded_map_state_from_numpy(np_map: Sequence, at: Tuple[int, ...],
                                 device=None) -> MapState:
    """This rank's map shard from the JAX package's stacked sharded
    ``MapState`` (a tuple in ``MAP_KEYS`` order): every leaf indexed by
    ``at``, the rank's mesh coordinate over the leading axes — ``(d, m)``
    for the composed steps' (data, map) layout (``combined.py:62-64``,
    ``:167-169``), ``(m,)`` for ``init_sharded_map``'s (map,) layout."""
    return map_state_from_numpy(tuple(np.asarray(x)[at] for x in np_map),
                                device)


def sharded_combined_state_from_numpy(np_state: Sequence, d: int, m: int,
                                      device=None):
    """This rank's :class:`~liodom_tpu_torch.parallel.combined.
    ShardedCombinedState` from the JAX package's host-stacked one (a tuple
    in its field order, e.g. mapped through ``np.asarray``): the poses and
    the two scalars carry a leading (data,) axis, the window and received
    leaves (data, map) (``combined.py:165-169``); rank (d, m) takes its
    slices."""
    from liodom_tpu_torch.parallel.combined import ShardedCombinedState
    dev = resolve_device(device)
    odom, prev, wxyz, wvalid, slot, nframes, rxyz, rvalid = np_state

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    return ShardedCombinedState(
        Pose(f32(np.asarray(odom[0])[d]), f32(np.asarray(odom[1])[d])),
        Pose(f32(np.asarray(prev[0])[d]), f32(np.asarray(prev[1])[d])),
        f32(np.asarray(wxyz)[d, m]), flag(np.asarray(wvalid)[d, m]),
        idx(np.asarray(slot)[d]), idx(np.asarray(nframes)[d]),
        f32(np.asarray(rxyz)[d, m]), flag(np.asarray(rvalid)[d, m]))


def checkpoint_from_numpy(ckpt, device=None):
    """The port's :class:`~liodom_tpu_torch.runtime.checkpoint.
    EngineCheckpoint` from a JAX package's one restored without a template
    (``liodom_tpu.runtime.checkpoint.restore(directory)``): its states are
    nested dicts keyed by the NamedTuple field names, their leaves arrays
    (numpy or JAX, read through ``np.asarray``).  The odometry state goes
    through :func:`state_from_numpy` and the map through
    :func:`map_state_from_numpy`; orbax's one-byte stand-in for the empty
    received map of an odometry-only run (an int8 leaf where a bool mask
    belongs) becomes the empty map again.  A run resumed from the result
    continues the JAX run."""
    from liodom_tpu_torch.runtime.checkpoint import EngineCheckpoint
    o = ckpt.odom_state
    window = o["window"]
    rxyz, rvalid = o["received_xyz"], o["received_valid"]
    if np.asarray(rvalid).dtype != np.bool_:
        rxyz, rvalid = np.zeros((0, 3), np.float32), np.zeros((0,), bool)
    # np.array copies: a restored JAX array reads back as a read-only
    # buffer, which a tensor must not alias
    state = state_from_numpy({k: np.array(v) for k, v in {
        "window_xyz": window["xyz"], "window_valid": window["valid"],
        "next_slot": window["next_slot"], "nframes": window["nframes"],
        "odom_q": o["odom"]["q"], "odom_t": o["odom"]["t"],
        "prev_q": o["prev_odom"]["q"], "prev_t": o["prev_odom"]["t"],
        "received_xyz": rxyz, "received_valid": rvalid,
        "imu_ori": o["imu_ori"]}.items()}, device)
    mstate = (None if ckpt.map_state is None else map_state_from_numpy(
        {k: np.array(ckpt.map_state[k]) for k in MAP_KEYS}, device))
    traj = np.asarray(ckpt.trajectory, np.float64).reshape(-1, 3, 4)
    return EngineCheckpoint(state, mstate, traj, int(ckpt.frame_index))
