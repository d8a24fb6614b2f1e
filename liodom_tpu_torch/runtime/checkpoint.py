"""Checkpoint / resume for the odometry + mapping state (port of
``liodom_tpu/runtime/checkpoint.py``).

The reference has **no** checkpointing (SURVEY.md §5: the map is never
serialised, only published; results files are written once at shutdown,
liodom_node.cc:114-118).  This module adds it: the full engine state — the
odometry window and poses (:class:`~liodom_tpu_torch.odometry.pipeline.
OdomState`), the hash-grid map (:class:`~liodom_tpu_torch.mapping.grid.
MapState`), the trajectory so far and the frame cursor — so long runs
survive preemption and resume mid-sequence.

Layout: the JAX package's, one directory per step, ``<dir>/step_<n>/``,
with static metadata in ``meta.json`` (``format`` 1, ``frame_index``,
``has_map``), written last, so a step without it is incomplete.  The file
format is the port's own: the states are nested dicts of CPU tensors
(``NamedTuple._asdict`` at every level) in ``state.pt`` (``torch.save``),
loaded back with ``torch.load(weights_only=True)``; the map's codes are the
port's int64 form ``code1 << 26 | code2``.  A JAX checkpoint (orbax) is
read by the JAX package and carried across with
:func:`liodom_tpu_torch.convert.checkpoint_from_numpy`.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch


class EngineCheckpoint(NamedTuple):
    """Everything needed to resume a run mid-sequence."""

    odom_state: Any              # OdomState
    map_state: Optional[Any]     # MapState or None
    trajectory: np.ndarray       # (F, 3, 4) KITTI-format poses so far
    frame_index: int             # next frame to process


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(os.path.expanduser(directory)),
                        f"step_{step:08d}")


def _to_tree(x):
    """NamedTuples as dicts at every level, tensors on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if hasattr(x, "_asdict"):
        return {k: _to_tree(v) for k, v in x._asdict().items()}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _from_tree(tree, template, where: str = "state"):
    """``tree`` rebuilt in the structure of ``template``, every tensor on
    its template leaf's device; a leaf of another shape or dtype raises."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(tree, torch.Tensor) or tree.shape != template.shape
                or tree.dtype != template.dtype):
            got = (f"{tuple(tree.shape)} {tree.dtype}"
                   if isinstance(tree, torch.Tensor) else type(tree).__name__)
            raise ValueError(f"checkpoint leaf {where}: {got}, template "
                             f"{tuple(template.shape)} {template.dtype}")
        return tree.to(template.device)
    return type(template)(*(
        _from_tree(tree[f], getattr(template, f), f"{where}.{f}")
        for f in template._fields))


def save(directory: str, step: int, ckpt: EngineCheckpoint,
         extra_meta: Optional[dict] = None) -> str:
    """Write a checkpoint; returns its path."""
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    traj = np.asarray(ckpt.trajectory, dtype=np.float64).reshape(-1, 3, 4)
    tree = {"odom_state": _to_tree(ckpt.odom_state),
            "map_state": (_to_tree(ckpt.map_state)
                          if ckpt.map_state is not None else None),
            "trajectory": torch.from_numpy(traj)}
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=path)
    os.close(fd)
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    meta = {"frame_index": int(ckpt.frame_index),
            "has_map": ckpt.map_state is not None,
            "format": 1}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    """Highest step with a complete checkpoint in ``directory``, or None."""
    directory = os.path.abspath(os.path.expanduser(directory))
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "meta.json")):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None,
            template: Optional[dict] = None) -> Tuple[int, EngineCheckpoint]:
    """Load a checkpoint (latest step unless given).

    ``template``: optional {"odom_state": ..., "map_state": ...} states of
    the right structure, shapes and dtypes (e.g. ``init_state`` /
    ``init_combined`` of the run's configuration): the states come back as
    those NamedTuples, every tensor on its template leaf's device.  Without
    it they are nested dicts of CPU tensors."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)
    odom_state = tree["odom_state"]
    map_state = tree["map_state"] if meta.get("has_map") else None
    if template is not None:
        odom_state = _from_tree(odom_state, template["odom_state"],
                                "odom_state")
        if map_state is not None and template.get("map_state") is not None:
            map_state = _from_tree(map_state, template["map_state"],
                                   "map_state")
    ckpt = EngineCheckpoint(odom_state, map_state,
                            tree["trajectory"].numpy(),
                            int(meta["frame_index"]))
    return step, ckpt
