"""Batched odometry state (port of ``liodom_tpu/parallel/sharded.py``,
``init_batch_state`` only).

The JAX module also shards the batch and the matching map over a device
mesh; those parts come with the parallel slice.  A batch of independent
sequences on one card needs only the state with a leading batch dimension,
which :func:`liodom_tpu_torch.odometry.pipeline.batch_image_step` steps.
"""

from __future__ import annotations

import torch

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry.pipeline import OdomState, init_state


def _batched(tree, batch: int):
    """Every tensor of a nest of named tuples repeated over a new leading
    dimension of size ``batch`` (own memory, not an expanded view)."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((batch,) + tree.shape).contiguous()
    return type(tree)(*(_batched(t, batch) for t in tree))


def init_batch_state(cfg: LiodomConfig, batch: int, device=None
                     ) -> OdomState:
    """A batch of independent odometry states (leading dim = sequences),
    on CUDA unless ``device`` says otherwise (``sharded.py:41-45``)."""
    return _batched(init_state(cfg, device=device), batch)
