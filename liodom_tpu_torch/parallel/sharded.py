"""SPMD odometry over a device mesh (port of
``liodom_tpu/parallel/sharded.py``).

Replaces the reference's process-parallelism + ROS transport (SURVEY.md §5)
with the axes of a ``torch.distributed`` mesh (``parallel/mesh.py``):

* ``data``: a batch of independent sequences, one odometry state each;
  every rank steps its own local batch with a leading batch dimension (the
  JAX package's ``vmap``).
* ``map``: the hot per-frame work — kNN correspondence search and the
  Gauss-Newton normal equations — sharded across the ranks of a map group.
  Each rank searches its slice of the matching map with K5 (``knn_auto``),
  gathers its candidates' rows, and one ``all_gather`` over 'map' merges
  the candidates; the residuals are split over the group and the 6x6
  ``JtJ``/``Jtr`` and the costs are ``all_reduce``d (``lm_solve(group=)``).

The per-sequence window state is replicated inside a map group: every rank
computes it identically.  Each of the 2 outer iterations makes 2
``all_gather``s (candidate distances and rows) and 9 ``all_reduce``s (the
normal equations before and in each of the 4 LM iterations, and each
candidate step's cost), all on the map group; nothing waits on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from liodom_tpu_torch.core import pose as se3
from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.odometry import local_map
from liodom_tpu_torch.odometry.pipeline import (OdomState, _matching_map,
                                                init_state)
from liodom_tpu_torch.ops.neighbors import (LineCorrespondences, _line_fit,
                                            knn_auto)
from liodom_tpu_torch.ops.solver import lm_solve
from liodom_tpu_torch.parallel.mesh import axis


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


# the single-tensor all_gather; newer torch renames all_gather_into_tensor
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` from every rank of ``group`` (size ``n``), stacked on a new
    leading axis in rank order (``jax.lax.all_gather``), gathered straight
    into one tensor (concatenated on dim 0, the form gloo and NCCL both
    take)."""
    out = t.new_empty((n * t.shape[0],) + t.shape[1:])
    _gather_into(out, t.contiguous(), group=group)
    return out.view((n,) + t.shape)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (..., M, 3) at ``idx`` (..., E, k) -> (..., E, k, 3)."""
    flat = idx.flatten(-2).long()
    out = x.gather(-2, flat[..., None].expand(flat.shape + (3,)))
    return out.unflatten(-2, idx.shape[-2:])


def _pad_rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` with ``n`` zero (False) rows appended along ``dim``."""
    if n == 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _sharded_correspondences(edges_world: torch.Tensor, emask: torch.Tensor,
                             map_xyz: torch.Tensor, map_valid: torch.Tensor,
                             cfg: LiodomConfig, group, n: int
                             ) -> LineCorrespondences:
    """kNN + line fit with the map sharded over the map group
    (``sharded.py:48-74``).  ``map_xyz``/``map_valid`` are this rank's
    shard; the result is identical on every rank of the group.

    The candidates of all shards are merged by a stable sort of their
    distances, shard-major: on equal distances the lower shard wins, as
    ``lax.top_k`` keeps the lower position."""
    k = cfg.knn_k
    d2l, idxl = knn_auto(edges_world, emask, map_xyz, map_valid, k=k)
    ptsl = _take_rows(map_xyz, idxl)                            # (..., E, k, 3)
    # (n, ..., E, k[, 3]) -> (..., E, n*k[, 3]), shard-major per edge
    d2g = all_gather(d2l, group, n).movedim(0, -2).flatten(-2)
    ptsg = all_gather(ptsl, group, n).movedim(0, -3).flatten(-3, -2)
    d2, sel = torch.sort(d2g, dim=-1, stable=True)
    d2, sel = d2[..., :k], sel[..., :k]
    near = ptsg.gather(-2, sel[..., None].expand(sel.shape + (3,)))
    return _line_fit(near, d2[..., k - 1], emask, cfg.knn_max_sq_dist,
                     cfg.eig_ratio, cfg.min_line_sep)


def _sharded_solve(pose: Pose, exyz: torch.Tensor, evalid: torch.Tensor,
                   map_xyz: torch.Tensor, map_valid: torch.Tensor,
                   cfg: LiodomConfig, group, n: int, me: int) -> Pose:
    """The 2x (transform, sharded correspondences, edge-sharded LM) loop of
    ``sharded.py:107-119`` and ``combined.py:243-253``: the residual rows
    are padded to a multiple of the group size and this rank solves its
    contiguous share, the sums all-reduced."""
    e = exyz.shape[-2]
    esh = -(-e // n)
    epad = esh * n - e

    def mine(a: torch.Tensor, dim: int) -> torch.Tensor:
        return _pad_rows(a, epad, dim).narrow(dim, me * esh, esh)

    for _ in range(cfg.outer_iters):
        ew = se3.transform(pose, exyz)
        lpa, lpb, ok = _sharded_correspondences(ew, evalid, map_xyz,
                                                map_valid, cfg, group, n)
        pose = lm_solve(pose, mine(exyz, -2), mine(lpa, -2), mine(lpb, -2),
                        mine(ok, -1), min_range=cfg.min_range,
                        max_range=cfg.max_range, huber_delta=cfg.huber_delta,
                        iters=cfg.inner_iters, group=group)
    return pose


def _one_sequence_step(state: OdomState, exyz: torch.Tensor,
                       evalid: torch.Tensor, cfg: LiodomConfig, group,
                       n: int, me: int) -> Tuple[OdomState, Pose]:
    """The frame step with map-sharded correspondence compute
    (``sharded.py:77-127``) for a state and edges with any leading batch
    dimensions: the single-card matching map (window + received map),
    this rank's slice of it (cdiv rows, the last shard padded with invalid
    rows), the constant-velocity prediction, the sharded solve and the
    window push.  No IMU override, no radius pruning."""
    map_xyz, map_valid = _matching_map(state, cfg)
    m = map_xyz.shape[-2]
    shard = -(-m // n)
    pad = shard * n - m
    my_xyz = _pad_rows(map_xyz, pad, -2).narrow(-2, me * shard, shard)
    my_valid = _pad_rows(map_valid, pad, -1).narrow(-1, me * shard, shard)

    pred = se3.compose(state.odom,
                       se3.compose(se3.inverse(state.prev_odom), state.odom))
    pose = _sharded_solve(pred, exyz, evalid, my_xyz, my_valid, cfg, group,
                          n, me)

    edges_final = se3.transform(pose, exyz)
    window = local_map.push(
        state.window,
        torch.where(evalid[..., None], edges_final, torch.zeros_like(exyz)),
        evalid)
    new_state = OdomState(window, pose, state.odom, state.received_xyz,
                          state.received_valid, state.imu_ori)
    return new_state, pose


def make_sharded_step(mesh, cfg: LiodomConfig):
    """The multi-card step (``sharded.py:130-149``): ``step(state, exyz,
    evalid) -> (state, poses)`` on this rank's local batch of sequences
    (state from :func:`init_batch_state`, exyz (B, E, 3), evalid (B, E)),
    the correspondence compute sharded over the mesh's 'map' axis.  Every
    rank of a map group must call it with the same inputs."""
    group, n, me = axis(mesh, "map")

    def step(state: OdomState, exyz: torch.Tensor, evalid: torch.Tensor
             ) -> Tuple[OdomState, Pose]:
        return _one_sequence_step(state, exyz, evalid, cfg, group, n, me)

    return step
