"""Port parity: the composed multi-card odometry + mapping steps of the
parallel layer on gloo ranks (``tests/torch_ranks.py``) against the JAX
package's ``shard_map`` programs on virtual CPU devices, at map = 2.

* ``make_sharded_combined_image_step`` (the flagship: ring-sliced features,
  per-rank window slots, sharded kNN and LM, shard-local map and feedback)
  over 4 frames of one drive: every rank's poses within 1 cm and 1e-3 rad
  of JAX's and bit-identical across the ranks, the frame's edge count
  equal to the full extractor's, the window union and the map union (slots
  over both shards) equal to JAX's (``test_combined_sharded.py:126-135``;
  the map's up to the leaf-boundary flips of float pose rounding, 0.5 %),
  overflow 0.  Then both packages continue from JAX's state after frame 1,
  taken apart rank by rank by ``convert``.
* ``make_sharded_combined_step`` (the map-sharded odometry step + the
  gathered local-map feedback) over 4 frames of edges: the same bars, and
  equal received-map sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.parallel import combined as JC
from liodom_tpu.parallel.mesh import make_mesh as jax_mesh

from liodom_tpu_torch.core.config import LiodomConfig

from test_torch_parallel import assert_close_poses, edges_of, ring_images
from torch_ranks import MAP_KW, STEP_KW, spawn

torch.set_num_threads(1)

N_FRAMES = 4
K0 = 1          # the converted runs start from JAX's state after this frame


def _mesh():
    return jax_mesh(data=1, map_=2, devices=jax.devices()[:2])


@functools.lru_cache(maxsize=1)
def _images():
    cfg = LiodomConfig(mapping=True, **STEP_KW)
    return ring_images(cfg, 0, 0.02, N_FRAMES)


def _same_slots(outs, jmap) -> None:
    """The map union over the ranks against JAX's (the same 0.5 % as the
    mapping service's free-running parity, test_torch_mapping_service)."""
    got = sum(int(o["map_slots"]) for o in outs)
    want = int(np.asarray(jmap.valid).sum())
    assert want > 1000
    assert abs(got - want) <= 0.005 * want, (got, want)


def test_sharded_combined_image_step_matches_jax(tmp_path):
    imgs, cnts = _images()
    jcfg = JConfig(mapping=True, **STEP_KW)
    jmcfg = JMapConfig(**MAP_KW)
    mesh = _mesh()
    step = JC.make_sharded_combined_image_step(mesh, jcfg, jmcfg)
    st, ms = JC.init_combined_image_sharded(jcfg, jmcfg, mesh)
    qs, ts, carried = [], [], None
    for f in range(N_FRAMES):
        st, ms, pose = step(st, ms, jnp.asarray(imgs[f][None]),
                            jnp.asarray(cnts[f][None]))
        qs.append(np.asarray(pose.q)[0])
        ts.append(np.asarray(pose.t)[0])
        if f == K0:
            carried = (jax.tree_util.tree_leaves(st),
                       jax.tree_util.tree_leaves(ms))
    jq, jt = np.stack(qs), np.stack(ts)
    inputs = {"imgs": imgs, "cnts": cnts, "k0": np.asarray(K0)}
    inputs.update({f"state_{i}": np.asarray(x)
                   for i, x in enumerate(carried[0])})
    inputs.update({f"map_{i}": np.asarray(x)
                   for i, x in enumerate(carried[1])})
    outs = spawn("combined_image", 2, 1, 2, inputs, tmp_path)

    cfg = LiodomConfig(mapping=True, **STEP_KW)
    full_edges = edges_of(cfg, imgs, cnts)[1].sum(-1)
    for r, out in enumerate(outs):
        assert_close_poses(out["q"], out["t"], jq, jt, f"rank {r} vs JAX")
        assert_close_poses(out["conv_q"], out["conv_t"], jq[K0 + 1:],
                           jt[K0 + 1:], f"rank {r} from JAX's state")
        np.testing.assert_array_equal(out["n_edges"], full_edges)
        assert int(out["overflow"]) == 0
        assert int(out["next_slot"]) == int(st.next_slot[0])
        assert int(out["nframes"]) == int(st.nframes[0])
    np.testing.assert_array_equal(outs[0]["t"], outs[1]["t"])
    np.testing.assert_array_equal(outs[0]["q"], outs[1]["q"])
    assert np.linalg.norm(jt[-1]) > 0.3             # the course moved
    # the window union holds every frame of JAX's (each global slot on one
    # rank); the shards' union holds JAX's map slots up to leaf-boundary
    # flips (the two packages' solved poses differ by float rounding, which
    # can move a point across a 0.4 m leaf boundary; test_torch_sharded_map
    # holds the shard update exact on equal poses)
    assert sum(int(o["win_points"]) for o in outs) == int(
        np.asarray(st.win_valid[0]).sum())
    _same_slots(outs, ms)
    assert int(np.asarray(ms.overflow).sum()) == 0


def test_sharded_combined_step_matches_jax(tmp_path):
    imgs, cnts = _images()
    cfg = LiodomConfig(mapping=True, **STEP_KW)
    exyz, evalid = edges_of(cfg, imgs, cnts)
    jcfg = JConfig(mapping=True, **STEP_KW)
    jmcfg = JMapConfig(**MAP_KW)
    mesh = _mesh()
    step = JC.make_sharded_combined_step(mesh, jcfg, jmcfg)
    o, ms = JC.init_combined_sharded(jcfg, jmcfg, mesh)
    qs, ts = [], []
    for x, v in zip(exyz, evalid):
        o, ms, pose = step(o, ms, jnp.asarray(x[None]), jnp.asarray(v[None]))
        qs.append(np.asarray(pose.q)[0])
        ts.append(np.asarray(pose.t)[0])
    jq, jt = np.stack(qs), np.stack(ts)
    outs = spawn("combined_step", 2, 1, 2,
                 {"exyz": exyz, "evalid": evalid}, tmp_path)
    for r, out in enumerate(outs):
        assert_close_poses(out["q"], out["t"], jq, jt, f"rank {r} vs JAX")
        assert int(out["overflow"]) == 0
        assert int(out["received"]) == int(
            np.asarray(o.received_valid[0]).sum())
    np.testing.assert_array_equal(outs[0]["t"], outs[1]["t"])
    assert np.linalg.norm(jt[-1]) > 0.3
    _same_slots(outs, ms)
