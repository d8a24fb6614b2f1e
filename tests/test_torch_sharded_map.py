"""Port parity: the sharded hash-grid map (``parallel/sharded_map.py``).

* ``cell_owner`` and ``leaf_owner`` exact against JAX on keys over the
  whole int32 range (negative keys enter the uint32 hash as two's
  complement, i.e. >= 2^31; the shifts and the product wrap) and on points
  with negative coordinates, for several shard counts.
* ``make_sharded_map_fns`` on 2 gloo ranks (``tests/torch_ranks.py``)
  against JAX's on 2 virtual devices, the same points and poses: each
  rank's shard slot for slot equal to JAX's shard (taken apart by
  ``convert.sharded_map_state_from_numpy``; centroids to 1e-5 m), the
  shards disjoint, and the assembled neighbourhood equal row for row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.core.pose import Pose as JPose
from liodom_tpu.parallel import sharded_map as JSM
from liodom_tpu.parallel.mesh import make_mesh as jax_mesh

from liodom_tpu_torch import convert
from liodom_tpu_torch.parallel import sharded_map as SM

from torch_ranks import MAP_KW, spawn

torch.set_num_threads(1)


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_cell_owner_matches_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, (4000, 3)),            # whole int32 range
        rng.integers(-600, 600, (4000, 3)),                 # grid-sized keys
        np.array([[-1, -1, -1], [2**31 - 1, -2**31, 0],
                  [-2**31, 2**31 - 1, -1], [0, 0, 0]]),
    ]).astype(np.int32)
    got = SM.cell_owner(torch.from_numpy(keys), n_shards)
    want = np.asarray(JSM.cell_owner(jnp.asarray(keys), n_shards))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == set(range(n_shards))


def test_leaf_owner_matches_jax():
    rng = np.random.default_rng(7)
    pts = (rng.uniform(-300, 300, (20000, 3)) * np.array([1, 1, 0.1])
           ).astype(np.float32)
    pts[:100] = np.round(pts[:100] / 0.4) * 0.4     # on leaf boundaries
    for n in (2, 4):
        got = SM.leaf_owner(torch.from_numpy(pts), 0.4, n).numpy()
        want = np.asarray(JSM.leaf_owner(jnp.asarray(pts), 0.4, n))
        np.testing.assert_array_equal(got, want)


def test_sharded_map_fns_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    n_frames, n_pts = 3, 512
    pts = rng.uniform(-60, 60, (n_frames, n_pts, 3)).astype(np.float32)
    valid = rng.random((n_frames, n_pts)) < 0.9
    ts = np.stack([[float(i), 0.5 * i, 0.0] for i in range(n_frames)]
                  ).astype(np.float32)
    position = np.array([5.0, -3.0, 0.0], np.float32)

    jmcfg = JMapConfig(**MAP_KW)
    mesh = jax_mesh(data=1, map_=2, devices=jax.devices()[:2])
    upd, loc = JSM.make_sharded_map_fns(mesh, jmcfg)
    shard = JSM.init_sharded_map(jmcfg, 2)
    for p, v, t in zip(pts, valid, ts):
        shard = upd(shard, jnp.asarray(p), jnp.asarray(v),
                    JPose(jnp.array([1.0, 0.0, 0.0, 0.0]), jnp.asarray(t)))
    jx, jv = (np.asarray(a) for a in loc(shard, jnp.asarray(position)))
    jshard = tuple(np.asarray(x) for x in shard)

    outs = spawn("map_fns", 2, 1, 2, {"pts": pts, "valid": valid, "t": ts,
                                      "position": position}, tmp_path)
    owned = []
    for m, out in enumerate(outs):
        want = convert.sharded_map_state_from_numpy(jshard, (m,),
                                                    device="cpu")
        np.testing.assert_array_equal(out["valid"], want.valid.numpy())
        np.testing.assert_allclose(out["xyz"], want.xyz.numpy(), atol=1e-5)
        assert int(out["overflow"]) == int(want.overflow) == 0
        owned.append(int(out["valid"].sum()))
        np.testing.assert_array_equal(out["local_valid"], jv)
        np.testing.assert_allclose(out["local_xyz"], jx, atol=1e-5)
    assert min(owned) > 200                      # both shards hold leaves
    assert sum(owned) == int(np.asarray(shard.valid).sum())
    assert int(jv.sum()) > 100
