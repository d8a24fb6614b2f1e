"""Port parity of the voxel-filtered matching map: ``ops/voxel.py`` against
``liodom_tpu/ops/voxel.py`` and the float64 oracle
``golden_voxel_centroids``, and ``image_step`` with ``filter_local_map``
against JAX.

* Leaf keys and leaf membership bit-exact to JAX (the same float32
  multiply by the leaf's reciprocal, as XLA compiles JAX's divide, and the
  same stable sort; 0.4 m lattice points on leaf boundaries included);
  centroids within 1e-6 m of JAX on the
  CPU (the segment sums run in the same order there) and within the 1e-3 m
  that tests/test_voxel.py holds JAX to of the oracle.
* ``image_step`` with ``filter_local_map=True, local_map_size=3`` over 6
  frames of the course tests/test_odometry.py:104 runs JAX on: equal edge
  counts, poses within 1 cm and 1e-3 rad of JAX ``image_step``.
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF
from liodom_tpu.ops import voxel as JV

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import local_map as L
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import voxel as V

from golden import golden_voxel_centroids
from test_torch_odometry import _quat_angle

torch.set_num_threads(1)

LEAF = 0.4


@functools.partial(jax.jit, static_argnames=("leaf",))
def _jax_keys(xyz, valid, leaf):
    """The leaf keys of liodom_tpu/ops/voxel.py:46-54, written out (the JAX
    function does not return them) and compiled as it is: XLA turns the
    divide by the leaf into a multiply by its reciprocal."""
    anchor = jnp.min(jnp.where(valid[:, None], xyz, jnp.inf), axis=0)
    anchor = jnp.where(jnp.isfinite(anchor), anchor, 0.0)
    q = jnp.clip(jnp.floor(xyz / leaf).astype(jnp.int32)
                 - jnp.floor(anchor / leaf).astype(jnp.int32)[None, :],
                 0, JV._SPAN - 1)
    key = (q[:, 0] << (2 * JV._BITS)) | (q[:, 1] << JV._BITS) | q[:, 2]
    return jnp.where(valid, key, JV._INVALID_KEY)


def _clouds():
    rng = np.random.default_rng(0)
    uniform = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    # a window-like cloud: points along lines, many sharing a leaf, and a
    # far outlier that the 10-bit span clips
    t = rng.uniform(0, 30, (3000, 1))
    d = rng.normal(size=(6, 3))
    lines = (rng.normal(size=(3000, 3)) * 0.05 + t * d[rng.integers(0, 6,
                                                                   3000)]
             ).astype(np.float32)
    lines[7] = [500.0, -3.0, 1.0]
    leafy = (np.round(rng.uniform(-10, 10, (800, 3)) / LEAF) * LEAF
             ).astype(np.float32)                  # exactly on boundaries
    return {"uniform": (uniform, np.ones(500, bool)),
            "lines": (lines, rng.random(3000) > 0.2),
            "boundaries": (leafy, rng.random(800) > 0.1),
            "negative": (np.array([[-0.1, -0.1, -0.1], [-0.3, -0.3, -0.3],
                                   [0.1, 0.1, 0.1]], np.float32),
                         np.ones(3, bool)),
            "cluster": (np.zeros((100, 3), np.float32) + 0.05,
                        np.ones(100, bool)),
            "all_invalid": (np.zeros((16, 3), np.float32),
                            np.zeros(16, bool))}


@pytest.mark.parametrize("case", sorted(_clouds()))
def test_voxel_downsample_matches_jax(case):
    xyz, valid = _clouds()[case]
    jx, jv = (np.asarray(a) for a in JV.voxel_downsample(
        jnp.asarray(xyz), jnp.asarray(valid), LEAF))
    tx, tv = V.voxel_downsample(torch.from_numpy(xyz),
                                torch.from_numpy(valid), LEAF)
    keys = V.voxel_keys(torch.from_numpy(xyz), torch.from_numpy(valid),
                        LEAF).numpy()
    np.testing.assert_array_equal(
        keys, np.asarray(_jax_keys(jnp.asarray(xyz), jnp.asarray(valid),
                                   LEAF)))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-6)
    assert np.isfinite(tx.numpy()).all()
    assert not tx.numpy()[~tv.numpy()].any()


@pytest.mark.parametrize("case", ["uniform", "lines", "negative", "cluster"])
def test_voxel_centroids_match_golden(case):
    xyz, valid = _clouds()[case]
    tx, tv = V.voxel_downsample(torch.from_numpy(xyz),
                                torch.from_numpy(valid), LEAF)
    got = tx.numpy()[tv.numpy()]
    want = golden_voxel_centroids(xyz[valid].astype(np.float64), LEAF)
    if case == "lines":
        # the far outlier is clipped into the span's last leaf along x, as
        # in JAX; the oracle keeps its own leaf: compare the rest
        keep = np.abs(want[:, 0]) < 100
        want = want[keep]
        got = got[np.abs(got[:, 0]) < 100]
    assert len(got) == len(want)
    gi, wi = np.lexsort(got.T), np.lexsort(want.T)
    np.testing.assert_allclose(got[gi], want[wi], atol=1e-3)


def test_voxel_downsample_batched_is_each_cloud():
    clouds = _clouds()
    (a, va), (b, vb) = clouds["uniform"], clouds["boundaries"]
    b, vb = b[:500], vb[:500]
    bx, bv = V.voxel_downsample(torch.from_numpy(np.stack([a, b])),
                                torch.from_numpy(np.stack([va, vb])), LEAF)
    for i, (x, v) in enumerate(((a, va), (b, vb))):
        sx, sv = V.voxel_downsample(torch.from_numpy(x), torch.from_numpy(v),
                                    LEAF)
        assert torch.equal(bx[i], sx) and torch.equal(bv[i], sv)


def test_filtered_matching_map_only_when_the_window_is_full():
    cfg = LiodomConfig(ring_width=256, local_map_size=3,
                       filter_local_map=True)
    state = P.init_state(cfg, device="cpu")
    rng = np.random.default_rng(3)
    frame = torch.from_numpy(rng.normal(size=(cfg.max_edges, 3))
                             .astype(np.float32) * 0.1)
    on = torch.ones(cfg.max_edges, dtype=torch.bool)
    for k in range(cfg.local_map_size):
        raw = L.flatten(state.window)
        got = P._matching_map(state, cfg)
        assert torch.equal(got[0], raw[0]) and torch.equal(got[1], raw[1])
        state = state._replace(window=L.push(state.window, frame + k, on))
    got = P._matching_map(state, cfg)
    want = V.voxel_downsample(*L.flatten(state.window), cfg.local_map_voxel)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) < int(L.flatten(state.window)[1].sum())


def test_filtered_image_step_tracks_jax():
    kw = dict(max_points=65536, ring_width=1024, local_map_size=3,
              filter_local_map=True)
    jcfg, cfg = JConfig(**kw), LiodomConfig(**kw)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(6, speed=0.5, yaw_rate=0.01)
    jstate, state = JP.init_state(jcfg), P.init_state(cfg, device="cpu")
    for i in range(6):
        scan = world.render(pos[i], yaw_matrix(yaws[i]), width=900, noise=0.0,
                            seed=100 + i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        jstate, jpose, jn = JP.image_step(jstate, img.xyz, img.count, jcfg)
        state, pose, n = P.image_step(state,
                                      torch.from_numpy(np.array(img.xyz)),
                                      torch.from_numpy(np.array(img.count)),
                                      cfg)
        assert int(n) == int(jn) > 100, f"frame {i}"
        assert np.linalg.norm(pose.t.numpy() - np.asarray(jpose.t)) < 0.01
        assert _quat_angle(pose.q.numpy(), np.asarray(jpose.q)) < 1e-3
    assert int(state.window.nframes) == 3
    assert np.linalg.norm(np.asarray(pos[-1]) - pose.t.numpy()) < 0.1
