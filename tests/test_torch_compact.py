"""Port parity of K7, local-map extraction (``liodom_tpu_torch/ops/
compact_pallas.py`` and ``mapping/grid.py:get_local_map``), on the CPU.

* The plain compaction against the TPU kernel
  ``scripts/compact_pallas_experiment.py:compact_rows_pallas`` in interpret
  mode, loaded by path (the script is not a package module).  That kernel
  may stop up to one tile (512 rows) before the capacity, so the cases keep
  ``n_hits <= capacity - 512``; its rows past the hit count are undefined,
  so only the first ``n_hits`` rows are compared.  Exact.
* ``get_local_map`` against the JAX function on a map built by JAX
  ``update_map`` and carried across with ``map_state_from_numpy``: rows,
  validity and ``n_hits`` exact, including a capacity below the hit count
  (the exact cut) and one above the map's row count.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.core.pose import Pose as JPose
from liodom_tpu.mapping import grid as JG

from liodom_tpu_torch import convert
from liodom_tpu_torch.core.config import MapConfig
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.ops import compact_pallas as K7

torch.set_num_threads(1)

SCRIPT = (Path(__file__).resolve().parent.parent / "scripts"
          / "compact_pallas_experiment.py")


def _tpu_kernel_module():
    spec = importlib.util.spec_from_file_location("compact_pallas_experiment",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,capacity,p_hit", [
    (4096, 2048, 0.3),      # ~1.2k hits
    (8192, 1024, 0.05),     # ~0.4k hits, mostly empty tiles
    (2048, 4096, 0.9),      # capacity above the row count
])
def test_plain_compaction_matches_the_tpu_kernel(rows, capacity, p_hit):
    rng = np.random.default_rng(rows + capacity)
    xyz = (rng.normal(size=(rows, 3)) * 20).astype(np.float32)
    hit = rng.random(rows) < p_hit
    n = int(hit.sum())
    assert 0 < n <= capacity - 512
    want = np.asarray(_tpu_kernel_module().compact_rows_pallas(
        jnp.asarray(xyz), jnp.asarray(hit), capacity, interpret=True))
    out, out_valid, n_hits = K7.compact_rows_plain(
        torch.from_numpy(xyz), torch.from_numpy(hit), capacity)
    assert int(n_hits) == n
    np.testing.assert_array_equal(out.numpy()[:n], want[:n])
    np.testing.assert_array_equal(out.numpy()[:n], xyz[hit])
    assert out_valid.numpy().tolist() == [j < n for j in range(capacity)]
    assert not out.numpy()[n:].any()


def test_plain_compaction_cuts_exactly_at_capacity():
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy((rng.normal(size=(1000, 3))).astype(np.float32))
    hit = torch.from_numpy(rng.random(1000) < 0.5)
    out, out_valid, n_hits = K7.compact_rows_plain(xyz, hit, 100)
    assert int(n_hits) == int(hit.sum()) > 100
    assert torch.equal(out, xyz[hit][:100]) and bool(out_valid.all())
    for cap in (0, 7):
        out, out_valid, n = K7.compact_rows_plain(
            xyz, torch.zeros(1000, dtype=torch.bool), cap)
        assert out.shape == (cap, 3) and int(n) == 0
        assert not bool(out.any()) and not bool(out_valid.any())


@functools.lru_cache(maxsize=2)
def _jax_map(n_frames=4, capacity=8192):
    """A JAX hash map over clustered frames spanning several 20 m cells."""
    jcfg = JMapConfig(voxel_xysize=20.0, voxel_zsize=25.0,
                      map_capacity=capacity)
    rng = np.random.default_rng(11)
    jm = JG.init_map(capacity)
    for f in range(n_frames):
        centers = rng.uniform(-70, 70, (80, 3)) * np.array([1, 1, 0.3])
        pts = (centers[rng.integers(0, 80, 2000)]
               + rng.normal(size=(2000, 3)) * 0.6).astype(np.float32)
        valid = rng.random(2000) > 0.1
        pose = JPose(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                     jnp.asarray([3.0 * f, -1.5 * f, 0.1 * f], jnp.float32))
        jm = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid), pose,
                           jcfg)
    return jcfg, jm


@pytest.mark.parametrize("capacity", [None, 100, 5000, 10000])
@pytest.mark.parametrize("position", [(0.4, -0.7, 0.2), (-19.9, 25.3, -3.1),
                                      (41.0, 40.9, 12.6)])
def test_get_local_map_matches_jax(capacity, position):
    jcfg, jm = _jax_map()
    cfg = MapConfig(voxel_xysize=20.0, voxel_zsize=25.0, map_capacity=8192)
    tm = convert.map_state_from_numpy([np.asarray(a) for a in jm],
                                      device="cpu")
    pos = np.asarray(position, np.float32)
    jx, jv, jn = JG.get_local_map(jm, jnp.asarray(pos), jcfg,
                                  capacity=capacity)
    tx, tv, tn = G.get_local_map(tm, torch.from_numpy(pos), cfg,
                                 capacity=capacity)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if capacity == 100:
        assert int(tn) > 100        # the cut is exercised
    if capacity == 10000:
        assert tx.shape[0] > tm.xyz.shape[0]


def test_membership_matches_jax_with_other_neighbourhoods():
    jcfg, jm = _jax_map(n_frames=2)
    cfg = MapConfig(voxel_xysize=20.0, voxel_zsize=25.0, map_capacity=8192)
    tm = convert.map_state_from_numpy([np.asarray(a) for a in jm],
                                      device="cpu")
    pos = np.asarray([5.0, -5.0, 0.0], np.float32)
    for kw in ({"cells_xy": 1, "cells_z": 2}, {"cells_xy": 0, "cells_z": 0},
               {"cells_xy": 6, "cells_z": 3}):
        jx, jv, jn = JG.get_local_map(jm, jnp.asarray(pos), jcfg,
                                      capacity=4096, **kw)
        tx, tv, tn = G.get_local_map(tm, torch.from_numpy(pos), cfg,
                                     capacity=4096, **kw)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        if kw["cells_xy"] == 6:     # above the 128 targets K7 once took
            assert len(G.local_map_offsets(cfg, **kw)) == 174
            assert int(tn) > 0


@pytest.mark.parametrize("threads,rows_per_thread", [(256, 8), (32, 16),
                                                     (8, 4)])
def test_tiled_schedule_matches_plain_and_jax(threads, rows_per_thread):
    """K7's count-then-place with its thread and tile offsets
    (``compact_hits_tiled``, the kernel's schedule: the tile's offset is
    what the look-back sums) against the plain version and JAX
    ``get_local_map``, bit for bit, at the kernel's split (256 threads of
    8 rows: 4 tiles of the 8,192-row map) and at smaller ones (16 and 256
    tiles); also on a map of 10,007 rows (not a multiple of a tile), with
    0 hits and at capacity 0."""
    jcfg, jm = _jax_map()
    cfg = MapConfig(voxel_xysize=20.0, voxel_zsize=25.0, map_capacity=8192)
    tm = convert.map_state_from_numpy([np.asarray(a) for a in jm],
                                      device="cpu")
    pos = np.asarray([-19.9, 25.3, -3.1], np.float32)
    base = G.cell_keys(torch.trunc(torch.from_numpy(pos)), cfg)
    for kw in ({}, {"cells_xy": 6, "cells_z": 3}):
        offs = G.local_map_offsets(cfg, **kw)
        for cap in (100, 8192, 10000):
            got = K7.compact_hits_tiled(tm.xyz, tm.key, tm.valid, base, offs,
                                        cap, threads, rows_per_thread)
            want = K7.compact_hits_plain(tm.xyz, tm.key, tm.valid, base,
                                         offs, cap)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            jx, jv, jn = JG.get_local_map(jm, jnp.asarray(pos), jcfg,
                                          capacity=cap, **kw)
            assert int(got[2]) == int(jn) > 100
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(jx))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(jv))
    rng = np.random.default_rng(threads * rows_per_thread)
    rows = 10007
    xyz = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32))
    offs = G.local_map_offsets(cfg)
    key = np.where(rng.random((rows, 1)) < 0.6,
                   offs[rng.integers(0, len(offs), rows)],
                   rng.integers(-50, 50, (rows, 3)))
    key = torch.from_numpy(key.astype(np.int32))
    valid = torch.from_numpy(rng.random(rows) < 0.3)
    base = torch.zeros(3, dtype=torch.int32)
    for b, cap in ((base, 1024), (base, 0), (base + 100, 64)):
        got = K7.compact_hits_tiled(xyz, key, valid, b, offs, cap, threads,
                                    rows_per_thread)
        want = K7.compact_hits_plain(xyz, key, valid, b, offs, cap)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        if cap == 1024:
            assert int(got[2]) > 1024       # a truncating cut
        if cap == 64:
            assert int(got[2]) == 0         # no target key in the map


@functools.lru_cache(maxsize=1)
def _wide_jax_map():
    """A 2,048-row JAX hash map at the default 40 / 50 m cells over points
    spread 12 km wide, so that a neighbourhood of 141 x 141 cells holds
    some rows and not others."""
    jcfg = JMapConfig(map_capacity=2048)
    rng = np.random.default_rng(23)
    pts = (rng.uniform(-6000, 6000, (1000, 3))
           * np.array([1, 1, 0.01])).astype(np.float32)
    valid = rng.random(1000) > 0.1
    pose = JPose(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                 jnp.zeros(3, jnp.float32))
    return jcfg, JG.update_map(JG.init_map(2048), jnp.asarray(pts),
                               jnp.asarray(valid), pose, jcfg)


@pytest.mark.parametrize("capacity", [None, 64])
def test_get_local_map_matches_jax_above_the_shared_memory_targets(capacity):
    """``cells_xy=70``: 141^2 XY keys plus the z column, past the
    ``MAX_TARGETS`` the kernel holds in shared memory (the card takes the
    device-memory path there); the plain version, its membership compared
    a chunk of rows at a time, against JAX bit for bit."""
    jcfg, jm = _wide_jax_map()
    cfg = MapConfig(map_capacity=2048)
    assert len(G.local_map_offsets(cfg, cells_xy=70)) > K7.MAX_TARGETS
    tm = convert.map_state_from_numpy([np.asarray(a) for a in jm],
                                      device="cpu")
    pos = np.asarray([130.0, -90.0, 0.4], np.float32)
    jx, jv, jn = JG.get_local_map(jm, jnp.asarray(pos), jcfg, cells_xy=70,
                                  capacity=capacity)
    tx, tv, tn = G.get_local_map(tm, torch.from_numpy(pos), cfg, cells_xy=70,
                                 capacity=capacity)
    assert 64 < int(tn) == int(jn) < int(tm.valid.sum())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("chunk", [1, 100, 27 * 1000, 1 << 24])
def test_chunked_membership_is_the_whole_compare(chunk):
    """``_membership`` a chunk of (row, target) pairs at a time (from one
    row a chunk to the whole map at once) is the unchunked broadcast
    compare, bit for bit, at 27 and 174 targets on 10,007 rows with hits,
    misses, invalid rows and a shifted base."""
    rng = np.random.default_rng(chunk % 97)
    cfg = MapConfig(voxel_xysize=20.0, voxel_zsize=25.0)
    rows = 10007
    for kw in ({}, {"cells_xy": 6, "cells_z": 3}):
        offs = G.local_map_offsets(cfg, **kw)
        key = np.where(rng.random((rows, 1)) < 0.5,
                       offs[rng.integers(0, len(offs), rows)] + 3,
                       rng.integers(-40, 40, (rows, 3)))
        key = torch.from_numpy(key.astype(np.int32))
        valid = torch.from_numpy(rng.random(rows) < 0.8)
        base = torch.tensor([3, 3, 3], dtype=torch.int32)
        targets = base[None, :] + torch.from_numpy(offs)
        whole = torch.any(torch.all(key[:, None, :] == targets[None], -1),
                          -1) & valid
        got = K7._membership(key, valid, base, offs, chunk=chunk)
        assert torch.equal(got, whole)
        assert 0 < int(got.sum()) < int(valid.sum())
