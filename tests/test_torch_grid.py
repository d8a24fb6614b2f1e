"""Port parity of the hash-grid map (``liodom_tpu_torch/mapping/grid.py``)
against ``liodom_tpu/mapping/grid.py`` on the CPU.

The port keeps the JAX package's two uint32 code words as one int64 code
``code1 << 26 | code2`` with one empty sentinel; every comparison converts
the JAX words that way.  Integer and boolean outputs are exact: cell keys,
codes, hashes, decoded keys, probe slots, claimed/failed flags, the slot
table, map keys, validity and overflow.  Centroids are held to 1e-5 m
(the fold divides float32 sums, which XLA may fuse differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.core.config import MapConfig as JMapConfig
from liodom_tpu.core.pose import Pose as JPose
from liodom_tpu.mapping import grid as JG

from liodom_tpu_torch import convert
from liodom_tpu_torch.core.config import MapConfig
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.ops import probe_insert as PI

torch.set_num_threads(1)

MAXU32 = 0xFFFFFFFF
CONFIGS = {
    "default": {},
    "small_cells": dict(voxel_xysize=20.0, voxel_zsize=25.0),
}


def _cfgs(name, **kw):
    kw = {**CONFIGS.get(name, {}), **kw}
    return JMapConfig(**kw), MapConfig(**kw)


def jax_code(c1, c2):
    """The port's int64 code of the JAX package's (code1, code2) words."""
    c1 = np.asarray(c1).astype(np.int64)
    c2 = np.asarray(c2).astype(np.int64)
    return np.where(c1 == MAXU32, G.EMPTY, (c1 << 26) | c2)


def _points(seed, n=120_000, scale=300.0):
    """Random points plus points on leaf and cell boundaries (multiples of
    0.4 m and of the cell sizes), where a floor is decided by the last
    bit."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    xyz[:4000] = (rng.integers(-200, 200, (4000, 3)) * 0.4).astype(np.float32)
    xyz[4000:6000] = (rng.integers(-20, 20, (2000, 3)) * 20.0).astype(
        np.float32)
    ok = rng.random(n) > 0.1
    return xyz, ok


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cell_keys_codes_and_decode_exact(name):
    jcfg, cfg = _cfgs(name)
    xyz, ok = _points(1)
    np.testing.assert_array_equal(
        G.cell_keys(torch.from_numpy(xyz), cfg).numpy(),
        np.asarray(JG.cell_keys(jnp.asarray(xyz), jcfg)))
    np.testing.assert_array_equal(
        G._leaf_index(torch.from_numpy(xyz), cfg.resolution).numpy(),
        np.asarray(JG._leaf_index(jnp.asarray(xyz), jcfg.resolution)))
    j1, j2 = JG._packed_codes(jnp.asarray(xyz), jnp.asarray(ok), jcfg)
    code = G._packed_codes(torch.from_numpy(xyz), torch.from_numpy(ok), cfg)
    np.testing.assert_array_equal(code.numpy(), jax_code(j1, j2))
    assert int(code[torch.from_numpy(ok)].max()) < 2**57
    np.testing.assert_array_equal(
        G._decode_cell_keys(code, cfg).numpy()[ok],
        np.asarray(JG._decode_cell_keys(j1, j2, jcfg))[ok])


@pytest.mark.parametrize("n", [97, 16384, 524288])
def test_hash_pair_exact(n):
    rng = np.random.default_rng(n)
    k1 = rng.integers(0, 2**32, 120_000, dtype=np.uint64).astype(np.uint32)
    k2 = rng.integers(0, 2**32, 120_000, dtype=np.uint64).astype(np.uint32)
    k1[:10] = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, MAXU32, 0xFFFF, 0x10000,
               0x9E3779B1, 0x85EBCA77]
    assert (k1 >= 2**31).sum() > 50_000
    want = np.asarray(JG._hash_pair(jnp.asarray(k1), jnp.asarray(k2), n))
    got = PI.hash_pair(torch.from_numpy(k1.astype(np.int64)),
                       torch.from_numpy(k2.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), want)


def _probe_case(seed, n, n_codes, n_distinct, prefill):
    """Codes with duplicates (n_distinct < n_codes) into a table of n slots,
    some already occupied: collisions, shared slots and, when the distinct
    codes outnumber the free slots, rows that exhaust _MAX_PROBES."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n_distinct + prefill, 3)) * 50).astype(np.float32)
    jcfg, cfg = _cfgs("default")
    j1, j2 = JG._packed_codes(jnp.asarray(xyz),
                              jnp.ones(len(xyz), bool), jcfg)
    j1, j2 = np.asarray(j1), np.asarray(j2)
    tab1 = np.full(n, MAXU32, np.uint32)
    tab2 = np.full(n, MAXU32, np.uint32)
    slots = rng.choice(n, prefill, replace=False)
    tab1[slots], tab2[slots] = j1[:prefill], j2[:prefill]
    pick = rng.integers(0, n_distinct + prefill, n_codes)
    k1, k2 = j1[pick], j2[pick]
    active = rng.random(n_codes) > 0.15
    return tab1, tab2, k1, k2, active


@pytest.mark.parametrize("case", [
    (0, 4096, 3000, 1500, 500),     # duplicates and collisions, no failures
    (1, 128, 600, 400, 40),         # more codes than slots: forced failures
])
def test_probe_insert_slot_for_slot(case):
    tab1, tab2, k1, k2, active = _probe_case(*case)
    jt1, jt2, jslot, jclaimed, jfailed = JG._probe_insert(
        jnp.asarray(tab1), jnp.asarray(tab2), jnp.asarray(k1),
        jnp.asarray(k2), jnp.asarray(active))
    tab, slot, claimed, failed = PI.probe_insert(
        torch.from_numpy(jax_code(tab1, tab2)),
        torch.from_numpy(jax_code(k1, k2)), torch.from_numpy(active))
    np.testing.assert_array_equal(tab.numpy(), jax_code(jt1, jt2))
    np.testing.assert_array_equal(failed.numpy(), np.asarray(jfailed))
    np.testing.assert_array_equal(claimed.numpy(), np.asarray(jclaimed))
    home = active & ~np.asarray(jfailed)
    np.testing.assert_array_equal(slot.numpy()[home], np.asarray(jslot)[home])
    assert int(claimed.sum()) > 0
    if case[1] == 128:
        assert int(failed.sum()) > 0 and int((tab == G.EMPTY).sum()) == 0


def _frames(seed, n_frames=5, e=1500):
    """Edge-like frames: clustered points (many sharing a leaf) with some
    padding rows, and a moving pose."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n_frames):
        centers = rng.uniform(-30, 30, (60, 3)).astype(np.float32)
        pts = (centers[rng.integers(0, 60, e)]
               + rng.normal(size=(e, 3)).astype(np.float32) * 0.5)
        valid = rng.random(e) > 0.2
        pts = np.where(valid[:, None], pts, 0.0).astype(np.float32)
        ang = 0.05 * f
        q = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)], np.float32)
        t = np.array([1.1 * f, 0.3 * f, 0.02 * f], np.float32)
        out.append((pts, valid, q, t))
    return out


def _jpose(q, t):
    return JPose(jnp.asarray(q), jnp.asarray(t))


def _tpose(q, t):
    return Pose(torch.from_numpy(q), torch.from_numpy(t))


def assert_map_equal(port, jmap, xyz_tol=1e-5):
    np.testing.assert_array_equal(port.code.numpy(),
                                  jax_code(jmap.code1, jmap.code2))
    np.testing.assert_array_equal(port.key.numpy(), np.asarray(jmap.key))
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(jmap.valid))
    assert int(port.overflow) == int(jmap.overflow)
    np.testing.assert_allclose(port.xyz.numpy(), np.asarray(jmap.xyz),
                               atol=xyz_tol, rtol=0)


@pytest.mark.parametrize("capacity", [16384, 4096])
def test_update_map_matches_jax_over_frames(capacity):
    """5 frames into a roomy table and into one that fills (overflow > 0)."""
    jcfg, cfg = _cfgs("small_cells", map_capacity=capacity)
    jm, tm = JG.init_map(capacity), G.init_map(capacity, device="cpu")
    for pts, valid, q, t in _frames(2):
        jm = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid),
                           _jpose(q, t), jcfg)
        tm = G.update_map(tm, torch.from_numpy(pts), torch.from_numpy(valid),
                          _tpose(q, t), cfg)
        assert_map_equal(tm, jm)
    assert int(tm.valid.sum()) > 1000
    if capacity == 4096:
        assert int(tm.overflow) > 0


@pytest.mark.parametrize("name,packable", [("default", True),
                                           ("nonpackable", False)])
def test_update_map_full_matches_jax(name, packable):
    kw = dict(resolution=0.1) if not packable else {}
    jcfg, cfg = _cfgs(name, **kw)
    assert G.packable(cfg) is packable is JG.packable(jcfg)
    cap = 1500
    jm, tm = JG.init_map(cap), G.init_map(cap, device="cpu")
    for pts, valid, q, t in _frames(3, n_frames=3, e=1200):
        jm = JG.update_map_full(jm, jnp.asarray(pts), jnp.asarray(valid),
                                _jpose(q, t), jcfg)
        tm = G.update_map_full(tm, torch.from_numpy(pts),
                               torch.from_numpy(valid), _tpose(q, t), cfg)
        assert_map_equal(tm, jm)
    assert int(tm.overflow) > 0          # the sorted soup overflowed its rows
    if not packable:
        # update_map falls back to the sorted soup on a non-packable config
        pts, valid, q, t = _frames(4, n_frames=1)[0]
        a = G.update_map(tm, torch.from_numpy(pts), torch.from_numpy(valid),
                         _tpose(q, t), cfg)
        b = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid),
                          _jpose(q, t), jcfg)
        assert_map_equal(a, b)


def test_hash_map_and_sorted_soup_hold_one_point_set():
    _, cfg = _cfgs("small_cells")
    hm, fm = G.init_map(8192, device="cpu"), G.init_map(8192, device="cpu")
    for pts, valid, q, t in _frames(5, n_frames=3):
        args = (torch.from_numpy(pts), torch.from_numpy(valid), _tpose(q, t),
                cfg)
        hm, fm = G.update_map(hm, *args), G.update_map_full(fm, *args)
    hv, fv = hm.valid.numpy(), fm.valid.numpy()
    assert hv.sum() == fv.sum() > 1000
    h_order = np.argsort(hm.code.numpy()[hv], kind="stable")
    f_order = np.argsort(fm.code.numpy()[fv], kind="stable")
    np.testing.assert_array_equal(hm.code.numpy()[hv][h_order],
                                  fm.code.numpy()[fv][f_order])
    np.testing.assert_array_equal(hm.key.numpy()[hv][h_order],
                                  fm.key.numpy()[fv][f_order])
    np.testing.assert_allclose(hm.xyz.numpy()[hv][h_order],
                               fm.xyz.numpy()[fv][f_order], atol=1e-4)


def test_diagnostics_and_offsets_match_jax():
    jcfg, cfg = _cfgs("small_cells")
    jm, tm = JG.init_map(8192), G.init_map(8192, device="cpu")
    for pts, valid, q, t in _frames(6, n_frames=2):
        jm = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid),
                           _jpose(q, t), jcfg)
        tm = G.update_map(tm, torch.from_numpy(pts), torch.from_numpy(valid),
                          _tpose(q, t), cfg)
    assert G.count_cells(tm) == JG.count_cells(jm) > 1
    assert G.map_entropy(tm) == JG.map_entropy(jm)
    assert G.map_entropy(tm, 7) == JG.map_entropy(jm, 7)
    assert G.count_cells(G.init_map(16, device="cpu")) == 0
    assert [G._next_prime(k) for k in (0, 2, 90, 1000)] == \
        [JG._next_prime(k) for k in (0, 2, 90, 1000)]
    for kw in ({}, {"cells_xy": 1, "cells_z": 2}, {"cells_xy": 0}):
        np.testing.assert_array_equal(G.local_map_offsets(cfg, **kw),
                                      JG.local_map_offsets(jcfg, **kw))
    xyz, valid = G.get_map(tm)
    assert xyz is tm.xyz and valid is tm.valid


def test_update_continues_from_a_converted_jax_map():
    """A mid-course JAX map, as numpy, becomes the port's map; the next
    update agrees slot for slot."""
    jcfg, cfg = _cfgs("small_cells")
    frames = _frames(7, n_frames=4)
    jm = JG.init_map(8192)
    for pts, valid, q, t in frames[:3]:
        jm = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid),
                           _jpose(q, t), jcfg)
    as_np = [np.asarray(a) for a in jm]
    tm = convert.map_state_from_numpy(as_np, device="cpu")
    assert_map_equal(tm, jm, xyz_tol=0.0)
    tm2 = convert.map_state_from_numpy(dict(zip(convert.MAP_KEYS, as_np)),
                                       device="cpu")
    assert torch.equal(tm2.code, tm.code)
    pts, valid, q, t = frames[3]
    jm = JG.update_map(jm, jnp.asarray(pts), jnp.asarray(valid),
                       _jpose(q, t), jcfg)
    tm = G.update_map(tm, torch.from_numpy(pts), torch.from_numpy(valid),
                      _tpose(q, t), cfg)
    assert_map_equal(tm, jm)
    with pytest.raises(KeyError):
        convert.map_state_from_numpy({"xyz": as_np[0]}, device="cpu")
