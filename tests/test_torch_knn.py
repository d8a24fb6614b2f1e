"""Port parity: K3 (kNN with coordinates), its wrapper helpers and the line
fit.

* K3 plain version against ``knn_coords_pallas(interpret=True,
  max_radius=1.0)``: d2 within 1e-5 relative for every pair with d2 < 1
  (inside the pruning radius both are exact), identical coordinates where
  the 5th-NN gate passes.
* The CUDA route's tensor work (spatial sort, tile boxes, pair flags, FAR
  encoding, query un-permutation) runs on the CPU here: its output, fed to
  a brute force that stands in for the kernel, gives the plain version's
  answer.
* K4: the batched plain version against ``knn_coords_pallas_batched(
  interpret=True)`` with and without ``max_radius``, and the batched
  wrapper work against the solo one lane by lane.
* ``line_correspondences`` against the JAX one (``pallas_interpret``):
  validity equal except where the eigenvalue ratio sits within float32
  noise of ``eig_ratio`` (``MAX_GATE_FLIPS`` rows allowed; measured 0),
  lpa/lpb to 1e-6 where both accept.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.ops import knn_pallas as JK
from liodom_tpu.ops import neighbors as JN

from liodom_tpu_torch.ops import knn_pallas as K
from liodom_tpu_torch.ops import neighbors as N

torch.set_num_threads(1)

MAX_GATE_FLIPS = 2


def _scene(seed, e=256, m=4096, invalid=0.2):
    """Clustered points (line-like and blob-like) so that many queries have
    5 neighbours within 1 m and the tiles actually prune."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-30, 30, (24, 3))
    dirs = rng.normal(size=(24, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    def sample(n):
        c = rng.integers(0, 24, n)
        s = rng.uniform(-3, 3, n)[:, None]
        return (centers[c] + s * dirs[c]
                + rng.normal(size=(n, 3)) * 0.15).astype(np.float32)

    q, r = sample(e), sample(m)
    qm = rng.random(e) > invalid
    rm = rng.random(m) > invalid
    return q, qm, r, rm


def _check_knn(d_got, c_got, d_ref, c_ref, qm):
    near = d_ref < 1.0
    assert near.sum() > 100
    np.testing.assert_allclose(d_got[near], d_ref[near], rtol=1e-5, atol=0)
    gate = qm & (d_ref[:, -1] < 1.0)
    assert gate.sum() > 20
    np.testing.assert_array_equal(c_got[gate], c_ref[gate])
    # beyond the gate a row reads the same or _BIG, never a smaller value
    assert (d_got[~near] >= 1.0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knn_plain_matches_pallas_interpret(seed):
    q, qm, r, rm = _scene(seed)
    d_j, c_j = JK.knn_coords_pallas(jnp.asarray(q), jnp.asarray(qm),
                                    jnp.asarray(r), jnp.asarray(rm), k=5,
                                    interpret=True, max_radius=1.0)
    d_t, c_t = K.knn_coords_plain(torch.from_numpy(q), torch.from_numpy(qm),
                                  torch.from_numpy(r), torch.from_numpy(rm))
    d_t, c_t = d_t.numpy(), c_t.numpy()
    assert (d_t[~qm] >= K._BIG * 0.99).all()
    _check_knn(np.asarray(d_j), np.asarray(c_j), d_t, c_t, qm)


def _emulated_launch(q4, r4, flags, qperm):
    """What csrc/knn_coords.cu computes, in plain PyTorch: every ref of a
    flagged tile pair is a candidate (FAR-encoded refs included), the best
    5 are read back with the FAR and query-mask rules and written at each
    query's original index."""
    tile_e, tile_m = K.TILE_E, K.TILE_M
    e = qperm.shape[0]
    d = torch.full((q4.shape[0], 5), K._BIG)
    c = torch.zeros((q4.shape[0], 5, 3))
    for et in range(flags.shape[0]):
        cols = [torch.arange(mt * tile_m, (mt + 1) * tile_m)
                for mt in range(flags.shape[1]) if flags[et, mt]]
        if not cols:
            continue
        refs = r4[torch.cat(cols), :3]
        rows = slice(et * tile_e, (et + 1) * tile_e)
        dd, cc = K.knn_coords_plain(q4[rows, :3],
                                    torch.ones(tile_e, dtype=torch.bool),
                                    refs, torch.ones(len(refs),
                                                     dtype=torch.bool))
        d[rows], c[rows] = dd, cc
    d = torch.where(d > K._FAR_PICK_D2, torch.full_like(d, K._BIG), d)
    d = torch.where(q4[:, 3:4] > 0, d, torch.full_like(d, K._BIG))
    out_d = torch.empty((e, 5))
    out_c = torch.empty((e, 5, 3))
    out_d[qperm.long()] = d[:e]
    out_c[qperm.long()] = c[:e]
    return out_d, out_c


@pytest.mark.parametrize("presorted", [False, True])
def test_cuda_route_wrapper_matches_plain(presorted):
    q, qm, r, rm = _scene(3, e=300, m=3000)
    qt, qmt = torch.from_numpy(q), torch.from_numpy(qm)
    rt, rmt = torch.from_numpy(r), torch.from_numpy(rm)
    if presorted:
        rt, rmt = K.spatial_sort_points(rt, rmt)
    q4, r4, flags, qperm = (t[0] for t in K.knn_prepare(
        qt[None], qmt[None], rt[None], rmt[None], 1.0,
        ref_presorted=presorted))
    assert q4.shape[0] % K.TILE_E == 0 and r4.shape[0] % K.TILE_M == 0
    assert flags.dtype == torch.int32 and 0 < int(flags.sum()) < flags.numel()
    d_e, c_e = _emulated_launch(q4, r4, flags, qperm)
    d_p, c_p = K.knn_coords_plain(qt, qmt, rt, rmt)
    _check_knn(d_e.numpy(), c_e.numpy(), d_p.numpy(), c_p.numpy(), qm)


def test_wrapper_helpers_match_jax():
    q, qm, r, rm = _scene(4, e=256, m=2048)
    for pts, mask in ((q, qm), (r, rm)):
        np.testing.assert_array_equal(
            K._spatial_order(torch.from_numpy(pts), torch.from_numpy(mask),
                             cell=2.0).numpy(),
            np.asarray(JK._spatial_order(jnp.asarray(pts), jnp.asarray(mask),
                                         cell=2.0)))
        xs, ms = K.spatial_sort_points(torch.from_numpy(pts),
                                       torch.from_numpy(mask))
        jxs, jms = JK.spatial_sort_points(jnp.asarray(pts), jnp.asarray(mask))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
        np.testing.assert_array_equal(ms.numpy(), np.asarray(jms))
    boxes_t = [K._tile_aabbs(torch.from_numpy(p), torch.from_numpy(v), 64)
               for p, v in ((q, qm), (r, rm))]
    boxes_j = [JK._tile_aabbs(jnp.asarray(p), jnp.asarray(v), 64)
               for p, v in ((q, qm), (r, rm))]
    for bt, bj in zip(boxes_t, boxes_j):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for radius in (None, 1.0):
        ft = K._pair_flags(*boxes_t[0], *boxes_t[1], radius)
        fj = JK._pair_flags(*boxes_j[0], *boxes_j[1], radius)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_sym3_eigenvalues_match_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2)
    cov[0] = np.eye(3, dtype=np.float32) * 2.0     # p == 0 branch
    got = N.sym3_eigenvalues(torch.from_numpy(cov)).numpy()
    want = np.asarray(JN.sym3_eigenvalues(jnp.asarray(cov)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.linalg.eigvalsh(cov.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_line_correspondences_match_jax(seed):
    q, qm, r, rm = _scene(seed)
    want = JN.line_correspondences(jnp.asarray(q), jnp.asarray(qm),
                                   jnp.asarray(r), jnp.asarray(rm),
                                   knn_impl="pallas_interpret")
    got = N.line_correspondences(torch.from_numpy(q), torch.from_numpy(qm),
                                 torch.from_numpy(r), torch.from_numpy(rm))
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    assert gv.sum() > 20
    assert int((wv != gv).sum()) <= MAX_GATE_FLIPS
    both = wv & gv
    np.testing.assert_allclose(got.lpa.numpy()[both],
                               np.asarray(want.lpa)[both], atol=1e-6)
    np.testing.assert_allclose(got.lpb.numpy()[both],
                               np.asarray(want.lpb)[both], atol=1e-6)


def _batched_scene(seeds, e=192, m=1536):
    scenes = [_scene(s, e=e, m=m) for s in seeds]
    return tuple(np.stack([sc[i] for sc in scenes]) for i in range(4))


@pytest.mark.parametrize("max_radius", [None, 1.0])
def test_knn_batched_plain_matches_pallas_batched_interpret(max_radius):
    """K4's plain version against the TPU kernel in interpret mode, each
    lane a distinct scene: compared inside the radius, as K3 is."""
    q, qm, r, rm = _batched_scene((7, 8, 9))
    d_j, c_j = JK.knn_coords_pallas_batched(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm),
        k=5, tile_e=64, tile_m=512, interpret=True, max_radius=max_radius)
    d_t, c_t = K.knn_coords_plain(*map(torch.from_numpy, (q, qm, r, rm)))
    assert d_t.shape == (3, 192, 5) and c_t.shape == (3, 192, 5, 3)
    for b in range(3):
        _check_knn(np.asarray(d_j[b]), np.asarray(c_j[b]), d_t[b].numpy(),
                   c_t[b].numpy(), qm[b])
        d_s, c_s = K.knn_coords_plain(*(torch.from_numpy(x[b])
                                        for x in (q, qm, r, rm)))
        assert torch.equal(d_t[b], d_s) and torch.equal(c_t[b], c_s)


@pytest.mark.parametrize("presorted", [False, True])
def test_batched_wrapper_matches_solo_per_lane(presorted):
    """Each batch element gets its own sort, boxes and flags: the batched
    preparation equals that element's alone (K3's batch of one), so
    K4's offsets see exactly K3's layout."""
    q, qm, r, rm = map(torch.from_numpy, _batched_scene((10, 11),
                                                        e=300, m=3000))
    if presorted:
        r, rm = K.spatial_sort_points(r, rm)
        for b in range(2):
            rs, rms = K.spatial_sort_points(*map(torch.from_numpy,
                                                 _scene(10 + b, e=300,
                                                        m=3000)[2:]))
            assert torch.equal(r[b], rs) and torch.equal(rm[b], rms)
    prep = K.knn_prepare(q, qm, r, rm, 1.0, ref_presorted=presorted)
    assert prep[2].shape[0] == 2 and prep[2].dtype == torch.int32
    for b in range(2):
        solo = K.knn_prepare(q[b:b + 1], qm[b:b + 1], r[b:b + 1],
                             rm[b:b + 1], 1.0, ref_presorted=presorted)
        for got, want in zip(prep, solo):
            assert torch.equal(got[b], want[0])
        d_e, c_e = _emulated_launch(*(t[b] for t in prep))
        d_p, c_p = K.knn_coords_plain(q[b], qm[b], r[b], rm[b])
        _check_knn(d_e.numpy(), c_e.numpy(), d_p.numpy(), c_p.numpy(),
                   qm[b].numpy())
