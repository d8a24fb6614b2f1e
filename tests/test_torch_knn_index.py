"""Port parity: K5, the index-returning exact 5-NN (``knn_pallas.py:44``,
wrapper ``knn_pallas`` :144), and ``neighbors.knn`` / ``knn_auto``.

* The plain version (``knn_index_plain``, which ``neighbors.knn`` is)
  against the TPU kernel in interpret mode, ``knn_pallas(interpret=True)``:
  all refs valid, invalid refs, invalid queries, E and M not multiples of
  the tiles, fewer valid refs than k, and the radius path.  d2 within 1e-5
  relative and indices identical wherever the plain d2 < 1e29 (within the
  radius on the radius path); rows whose neighbours' d2 sit within 1e-6
  relative of each other would make the order ambiguous, and are counted:
  0 on these seeds.  Invalid refs are never picked, invalid queries read
  ``_BIG``.
* ``neighbors.knn`` against JAX's XLA ``neighbors.knn``, which expands d2
  as |q|^2 - 2 q.r + |r|^2: d2 within that form's cancellation error, and
  indices identical except where JAX's pick lies within that error of the
  plain one's distance.
* The CUDA route's tensor work on the CPU, with the launch replaced by a
  brute force over the flagged tiles that stands in for
  ``csrc/knn_index.cu``: without a radius nothing is sorted and the indices
  address the caller's ref; with one, they come back through the ref
  permutation.  Either gives the plain version's answer.
* Other k: the plain K3, K6 and K5 at k = 3, 8, 17 and 32 against
  ``knn_coords_pallas`` / ``knn_lines_pallas`` / ``knn_pallas`` in
  interpret mode, at the bars above; the three CUDA wrappers (K3 on a
  pair and on a batch) at k = 17 and 32 through ``knn_launch``, with
  ``kernels.launch`` replaced by a stand-in that runs the plain launch
  (``knn_launch_plain`` and kin): k above ``MAX_K`` reaches the
  ``*_any_k`` entry point, k = 16 the register walk's, and the answer is
  the plain version's; and 3-frame ``image_step`` courses at ``knn_k=3`` and
  ``knn_k=20``, the port on the CPU against JAX within 1 cm and 1e-3 rad
  with equal edge counts.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import RawScan as JRawScan
from liodom_tpu.core.synth import BoxWorld, drive_trajectory_6dof
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops import features as JF
from liodom_tpu.ops import knn_pallas as JK
from liodom_tpu.ops import neighbors as JN

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops import knn_pallas as K
from liodom_tpu_torch.ops import neighbors as N

from test_torch_knn import _check_knn, _scene
from test_torch_knn_lines import BOUNDARY_REL, _line_map
from test_torch_pipeline import _quat_angle

torch.set_num_threads(1)

# name: (seed, E, M, invalid share, valid refs kept, max_radius)
CASES = {
    "all_valid": (0, 256, 4096, 0.0, None, None),
    "invalid": (1, 300, 3000, 0.2, None, None),
    "ragged": (2, 131, 2500, 0.2, None, None),
    "few_refs": (3, 100, 700, 0.0, 3, None),
    "radius": (4, 300, 3000, 0.2, None, 1.0),
}


def _case(name):
    seed, e, m, invalid, keep, radius = CASES[name]
    q, qm, r, rm = _scene(seed, e=e, m=m, invalid=invalid)
    if keep is not None:
        rm = np.zeros_like(rm)
        rm[[5, 77, 400][:keep]] = True
    return q, qm, r, rm, radius


def _near_ties(d2) -> int:
    """Rows where two finite neighbour distances are within 1e-6
    relative."""
    fin = d2 < 1e29
    gap = np.abs(np.diff(d2, axis=1)) <= 1e-6 * np.abs(d2[:, 1:])
    return int((gap & fin[:, 1:] & fin[:, :-1]).any(axis=1).sum())


@pytest.mark.parametrize("name", list(CASES))
def test_knn_index_plain_matches_pallas_interpret(name):
    q, qm, r, rm, radius = _case(name)
    dj, ij = (np.asarray(a) for a in JK.knn_pallas(
        *map(jnp.asarray, (q, qm, r, rm)), k=5, interpret=True,
        max_radius=radius))
    dt, it = N.knn(*map(torch.from_numpy, (q, qm, r, rm)))
    assert dt.dtype == torch.float32 and it.dtype == torch.int32
    dt, it = dt.numpy(), it.numpy()
    lim = dt < (radius * radius if radius else 1e29)
    assert lim.sum() > 100
    assert _near_ties(dt) == 0
    np.testing.assert_allclose(dj[lim], dt[lim], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ij[lim], it[lim])
    assert (dt[~qm] >= 1e29).all() and (dj[~qm] >= 1e29).all()
    fin = dt < 1e29
    assert rm[it[fin]].all()                   # no invalid ref is picked
    assert (it >= 0).all() and (it < len(r)).all()
    if name == "few_refs":
        assert (fin.sum(1)[qm] == 3).all()
        assert (it[:, 3:] == len(r) - 1).all()
        assert (dj[qm][:, 3:] >= 1e29).all()
    if radius is not None:                     # beyond it: the same or _BIG
        assert (dj[~lim] >= radius * radius).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_matches_jax_xla_knn(seed):
    q, qm, r, rm = _scene(seed, e=300, m=3000)
    dj, ij = (np.asarray(a) for a in JN.knn(*map(jnp.asarray,
                                                 (q, qm, r, rm)), k=5))
    dt, it = (a.numpy() for a in N.knn(*map(torch.from_numpy,
                                            (q, qm, r, rm))))
    fin = dt < 1e29
    np.testing.assert_array_equal(fin, dj < 1e29)
    # the expanded form's rounding: a few float32 ulps of |q|^2 + |r|^2
    q2 = (q.astype(np.float64) ** 2).sum(-1)[:, None]
    r2 = (r.astype(np.float64) ** 2).sum(-1)[it]
    tol = 8 * np.finfo(np.float32).eps * (q2 + r2)
    assert (np.abs(dj - dt)[fin] <= tol[fin]).all()
    diff = fin & (ij != it)
    exact_j = ((q[:, None, :].astype(np.float64)
                - r[ij].astype(np.float64)) ** 2).sum(-1)
    assert (np.abs(exact_j - dt)[diff] <= 2 * tol[diff]).all()
    assert diff.any(axis=1).sum() <= 0.05 * fin.all(axis=1).sum()


def _emulated_index_launch(q4, r4, flags, qperm, m, k=5):
    """What csrc/knn_index.cu computes, in plain PyTorch: per query tile,
    the best k (d2, r4 row) over the rows of its flagged ref tiles
    (FAR-encoded refs included), read back with the FAR, query-mask and
    clamp rules and written at each query's original index."""
    b, e = qperm.shape
    out_d = torch.empty((b, e, k))
    out_i = torch.empty((b, e, k), dtype=torch.int32)
    for bb in range(b):
        d = torch.full((q4.shape[1], k), K._BIG)
        idx = torch.zeros((q4.shape[1], k), dtype=torch.int64)
        for et in range(flags.shape[1]):
            rows = slice(et * K.TILE_E, (et + 1) * K.TILE_E)
            cols = [torch.arange(mt * K.TILE_M, (mt + 1) * K.TILE_M)
                    for mt in range(flags.shape[2]) if flags[bb, et, mt]]
            if not cols:
                continue
            cols = torch.cat(cols)
            ones = torch.ones(len(cols), dtype=torch.bool)
            dd, ii = K.knn_index_plain(q4[bb, rows, :3],
                                       torch.ones(K.TILE_E, dtype=torch.bool),
                                       r4[bb, cols, :3], ones, k)
            d[rows], idx[rows] = dd, cols[ii.long()]
        d = torch.where(d > K._FAR_PICK_D2, torch.full_like(d, K._BIG), d)
        d = torch.where(q4[bb, :, 3:4] > 0, d, torch.full_like(d, K._BIG))
        out_d[bb, qperm[bb].long()] = d[:e]
        out_i[bb, qperm[bb].long()] = torch.clamp(idx[:e], max=m - 1).to(
            torch.int32)
    return out_d, out_i


@pytest.mark.parametrize("radius", [None, 1.0])
def test_cuda_route_wrapper_matches_plain(radius, monkeypatch):
    q, qm, r, rm = (torch.from_numpy(a) for a in _scene(5, e=300, m=3000))
    prep = K.knn_prepare(q[None], qm[None], r[None], rm[None], radius)
    if radius is None:                        # nothing sorted
        assert torch.equal(prep[3][0], torch.arange(300, dtype=torch.int32))
        assert torch.equal(prep[0][0, :300, :3], q)
        assert torch.equal(prep[1][0, :3000, :3][rm], r[rm])
    monkeypatch.setattr(
        K, "knn_launch", lambda source, q4, r4, flags, qperm, k, ints, floats:
        _emulated_index_launch(q4, r4, flags, qperm, *ints, k))
    d_e, i_e = K.knn_index_cuda(q, qm, r, rm, max_radius=radius)
    d_p, i_p = K.knn_index_plain(q, qm, r, rm)
    lim = d_p < (radius * radius if radius else 1e29)
    assert int(lim.sum()) > 500
    assert torch.equal(d_e[lim], d_p[lim])
    assert torch.equal(i_e[lim], i_p[lim])
    # the batched form: each element its own sort and flags
    qb, qmb, rb, rmb = (torch.stack([x, x.flip(0)]) for x in (q, qm, r, rm))
    d_b, i_b = K.knn_index_cuda(qb, qmb, rb, rmb, max_radius=radius)
    assert torch.equal(d_b[0], d_e) and torch.equal(i_b[0], i_e)
    d_p1, i_p1 = K.knn_index_plain(qb[1], qmb[1], rb[1], rmb[1])
    lim1 = d_p1 < (radius * radius if radius else 1e29)
    assert torch.equal(i_b[1][lim1], i_p1[lim1])


def test_knn_auto_takes_the_plain_version_on_the_cpu():
    q, qm, r, rm = (torch.from_numpy(a) for a in _scene(6, e=200, m=1500))
    before = K.kernels.launch_counts()
    got = N.knn_auto(q, qm, r, rm, k=5)
    want = N.knn(q, qm, r, rm, k=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got_b = N.knn_auto(q[None], qm[None], r[None], rm[None])
    assert torch.equal(got_b[1][0], want[1])
    assert K.kernels.launch_counts() == before
    with pytest.raises(ValueError, match="no kernel"):
        N.knn_auto(q.to("meta"), qm.to("meta"), r.to("meta"), rm.to("meta"))


@pytest.mark.parametrize("k", [3, 8, 17, 32])
def test_index_plain_at_k_matches_pallas_interpret(k):
    q, qm, r, rm = _scene(7, e=300, m=3000)
    dj, ij = (np.asarray(a) for a in JK.knn_pallas(
        *map(jnp.asarray, (q, qm, r, rm)), k=k, interpret=True))
    dt, it = (a.numpy() for a in K.knn_index_plain(
        *map(torch.from_numpy, (q, qm, r, rm)), k))
    assert dt.shape == (300, k) and it.shape == (300, k)
    fin = dt < 1e29
    assert fin.sum() > 100 * k and _near_ties(dt) == 0
    np.testing.assert_allclose(dj[fin], dt[fin], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ij[fin], it[fin])
    assert (dt[~qm] >= 1e29).all() and (dj[~qm] >= 1e29).all()


@pytest.mark.parametrize("k", [3, 8, 17, 32])
def test_coords_plain_at_k_matches_pallas_interpret(k):
    q, qm, r, rm = _scene(8)
    d_j, c_j = JK.knn_coords_pallas(*map(jnp.asarray, (q, qm, r, rm)), k=k,
                                    interpret=True, max_radius=1.0)
    d_t, c_t = K.knn_coords_plain(*map(torch.from_numpy, (q, qm, r, rm)), k)
    assert d_t.shape == (q.shape[0], k)
    _check_knn(np.asarray(d_j), np.asarray(c_j), d_t.numpy(), c_t.numpy(),
               qm)


@pytest.mark.parametrize("k", [3, 8, 17, 32])
def test_lines_plain_at_k_matches_pallas_interpret(k):
    q, qm, r, rm = _line_map()
    want = JK.knn_lines_pallas(*map(jnp.asarray, (q, qm, r, rm)), k=k,
                               tile_e=64, tile_m=512, interpret=True)
    got = K.knn_lines_plain(*map(torch.from_numpy, (q, qm, r, rm)), k)
    # valid equal except where the plain eigenvalues of the k neighbours
    # sit at the ratio gate
    _, near = K.knn_coords_plain(*map(torch.from_numpy, (q, qm, r, rm)), k)
    zm = near - near.mean(dim=1, keepdim=True)
    eigs = N.sym3_eigenvalues(torch.einsum("eki,ekj->eij", zm, zm)).numpy()
    gap = np.abs(eigs[:, 2] - 3.0 * eigs[:, 1]) / np.maximum(
        np.abs(eigs[:, 2]), 1e-30)
    gv, wv = got[2].numpy(), np.asarray(want[2])
    assert (gap[gv != wv] <= BOUNDARY_REL).all()
    both = gv & wv
    assert both.sum() > 10
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=0, atol=1e-6)


# entry: (wrapper, the register walk's entry point, ListWalk's, the plain
# launch, its arguments between the prepared tensors and k, batched)
ENTRIES = {"coords": (K.knn_coords_cuda, "liodom_knn_coords_batched",
                      "liodom_knn_coords_any_k", K.knn_launch_plain, (),
                      False),
           "coords_batched": (K.knn_coords_cuda, "liodom_knn_coords_batched",
                              "liodom_knn_coords_any_k", K.knn_launch_plain,
                              (), True),
           "lines": (K.knn_lines_cuda, "liodom_knn_lines",
                     "liodom_knn_lines_any_k", K.knn_lines_launch_plain,
                     (1.0, 3.0, 0.01), False),
           "index": (K.knn_index_cuda, "liodom_knn_index",
                     "liodom_knn_index_any_k", K.knn_index_launch_plain,
                     (3000,), False)}


class _Reached(Exception):
    """A launch of the register walk."""


@pytest.mark.parametrize("k", [17, 32])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cuda_wrappers_take_the_any_k_walk_above_the_limit(entry, k,
                                                           monkeypatch):
    """Each CUDA wrapper through ``knn_launch`` on CPU tensors, with
    ``kernels.launch`` (the one launch function) replaced by a stand-in
    that records the entry point: the register walk's stops the call, and
    ``ListWalk``'s runs the plain launch on the tensors the call prepared
    and writes its answer where the launch's outputs are (the launch's
    CUDA device check takes CPU tensors, and ``ListWalk``'s lists are
    said to fit shared memory).  k above MAX_K reaches the ``*_any_k``
    entry point and never the register walk's, k = MAX_K the register
    walk's and never the ``*_any_k``, and the answer is the plain
    version's."""
    wrapper, register, any_k, plain, extra, batched = ENTRIES[entry]
    monkeypatch.setattr(K, "_check_prepared",
                        lambda q4, r4, flags, qperm, what: (
                            qperm.shape[-1], *flags.shape[-2:]))
    monkeypatch.setattr(K, "knn_any_k_shape",
                        lambda source, n_m, k: {"lists_in_smem": True})
    prepared, asked = [], []
    real_prepare = K.knn_prepare

    def prepare(*a, **kw):
        prepared.append(real_prepare(*a, **kw))
        return prepared[-1]

    def launch(symbol, device, *args):
        asked.append(symbol)
        if symbol != any_k:
            raise _Reached(symbol)
        prep = prepared[-1]
        assert list(args[:5]) == [t.data_ptr() for t in prep] + [None]
        want = plain(*prep, *extra, k)
        for ptr, t in zip(args[5:5 + len(want)], want):
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())

    monkeypatch.setattr(K, "knn_prepare", prepare)
    monkeypatch.setattr(K.kernels, "launch", launch)
    q, qm, r, rm = (torch.from_numpy(a) for a in _scene(9, e=300, m=3000))
    args = (q[None], qm[None], r[None], rm[None]) if batched else (q, qm, r,
                                                                   rm)
    got = wrapper(*args, k=k)
    assert asked == [any_k]
    with pytest.raises(_Reached):
        wrapper(*args, k=K.MAX_K)
    assert asked == [any_k, register]
    if entry == "lines":
        want = K.knn_lines_plain(q, qm, r, rm, k)
        ok = got[2] & want[2]
        assert int(ok.sum()) > 20
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0][ok], want[0][ok])
        assert torch.equal(got[1][ok], want[1][ok])
        return
    if entry == "index":
        d_p, i_p = K.knn_index_plain(q, qm, r, rm, k)
        d_g, i_g = got
        assert torch.equal(i_g[d_p < 1e29], i_p[d_p < 1e29])
    else:
        d_p, c_p = K.knn_coords_plain(q, qm, r, rm, k)
        d_g, c_g = (t[0] for t in got) if batched else got
        fin = d_p < 1e29
        assert torch.equal(c_g[fin], c_p[fin])
    assert d_g.shape == (300, k)
    assert torch.equal(d_g, d_p)


def _course_tracks_jax(knn_k):
    """3 frames of ``image_step`` at ``knn_k`` on the CPU against JAX: edge
    counts equal, poses within 1 cm and 1e-3 rad."""
    jcfg = JConfig(local_map_size=5, ring_width=2048, knn_k=knn_k)
    cfg = LiodomConfig(local_map_size=5, ring_width=2048, knn_k=knn_k)
    world = BoxWorld(seed=5)
    pos, rots, _ = drive_trajectory_6dof(3, speed=1.0, yaw_rate=0.03)
    jstate = JP.init_state(jcfg)
    state = P.init_state(cfg, device="cpu")
    for i in range(3):
        scan = world.render(pos[i], rots[i], width=560, noise=0.01,
                            seed=500 + i)
        img = JF.split_scan(JRawScan.from_points(jnp.asarray(scan),
                                                 jcfg.max_points), jcfg)
        jstate, jpose, jn = JP.image_step(jstate, img.xyz, img.count, jcfg)
        state, pose, n = P.image_step(
            state, torch.from_numpy(np.array(img.xyz)),
            torch.from_numpy(np.array(img.count)), cfg)
        assert int(n) == int(jn) and int(n) > 100
        assert float(np.linalg.norm(pose.t.numpy()
                                    - np.asarray(jpose.t))) < 0.01
        assert _quat_angle(pose.q.numpy(), np.asarray(jpose.q)) < 1e-3
    assert float(np.linalg.norm(pose.t.numpy())) > 0.3      # it moved


def test_image_step_at_knn_k_3_tracks_jax():
    _course_tracks_jax(3)


def test_image_step_at_knn_k_20_tracks_jax():
    """Above the register walk's MAX_K: the CPU path takes any k, as JAX."""
    _course_tracks_jax(20)
