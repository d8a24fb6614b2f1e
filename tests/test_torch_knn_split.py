"""The merge rule of the kNN walk that K3, K4, K5 and K6 share
(``csrc/knn_search.cuh``), pinned on the CPU where ties are many.

A query tile's flagged ref tiles are dealt over the S blocks of a cluster
by rank (block ``rank`` takes the flagged tiles whose rank is ``rank``
modulo S); each staged tile is split into G runs, one a thread group; each
thread keeps a strict-``<`` best-5 over its refs in ascending index order,
and the lists merge in (d2, index) order: first the G groups of each
block, then the S blocks of the cluster into rank 0.
:func:`_walk_model` is that design in plain torch.  On refs of a ~5 cm
lattice with duplicates, where many distances are exactly equal, it must
give, bit for bit on d2 and on every coordinate of every row,
``knn_launch_plain``: the (d2, index) keyed selection of the port's
``_index_keys``, whose order ``torch.topk``'s unspecified tie order cannot
touch (the brute force ``knn_coords_plain`` is no oracle on ties).

On a dyadic lattice (3/64 m) every distance is exact in float32, so any
rounding of ``(dx*dx + dy*dy) + dz*dz`` gives the same value: there the
model is also held bit for bit to ``knn_coords_pallas(interpret=True)`` at
the port's tiles (64 x 512, radius 1 m), the TPU kernel whose tie order the
port keeps.  On the decimal 5 cm lattice it is not: XLA's CPU backend
fuses ``dx*dx + dy*dy`` into a multiply-add, which moves d2 by an ulp and,
at a near-tie, picks the other neighbour, while the port rounds each
operation (``-fmad=false`` on the card).

K5 (``csrc/knn_index.cu``) is the same walk with an index epilogue, called
without a radius (every non-empty tile pair flagged).  :func:`_index_model`
is the walk at k neighbours with that epilogue (FAR picks and invalid
queries read ``_BIG``, indices clamped to ``m - 1``, an empty slot at 0);
at S x G = 1, 2, 7 and 32 and k = 3, 5 and 8 it must give
``knn_index_launch_plain`` bit for bit on every row, ``knn_index_plain`` on
every valid query, and, on the dyadic lattice, ``knn_pallas(k=k,
interpret=True)``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.ops import knn_pallas as JK

from liodom_tpu_torch.core import synth
from liodom_tpu_torch.ops import knn_pallas as K
from liodom_tpu_torch.ops.neighbors import _line_fit

torch.set_num_threads(1)

RADIUS = 1.0


DYADIC = 3 / 64      # m, exact in float32 with every distance
DECIMAL = 0.05


def tie_scene(seed, lattice):
    """``synth.tie_scene`` at 300 queries and 4,000 refs: lattice
    points in three 2.4 m clusters 8 m apart, refs repeating ~1,300 sites
    (equal distances to duplicates everywhere), queries on ref sites and
    next to them, ~10 % of either side invalid."""
    return synth.tie_scene(seed, 300, 4000, lattice)


def _insert(bd, bi, d, i):
    """Strict-``<`` insertion of one candidate into ascending lists (..., k):
    the kernel's bubble ends after every entry <= d."""
    k = bd.shape[-1]
    enter = d < bd[..., -1]
    p = torch.where(enter, (bd <= d[..., None]).sum(-1), k)[..., None]
    slot = torch.arange(k)
    shd = torch.cat([bd[..., :1], bd[..., :-1]], dim=-1)
    shi = torch.cat([bi[..., :1], bi[..., :-1]], dim=-1)
    bd = torch.where(slot < p, bd, torch.where(slot == p, d[..., None], shd))
    bi = torch.where(slot < p, bi, torch.where(slot == p, i[..., None], shi))
    return bd, bi


def _before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def _merge(bd, bi, ld, li):
    """Merge ascending lists (ld, li) into (bd, bi), both (..., k), in
    (d2, index) order, stopping at a list's first entry that is not before
    the running last, as the kernel does."""
    k = bd.shape[-1]
    going = torch.ones(bd.shape[:-1], dtype=torch.bool)
    for c in range(k):
        d, i = ld[..., c], li[..., c]
        going &= _before(d, i, bd[..., -1], bi[..., -1])
        p = _before(bd, bi, d[..., None], i[..., None]).sum(-1)
        p = torch.where(going, p, k)[..., None]
        slot = torch.arange(k)
        shd = torch.cat([bd[..., :1], bd[..., :-1]], dim=-1)
        shi = torch.cat([bi[..., :1], bi[..., :-1]], dim=-1)
        bd = torch.where(slot < p, bd, torch.where(slot == p, d[..., None],
                                                   shd))
        bi = torch.where(slot < p, bi, torch.where(slot == p, i[..., None],
                                                   shi))
    return bd, bi


def _walk_lists(q4, r4, flags, clusters, groups, k):
    """The walk's merged lists in cluster rank 0: (d2 (Ep, k), index (Ep,
    k)) at every query position, ``_BIG`` and ``_NONE`` in an empty
    slot."""
    n_e, n_m = flags.shape
    tm, te = K.TILE_M, K.TILE_E
    run = tm // groups
    walkers = clusters * groups
    # each (query tile, block, group)'s stream of ref indices, in order
    streams = []
    for et in range(n_e):
        ranked = torch.nonzero(flags[et]).squeeze(1).tolist()
        for rank in range(clusters):
            for g in range(groups):
                runs = [torch.arange(mt * tm + g * run, mt * tm + (g + 1) * run)
                        for mt in ranked[rank::clusters]]
                streams.append(torch.cat(runs) if runs
                               else torch.zeros(0, dtype=torch.int64))
    steps = max(len(s) for s in streams)
    idx = torch.full((len(streams), steps), -1, dtype=torch.int64)
    for n, s in enumerate(streams):
        idx[n, :len(s)] = s
    q = q4.view(n_e, 1, te, 4).expand(n_e, walkers, te, 4).reshape(-1, te, 4)
    r = r4[idx.clamp(min=0)]                                # (N, steps, 4)
    dx = q[:, :, None, 0] - r[:, None, :, 0]
    dy = q[:, :, None, 1] - r[:, None, :, 1]
    dz = q[:, :, None, 2] - r[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz                      # (N, te, steps)
    d2 = torch.where(idx[:, None, :] >= 0, d2, torch.inf)   # no candidate
    bd = torch.full((len(streams), te, k), K._BIG)
    bi = torch.full((len(streams), te, k), K._NONE, dtype=torch.int64)
    for s in range(steps):
        bd, bi = _insert(bd, bi, d2[:, :, s],
                         idx[:, s, None].expand(-1, te))
    # merge the groups of each block, then the blocks into rank 0
    bd = bd.view(n_e, clusters, groups, te, k)
    bi = bi.view(n_e, clusters, groups, te, k)
    blk_d, blk_i = bd[:, :, 0], bi[:, :, 0]
    for g in range(1, groups):
        blk_d, blk_i = _merge(blk_d, blk_i, bd[:, :, g], bi[:, :, g])
    md, mi = blk_d[:, 0], blk_i[:, 0]
    for rank in range(1, clusters):
        md, mi = _merge(md, mi, blk_d[:, rank], blk_i[:, rank])
    return md.reshape(-1, k), mi.reshape(-1, k)


def _read_back(md, q4):
    md = torch.where(md > K._FAR_PICK_D2, K._BIG, md)
    return torch.where(q4[:, 3:4] != 0, torch.clamp(md, min=0.0), K._BIG)


def _walk_model(q4, r4, flags, qperm, clusters, groups):
    """K3's result by the redesigned walk: (d2 (E, 5), coords (E, 5, 3)) in
    the caller's query order."""
    md, mi = _walk_lists(q4, r4, flags, clusters, groups, 5)
    empty = mi == K._NONE
    coords = torch.where(empty[..., None], 0.0,
                         r4[torch.where(empty, 0, mi), :3])
    e = qperm.shape[0]
    out_d, out_c = torch.empty((e, 5)), torch.empty((e, 5, 3))
    out_d[qperm.long()] = _read_back(md, q4)[:e]
    out_c[qperm.long()] = coords[:e]
    return out_d, out_c


def _index_model(q4, r4, flags, qperm, m, clusters, groups, k):
    """K5's result by the walk at k neighbours: (d2 (E, k), idx (E, k)
    int32 into the r4 rows) in the caller's query order."""
    md, mi = _walk_lists(q4, r4, flags, clusters, groups, k)
    mi = torch.where(mi == K._NONE, 0, torch.clamp(mi, max=m - 1))
    e = qperm.shape[0]
    out_d = torch.empty((e, k))
    out_i = torch.empty((e, k), dtype=torch.int32)
    out_d[qperm.long()] = _read_back(md, q4)[:e]
    out_i[qperm.long()] = mi[:e].to(torch.int32)
    return out_d, out_i


@functools.lru_cache(maxsize=None)
def _case(seed, lattice):
    """knn_prepare's tensors and knn_launch_plain's answer on the scene,
    and the TPU kernel's on the dyadic lattice (None on the decimal)."""
    q, qm, r, rm = tie_scene(seed, lattice)
    prep = K.knn_prepare(*map(torch.from_numpy, (q, qm, r, rm)), RADIUS)
    jax_out = None
    if lattice == DYADIC:
        d_j, c_j = JK.knn_coords_pallas(jnp.asarray(q), jnp.asarray(qm),
                                        jnp.asarray(r), jnp.asarray(rm), k=5,
                                        tile_e=K.TILE_E, tile_m=K.TILE_M,
                                        interpret=True, max_radius=RADIUS)
        jax_out = (np.asarray(d_j), np.asarray(c_j))
    return prep, K.knn_launch_plain(*prep), jax_out


@pytest.mark.parametrize("lattice", [DYADIC, DECIMAL])
def test_tie_scene_is_tie_heavy_and_dealt(lattice):
    prep, (d_o, _), _ = _case(0, lattice)
    per_tile = prep[2].sum(1)
    # several flagged ref tiles a query tile, so that 2 and 7 blocks split
    assert int(per_tile.max()) >= 3 and float(per_tile.float().mean()) > 2
    rows = d_o[(d_o < 1.0).all(1)]
    assert len(rows) > 100
    # equal distances within a row, on most rows: the order rests on indices
    assert float((rows.diff(dim=1) == 0).any(1).float().mean()) > 0.5


@pytest.mark.parametrize("lattice", [DYADIC, DECIMAL])
@pytest.mark.parametrize("clusters,groups", [(1, 1), (1, 2), (7, 1), (8, 2),
                                             (8, 4), (16, 2)])
def test_split_walk_is_the_sequential_walk(clusters, groups, lattice):
    prep, (d_o, c_o), jax_out = _case(0, lattice)
    d_m, c_m = _walk_model(*prep, clusters, groups)
    assert torch.equal(d_m, d_o) and torch.equal(c_m, c_o)
    if jax_out is not None:
        np.testing.assert_array_equal(d_m.numpy(), jax_out[0])
        np.testing.assert_array_equal(c_m.numpy(), jax_out[1])


def test_launch_plain_is_the_tpu_kernel_on_ties():
    """The keyed selection alone against the TPU kernel on a second scene,
    its batched form, and its K6 form against the line fit of the same
    neighbours."""
    prep, (d_o, c_o), (d_j, c_j) = _case(1, DYADIC)
    np.testing.assert_array_equal(d_o.numpy(), d_j)
    np.testing.assert_array_equal(c_o.numpy(), c_j)
    batched = tuple(t[None] for t in prep)
    d_b, c_b = K.knn_launch_plain(*batched)
    assert torch.equal(d_b[0], d_o) and torch.equal(c_b[0], c_o)
    lpa, lpb, ok = K.knn_lines_launch_plain(*batched, 1.0, 3.0, 0.01)
    assert torch.equal(lpa[0], c_o[:, 0]) and torch.equal(lpb[0], c_o[:, 1])
    qmask = torch.from_numpy(tie_scene(1, DYADIC)[1])
    want = _line_fit(c_o, d_o[:, -1], qmask, 1.0, 3.0, 0.01)
    assert torch.equal(ok[0], want.valid)
    assert int(ok.sum()) > 0



@functools.lru_cache(maxsize=None)
def _index_case(k):
    """K5's inputs on the dyadic tie scene, as the sharded step calls it
    (no radius: nothing sorted, every non-empty tile pair flagged), the
    keyed selection's and the plain version's answers at k, and the TPU
    kernel's (``knn_pallas(k=k, interpret=True)`` at the port's tiles)."""
    q, qm, r, rm = tie_scene(0, DYADIC)
    pts = tuple(torch.from_numpy(a)[None] for a in (q, qm, r, rm))
    prep = K.knn_prepare_batched(*pts, None)
    m = r.shape[0]
    d_j, i_j = JK.knn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                             jnp.asarray(rm), k=k, tile_e=K.TILE_E,
                             tile_m=K.TILE_M, interpret=True)
    return (prep, m, K.knn_index_launch_plain(*prep, m, k),
            K.knn_index_plain(*(t[0] for t in pts), k),
            (np.asarray(d_j), np.asarray(i_j)))


@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("clusters,groups", [(1, 1), (1, 2), (7, 1),
                                             (16, 2)])
def test_index_walk_is_the_keyed_selection(clusters, groups, k):
    prep, m, (d_o, i_o), (d_p, i_p), (d_j, i_j) = _index_case(k)
    q4, r4, flags, qperm = (t[0] for t in prep)
    assert bool((flags != 0).all())              # dense: no radius
    d_m, i_m = _index_model(q4, r4, flags, qperm, m, clusters, groups, k)
    assert d_m.shape == (qperm.shape[0], k)
    assert torch.equal(d_m, d_o[0]) and torch.equal(i_m, i_o[0])
    valid = torch.from_numpy(tie_scene(0, DYADIC)[1])
    assert torch.equal(d_m[valid], d_p[valid])
    assert torch.equal(i_m[valid], i_p[valid])
    np.testing.assert_array_equal(d_m.numpy(), d_j)
    np.testing.assert_array_equal(i_m.numpy(), i_j)
    # equal distances within a row: the order rests on the indices
    assert float((d_m[valid].diff(dim=1) == 0).any(1).float().mean()) > 0.5
