"""The run-time-k kNN walk (``ListWalk`` in ``csrc/knn_search.cuh``, the
``*_any_k`` launches that K3-K6 take above ``MAX_K``), pinned on the CPU
where ties are many.

A query tile's flagged ref tiles are dealt by rank over the S blocks of a
cluster, each staged tile split into G runs of whole 8-ref batches, one a
thread group; each thread (a walker) keeps a partial list of only its
``filled`` real entries.  8 distances at a time are tested by their
minimum against the walker's k-th best; in a batch that passes, the
entrants are sorted by (d2, index) with a 19-comparator network and merged
into the list from its tail in one pass (an entry moves up by the entrants
below it, an entrant lands after the entries <= it, each slot written at
most once).  The lists live slot-major in the blocks' shared memory or in
a device scratch, (query tile, rank, group) in order; one thread a query
in cluster rank 0 then merges the S x G lists in (d2, index) order into
the k-entry answer.  :func:`_list_walk` is that design in plain torch,
memory layouts and all.  On the 5 cm lattice with duplicate refs of
``test_torch_knn_split.py`` (where many distances are exactly equal) it
must give, bit for bit on d2 and every coordinate of every row,
``knn_launch_plain``, the keyed (d2, index) selection, at k = 1, 5, 16
(the register walk's range), 17 and 64 (the walk's own), at the shipped
split and at 1 x 1, 2 x 1 and 7 x 3 (an odd split, whose last group's run
is shorter), with the lists in either layout; and, with K5's index
epilogue and no radius (every non-empty tile pair flagged),
``knn_index_launch_plain`` at k = 17 and 32.
"""

import functools

import pytest
import torch

from liodom_tpu_torch.ops import knn_pallas as K

from test_torch_knn_split import DECIMAL, RADIUS, _read_back, tie_scene

torch.set_num_threads(1)

BATCH = 8      # distances behind one list test (csrc/knn_search.cuh kBatch)
SHIPPED = (8, 2)   # kListCluster x kListGroups in csrc/knn_search.cuh
SPLITS = [(1, 1), (2, 1), SHIPPED, (7, 3)]
LAYOUTS = ["smem", "scratch"]
# csrc/knn_search.cuh ListWalk::sort8, Batcher's 19 comparators
NETWORK = [(0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
           (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
           (1, 2), (3, 4), (5, 6)]


def _run(groups):
    """Refs a group scans of a staged tile (ListWalk::kRun): whole
    batches, the last group's run the rest of the tile."""
    return (-(-K.TILE_M // groups) + BATCH - 1) // BATCH * BATCH


def _before(da, ia, db, ib):
    return (da < db) | ((da == db) & (ia < ib))


def _sort8(d, i):
    """The network over the last axis (8) of (d2, index) pairs."""
    d, i = d.clone(), i.clone()
    for a, b in NETWORK:
        swap = _before(d[..., b], i[..., b], d[..., a], i[..., a])
        da = torch.where(swap, d[..., b], d[..., a])
        ia = torch.where(swap, i[..., b], i[..., a])
        d[..., b] = torch.where(swap, d[..., a], d[..., b])
        i[..., b] = torch.where(swap, i[..., a], i[..., b])
        d[..., a], i[..., a] = da, ia
    return d, i


def _merge(ld, li, filled, ed, ei, n, k):
    """The tail merge of the n sorted entrants (ed, ei) (..., 8) into lists
    (ld, li) (..., k) of ``filled`` real entries: entry s moves to s + the
    entrants strictly below it (a tie keeps the earlier entry), entrant u
    to u + the entries <= it, what passes slot k - 1 falls off.  Checks
    that the kept entries land on slots 0 .. new filled - 1, each once."""
    slot = torch.arange(k)
    u = torch.arange(BATCH)
    real = slot < filled[..., None]
    entrant = u < n[..., None]
    below = ((ed[..., None, :] < ld[..., :, None])
             & entrant[..., None, :]).sum(-1)
    pos_l = torch.where(real, slot + below, k).clamp(max=k)
    at_or_below = ((ld[..., None, :] <= ed[..., :, None])
                   & real[..., None, :]).sum(-1)
    pos_e = torch.where(entrant, u + at_or_below, k).clamp(max=k)
    new_filled = torch.clamp(filled + n, max=k)
    writes = torch.zeros(ld.shape[:-1] + (k + 1,), dtype=torch.int64)
    writes.scatter_add_(-1, pos_l, torch.ones_like(pos_l))
    writes.scatter_add_(-1, pos_e, torch.ones_like(pos_e))
    assert torch.equal(writes[..., :k],
                       (slot < new_filled[..., None]).long())
    out_d = torch.full(ld.shape[:-1] + (k + 1,), K._BIG)
    out_i = torch.full(ld.shape[:-1] + (k + 1,), K._NONE, dtype=torch.int64)
    for src_d, src_i, pos in ((ld, li, pos_l), (ed, ei, pos_e)):
        out_d.scatter_(-1, pos, src_d)
        out_i.scatter_(-1, pos, src_i)
    # slot k took every dropped entry; the unfilled slots stay empty
    return out_d[..., :k], out_i[..., :k], new_filled


def _walkers(q4, r4, flags, clusters, groups, k, stats=None):
    """Every walker's partial list after the walk: (d2, index (N, 64, k),
    filled (N, 64)), walker (query tile, rank, group) at N = (et *
    clusters + rank) * groups + g.  ``stats``, a dict, gets the passing
    batches, the entrants and the passing batches of 2 or more entrants."""
    n_e, _ = flags.shape
    te, tm = K.TILE_E, K.TILE_M
    run = _run(groups)
    streams = []
    for et in range(n_e):
        ranked = torch.nonzero(flags[et]).squeeze(1).tolist()
        for rank in range(clusters):
            for g in range(groups):
                lo, hi = g * run, min((g + 1) * run, tm)
                runs = [torch.arange(mt * tm + lo, mt * tm + hi)
                        for mt in ranked[rank::clusters] if hi > lo]
                streams.append(torch.cat(runs) if runs
                               else torch.zeros(0, dtype=torch.int64))
    steps = max(len(s) for s in streams)
    steps += -steps % BATCH
    n_w = len(streams)
    idx = torch.full((n_w, steps), -1, dtype=torch.int64)
    for w, s in enumerate(streams):
        idx[w, :len(s)] = s
    walkers = clusters * groups
    q = q4.view(n_e, 1, te, 4).expand(n_e, walkers, te, 4).reshape(-1, te, 4)
    r = r4[idx.clamp(min=0)]                                 # (N, steps, 4)
    dx = q[:, :, None, 0] - r[:, None, :, 0]
    dy = q[:, :, None, 1] - r[:, None, :, 1]
    dz = q[:, :, None, 2] - r[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz                       # (N, te, steps)
    d2 = torch.where(idx[:, None, :] >= 0, d2, torch.nan)    # no ref: skipped
    ld = torch.full((n_w, te, k), K._BIG)
    li = torch.full((n_w, te, k), K._NONE, dtype=torch.int64)
    filled = torch.zeros((n_w, te), dtype=torch.int64)
    for i0 in range(0, steps, BATCH):
        d = d2[:, :, i0:i0 + BATCH]
        worst = torch.where(filled < k, K._BIG, ld[..., k - 1])
        lo = d[..., 0]
        for u in range(1, BATCH):
            lo = torch.fmin(lo, d[..., u])                   # skips a NaN
        passing = lo < worst
        if not bool(passing.any()):
            continue
        enter = d < worst[..., None]
        n = enter.sum(-1)
        if stats is not None:
            for key, v in (("batches", passing), ("entrants", n),
                           ("batches_of_2_or_more", n >= 2)):
                stats[key] = stats.get(key, 0) + int(v.sum())
        ed, ei = _sort8(torch.where(enter, d, torch.inf),
                        idx[:, None, i0:i0 + BATCH].expand(-1, te, -1))
        md, mi, mf = _merge(ld, li, filled, ed, ei, n, k)
        ld = torch.where(passing[..., None], md, ld)
        li = torch.where(passing[..., None], mi, li)
        filled = torch.where(passing, mf, filled)
    return ld, li, filled


def _store(ld, li, filled, clusters, groups, layout):
    """The lists as the kernel leaves them: slot-major, a walker's k d2
    slots then its k index slots ([slot][lane]), either in each block's
    shared memory (a tensor a block: its groups' lists, then the filled
    counts) or in one scratch, (query tile, rank, group) in order; returns
    the reader of (list h of query tile et, slot s) -> (d2, index) for the
    64 lanes, (kBig, kNone) past the list's filled entries."""
    n_w, te, k = ld.shape
    words = 2 * k * te
    lane = torch.arange(te)
    lists = torch.cat([ld.transpose(1, 2).reshape(n_w, -1),
                       li.to(torch.int32).view(torch.float32)
                       .transpose(1, 2).reshape(n_w, -1)], dim=1)
    blocks = n_w // groups
    if layout == "smem":
        mem = [torch.cat([lists[b * groups:(b + 1) * groups].reshape(-1),
                          filled[b * groups:(b + 1) * groups].to(torch.int32)
                          .view(torch.float32).reshape(-1)])
               for b in range(blocks)]

        def at(et, h, word):
            return mem[et * clusters + h // groups][(h % groups) * words
                                                     + word]

        def fill(et, h):
            blk = mem[et * clusters + h // groups]
            return blk[groups * words + (h % groups) * te + lane].view(
                torch.int32).long()
    else:
        scratch = lists.reshape(-1)
        counts = filled

        def at(et, h, word):
            return scratch[(et * clusters * groups + h) * words + word]

        def fill(et, h):
            return counts[et * clusters * groups + h]

    def read(et, h, s):
        f = fill(et, h)
        real = s < f
        s = torch.where(real, s, 0)
        d = at(et, h, s * te + lane)
        i = at(et, h, (k + s) * te + lane).view(torch.int32).long()
        return (torch.where(real, d, K._BIG), torch.where(real, i, K._NONE))

    return read


def _keyed_merge(read, n_e, lists, k):
    """Cluster rank 0's merge of each query's partial lists in (d2, index)
    order: (d2 (Ep, k), index (Ep, k))."""
    te = K.TILE_E
    out_d = torch.empty((n_e, te, k))
    out_i = torch.empty((n_e, te, k), dtype=torch.int64)
    for et in range(n_e):
        at = torch.zeros((lists, te), dtype=torch.int64)
        heads = [read(et, h, at[h]) for h in range(lists)]
        hd = torch.stack([d for d, _ in heads])
        hi = torch.stack([i for _, i in heads])
        for s in range(k):
            key = (hd.view(torch.int32).long() << 32) | hi   # d2 >= 0
            w = key.argmin(0)
            lane = torch.arange(te)
            out_d[et, :, s] = hd[w, lane]
            out_i[et, :, s] = hi[w, lane]
            at[w, lane] += 1
            for h in w.unique().tolist():
                d, i = read(et, h, at[h])
                hd[h], hi[h] = d, i
    return out_d.reshape(-1, k), out_i.reshape(-1, k)


def _list_walk(q4, r4, flags, k, split=SHIPPED, layout="smem"):
    """ListWalk's merged answer at every query position: (d2 (Ep, k),
    index (Ep, k)), kBig and kNone in an empty slot."""
    clusters, groups = split
    ld, li, filled = _walkers(q4, r4, flags, clusters, groups, k)
    read = _store(ld, li, filled, clusters, groups, layout)
    return _keyed_merge(read, flags.shape[0], clusters * groups, k)


def _list_walk_coords(q4, r4, flags, qperm, k, split=SHIPPED,
                      layout="smem"):
    """K3's answer by ListWalk and its epilogue: (d2 (E, k), coords (E, k,
    3)) in the caller's query order."""
    md, mi = _list_walk(q4, r4, flags, k, split, layout)
    empty = mi == K._NONE
    coords = torch.where(empty[..., None], 0.0,
                         r4[torch.where(empty, 0, mi), :3])
    e = qperm.shape[0]
    out_d, out_c = torch.empty((e, k)), torch.empty((e, k, 3))
    out_d[qperm.long()] = _read_back(md, q4)[:e]
    out_c[qperm.long()] = coords[:e]
    return out_d, out_c


@functools.lru_cache(maxsize=None)
def _tie_prep():
    q, qm, r, rm = (torch.from_numpy(a) for a in tie_scene(0, DECIMAL))
    return K.knn_prepare(q, qm, r, rm, RADIUS)


@functools.lru_cache(maxsize=None)
def _plain(k):
    return K.knn_launch_plain(*_tie_prep(), k=k)


def _check_tie_rows(k, split, layout):
    prep = _tie_prep()
    d_m, c_m = _list_walk_coords(*prep, k, split, layout)
    d_o, c_o = _plain(k)
    assert d_m.shape == (300, k)
    assert torch.equal(d_m, d_o)
    assert torch.equal(c_m, c_o)
    # the scene is tie-heavy where the lists hold real neighbours
    real = d_o < 1.0
    tied = (real[:, 1:] & (d_o.diff(dim=1) == 0)).any(1)
    assert k == 1 or int(tied.sum()) > 20


@pytest.mark.parametrize("k", [1, 5, 16, 17, 64])
def test_list_walk_is_the_keyed_selection_on_ties(k):
    """The shipped split, its lists in shared memory."""
    _check_tie_rows(k, SHIPPED, "smem")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("split", SPLITS,
                         ids=[f"{s}x{g}" for s, g in SPLITS])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 64])
def test_list_walk_split_is_the_keyed_selection(k, split, layout):
    """Every split and layout: the dealing over blocks and groups, the
    batch merge and the keyed merge change nothing of the answer."""
    _check_tie_rows(k, split, layout)


def test_tie_scene_spreads_over_the_splits():
    """Several flagged ref tiles a query tile (so 2, 7 and 8 blocks all get
    some), and many batches in which several refs enter at once (so the
    network and the tail merge do more than insert one)."""
    prep = _tie_prep()
    assert int(prep[2].sum(1).max()) >= 3
    stats = {}
    _, _, filled = _walkers(*prep[:3], *SHIPPED, 17, stats)
    assert int(filled.max()) == 17
    assert stats["batches_of_2_or_more"] > stats["batches"] // 4 > 100
    assert stats["entrants"] > 2 * stats["batches_of_2_or_more"]


@pytest.mark.parametrize("split", SPLITS,
                         ids=[f"{s}x{g}" for s, g in SPLITS])
@pytest.mark.parametrize("k", [17, 32])
def test_list_walk_index_epilogue_is_knn_index_launch_plain(k, split):
    """K5 on ListWalk, without a radius (nothing sorted, every non-empty
    tile pair flagged): FAR picks and invalid queries read kBig, indices
    clamped to m - 1, an empty slot at 0; every row bit for bit."""
    q, qm, r, rm = tie_scene(0, DECIMAL)
    pts = tuple(torch.from_numpy(a)[None] for a in (q, qm, r, rm))
    prep = K.knn_prepare_batched(*pts, None)
    m = r.shape[0]
    q4, r4, flags, qperm = (t[0] for t in prep)
    assert bool((flags != 0).all())
    md, mi = _list_walk(q4, r4, flags, k, split, "scratch")
    mi = torch.where(mi == K._NONE, 0, torch.clamp(mi, max=m - 1))
    e = qperm.shape[0]
    out_d = torch.empty((e, k))
    out_i = torch.empty((e, k), dtype=torch.int32)
    out_d[qperm.long()] = _read_back(md, q4)[:e]
    out_i[qperm.long()] = mi[:e].to(torch.int32)
    d_o, i_o = K.knn_index_launch_plain(*prep, m, k)
    assert torch.equal(out_d, d_o[0]) and torch.equal(out_i, i_o[0])
