"""The run-time-k kNN walk (``ListWalk`` in ``csrc/knn_search.cuh``, the
``*_any_k`` launches that K3-K6 take above ``MAX_K``), pinned on the CPU
where ties are many.

One block a query tile, one thread a query; the block stages its flagged
ref tiles in ascending order and every thread scans each staged tile's
512 refs in row order, 8 distances behind one test of their minimum
against its k-th best, inserting each ref that beats it with a strict
``<`` shift into its list.  The list lives in memory slot-major: a tile's
k slots of d2 (then of indices) for its 64 queries at ``s * 64 + lane``.
:func:`_list_walk` is that design in plain torch, memory layout and all.
On the 5 cm lattice with duplicate refs of ``test_torch_knn_split.py``
(where many distances are exactly equal) it must give, bit for bit on d2
and every coordinate of every row, ``knn_launch_plain``, the keyed (d2,
index) selection, at k = 1, 5, 16 (the register walk's range), 17 and 64
(the walk's own).
"""

import pytest
import torch

from liodom_tpu_torch.ops import knn_pallas as K

from test_torch_knn_split import DECIMAL, RADIUS, _read_back, tie_scene

torch.set_num_threads(1)

BATCH = 8      # distances behind one list test (csrc/knn_search.cuh kBatch)


def _insert(ld, li, d, i, enter, k):
    """The strict-``<`` shift of the lanes that ``enter`` (each one's d <
    its slot k - 1) over slot-major memory ``ld`` / ``li`` (N, k * 64),
    slot s of lane l at ``s * 64 + l``: every entry above d moves up one
    slot (the last falls off) and d lands after the entries <= d, where the
    kernel's shift from the last slot down stops."""
    te = K.TILE_E
    vd, vi = ld.view(-1, k, te), li.view(-1, k, te)
    p = torch.where(enter, (vd <= d[:, None, :]).sum(1), k)[:, None, :]
    slot = torch.arange(k)[None, :, None]
    up_d = torch.cat([vd[:, :1], vd[:, :-1]], dim=1)
    up_i = torch.cat([vi[:, :1], vi[:, :-1]], dim=1)
    vd.copy_(torch.where(slot < p, vd, torch.where(slot == p, d[:, None, :],
                                                     up_d)))
    vi.copy_(torch.where(slot < p, vi, torch.where(slot == p, i[:, None, :],
                                                     up_i)))


def _list_walk(q4, r4, flags, k):
    """ListWalk's lists after the walk: (d2 (Ep, k), index (Ep, k)), kBig
    and kNone in an empty slot."""
    n_e, _ = flags.shape
    te, tm = K.TILE_E, K.TILE_M
    # each query tile's refs in walk order: its flagged tiles ascending,
    # each tile's rows in order
    streams = [torch.cat([torch.arange(mt * tm, (mt + 1) * tm)
                          for mt in torch.nonzero(flags[et]).squeeze(1)
                          .tolist()] or [torch.zeros(0, dtype=torch.int64)])
               for et in range(n_e)]
    steps = max(len(s) for s in streams)
    steps += -steps % BATCH
    idx = torch.full((n_e, steps), -1, dtype=torch.int64)
    for et, s in enumerate(streams):
        idx[et, :len(s)] = s
    q = q4.view(n_e, te, 4)
    r = r4[idx.clamp(min=0)]                                 # (n_e, steps, 4)
    dx = q[:, :, None, 0] - r[:, None, :, 0]
    dy = q[:, :, None, 1] - r[:, None, :, 1]
    dz = q[:, :, None, 2] - r[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz                       # (n_e, te, steps)
    d2 = torch.where(idx[:, None, :] >= 0, d2, torch.nan)    # no ref: skipped
    ld = torch.full((n_e, k * te), K._BIG)
    li = torch.full((n_e, k * te), K._NONE, dtype=torch.int64)
    worst = torch.full((n_e, te), K._BIG)
    lane = torch.arange(te)
    for i0 in range(0, steps, BATCH):
        batch = d2[:, :, i0:i0 + BATCH]
        lo = batch[..., 0]
        for u in range(1, BATCH):
            lo = torch.fmin(lo, batch[..., u])               # skips a NaN
        if not bool((lo < worst).any()):
            continue
        for u in range(BATCH):
            d = batch[..., u]
            enter = d < worst
            if bool(enter.any()):
                _insert(ld, li, d, idx[:, i0 + u, None].expand(-1, te),
                        enter, k)
                worst = ld[:, (k - 1) * te + lane]
    d_out = ld.view(n_e, k, te).transpose(1, 2).reshape(-1, k)
    i_out = li.view(n_e, k, te).transpose(1, 2).reshape(-1, k)
    return d_out, i_out


def _list_walk_coords(q4, r4, flags, qperm, k):
    """K3's answer by ListWalk and its epilogue: (d2 (E, k), coords (E, k,
    3)) in the caller's query order."""
    md, mi = _list_walk(q4, r4, flags, k)
    empty = mi == K._NONE
    coords = torch.where(empty[..., None], 0.0,
                         r4[torch.where(empty, 0, mi), :3])
    e = qperm.shape[0]
    out_d, out_c = torch.empty((e, k)), torch.empty((e, k, 3))
    out_d[qperm.long()] = _read_back(md, q4)[:e]
    out_c[qperm.long()] = coords[:e]
    return out_d, out_c


@pytest.mark.parametrize("k", [1, 5, 16, 17, 64])
def test_list_walk_is_the_keyed_selection_on_ties(k):
    q, qm, r, rm = (torch.from_numpy(a) for a in tie_scene(0, DECIMAL))
    prep = K.knn_prepare(q, qm, r, rm, RADIUS)
    d_m, c_m = _list_walk_coords(*prep, k)
    d_o, c_o = K.knn_launch_plain(*prep, k=k)
    assert d_m.shape == (300, k)
    assert torch.equal(d_m, d_o)
    assert torch.equal(c_m, c_o)
    # the scene is tie-heavy where the lists hold real neighbours
    real = d_o < 1.0
    tied = (real[:, 1:] & (d_o.diff(dim=1) == 0)).any(1)
    assert k == 1 or int(tied.sum()) > 20
