"""Port parity: K6 (kNN with the line-fit gate fused in) and the
``knn_impl`` choice of ``line_correspondences``.

* K6's plain version against ``knn_lines_pallas(interpret=True)`` on the
  line-rich map and the clustered scenes of the JAX tests: ``valid`` equal
  except where the plain eigenvalues sit at the ratio gate
  (``|e_max - 3 e_mid| <= 1e-4 e_max``: the JAX kernel takes arccos from a
  polynomial good to 2e-8 rad, the port the native one), endpoints to 1e-6
  where both accept.
* The degenerate inputs of ``tests/test_knn_pallas.py:272-293`` gate every
  row out on both sides.
* ``line_correspondences(knn_impl="pallas_lines")`` against JAX's
  ``"pallas_lines_interpret"``, batched against solo, ``"auto"`` reading
  ``LIODOM_KNN_IMPL`` at call time, and an unknown value raising.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liodom_tpu.ops import knn_pallas as JK
from liodom_tpu.ops import neighbors as JN

from liodom_tpu_torch.ops import knn_pallas as K
from liodom_tpu_torch.ops import neighbors as N

from test_torch_knn import _scene

torch.set_num_threads(1)

BOUNDARY_REL = 1e-4


def _line_map(seed=13):
    """The line-rich map of test_knn_pallas.py:239-248: 48 segments of 48
    points along (0.3, 0, 1), 1 cm noise; edges near every 7th point."""
    rng = np.random.default_rng(seed)
    bases = rng.uniform(-15, 15, (48, 3)).astype(np.float32)
    t = np.linspace(-1.2, 1.2, 48, dtype=np.float32)
    m = (bases[:, None, :]
         + t[None, :, None] * np.array([0.3, 0, 1], np.float32)).reshape(-1, 3)
    m = m + rng.standard_normal(m.shape).astype(np.float32) * 0.01
    mm = rng.random(m.shape[0]) > 0.05
    e = m[::7] + rng.standard_normal(m[::7].shape).astype(np.float32) * 0.04
    em = rng.random(e.shape[0]) > 0.1
    return e.astype(np.float32), em, m.astype(np.float32), mm


def _plain_ratio_gap(q, qm, r, rm):
    """|e_max - 3 e_mid| / e_max of the plain neighbourhoods, per row."""
    _, near = K.knn_coords_plain(*map(torch.from_numpy, (q, qm, r, rm)))
    zm = near - near.mean(dim=1, keepdim=True)
    eigs = N.sym3_eigenvalues(torch.einsum("eki,ekj->eij", zm, zm)).numpy()
    return np.abs(eigs[:, 2] - 3.0 * eigs[:, 1]) / np.maximum(
        np.abs(eigs[:, 2]), 1e-30)


def _check_lines(got, want, gap):
    gv, wv = got[2].numpy(), np.asarray(want[2])
    flips = gv != wv
    assert (gap[flips] <= BOUNDARY_REL).all(), gap[flips]
    both = gv & wv
    assert both.sum() > 10
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=0, atol=1e-6)
    return int(flips.sum())


@pytest.mark.parametrize("scene", ["lines", "clusters"])
def test_knn_lines_plain_matches_pallas_interpret(scene):
    q, qm, r, rm = _line_map() if scene == "lines" else _scene(5)
    want = JK.knn_lines_pallas(jnp.asarray(q), jnp.asarray(qm),
                               jnp.asarray(r), jnp.asarray(rm), k=5,
                               tile_e=64, tile_m=512, interpret=True)
    got = K.knn_lines_plain(*map(torch.from_numpy, (q, qm, r, rm)))
    assert got[0].shape == (q.shape[0], 3) and got[2].dtype == torch.bool
    assert not got[2].numpy()[~qm].any()
    _check_lines(got, want, _plain_ratio_gap(q, qm, r, rm))


@pytest.mark.parametrize("case", ["refs_invalid", "queries_invalid",
                                  "too_few_refs"])
def test_knn_lines_degenerate_inputs_gate_everything(case):
    rng = np.random.default_rng(3)
    q = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    qm = np.ones(64, bool) if case != "queries_invalid" else np.zeros(64, bool)
    rm = {"refs_invalid": np.zeros(256, bool),
          "queries_invalid": np.ones(256, bool),
          "too_few_refs": np.arange(256) < 3}[case]
    _, _, ok_j = JK.knn_lines_pallas(jnp.asarray(q), jnp.asarray(qm),
                                     jnp.asarray(r), jnp.asarray(rm),
                                     tile_e=32, tile_m=128, interpret=True)
    _, _, ok_t = K.knn_lines_plain(*map(torch.from_numpy, (q, qm, r, rm)))
    assert not bool(np.asarray(ok_j).any())
    assert not bool(ok_t.any())


def test_line_correspondences_lines_impl_matches_jax():
    q, qm, r, rm = _line_map()
    want = JN.line_correspondences(jnp.asarray(q), jnp.asarray(qm),
                                   jnp.asarray(r), jnp.asarray(rm),
                                   knn_impl="pallas_lines_interpret")
    args = tuple(map(torch.from_numpy, (q, qm, r, rm)))
    got = N.line_correspondences(*args, knn_impl="pallas_lines")
    _check_lines(got, want, _plain_ratio_gap(q, qm, r, rm))
    # on CPU tensors both implementations are the plain search + line fit
    coords = N.line_correspondences(*args, knn_impl="pallas_coords")
    for a, b in zip(got, coords):
        assert torch.equal(a, b)


def test_line_correspondences_batched_matches_solo():
    lanes = [_line_map(13), _line_map(14)]
    stacked = [torch.from_numpy(np.stack([ln[i] for ln in lanes]))
               for i in range(4)]
    for impl in N.KNN_IMPLS:
        got = N.line_correspondences(*stacked, knn_impl=impl)
        assert got.valid.shape == stacked[1].shape
        for b, lane in enumerate(lanes):
            solo = N.line_correspondences(*map(torch.from_numpy, lane),
                                          knn_impl=impl)
            for a, s in zip(got, solo):
                assert torch.equal(a[b], s)


def test_knn_impl_choice(monkeypatch):
    q, qm, r, rm = map(torch.from_numpy, _line_map())
    monkeypatch.delenv("LIODOM_KNN_IMPL", raising=False)
    assert N.resolve_knn_impl() == "pallas_coords"
    monkeypatch.setenv("LIODOM_KNN_IMPL", "pallas_lines")
    assert N.resolve_knn_impl("auto") == "pallas_lines"
    assert N.resolve_knn_impl("pallas_coords") == "pallas_coords"
    before = K.kernels.launch_counts()
    auto = N.line_correspondences(q, qm, r, rm)
    assert K.kernels.launch_counts() == before       # CPU: the plain route
    assert auto.valid.sum() > 10
    for bad in ("xla", "pallas_interpret", "pallas_lines_interpret", "lines"):
        with pytest.raises(ValueError, match="knn_impl"):
            N.line_correspondences(q, qm, r, rm, knn_impl=bad)
    monkeypatch.setenv("LIODOM_KNN_IMPL", "xla")
    with pytest.raises(ValueError, match="knn_impl"):
        N.line_correspondences(q, qm, r, rm)
