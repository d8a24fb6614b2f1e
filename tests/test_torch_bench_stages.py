"""The port of ``bench_stages.py`` (``liodom_tpu_torch/tools/bench_stages``)
on the CPU.

Its kept intermediates at a small size (ring width 1,024, 6 frames of 900
columns) against the procedure of ``bench_stages.py:80-108`` run with the
JAX package's own functions on the same numpy scans: the frame loop at the
port's pose bar, then, from the port's state, equal edges and validity,
``edges_world`` within 1e-5 m, equal correspondence validity.
Each stage callable against the function called as the pipeline calls it
(``torch.equal``), the sub-rows composing to their rows, and a ``--device
cpu`` run of ``main``: the JAX tool's keys and stage rows, ``graph_ms``
null, no TPU anchor, no file written without ``--out`` and
``BENCH_STAGES.json`` untouched.  The stage graphs are held to their eager
stages on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import hashlib
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liodom_tpu.core import pose as jse3
from liodom_tpu.core.config import LiodomConfig as JConfig
from liodom_tpu.core.frame import EdgeCloud as JEdgeCloud
from liodom_tpu.core.frame import RingImage as JRingImage
from liodom_tpu.odometry import local_map as JLM
from liodom_tpu.odometry import pipeline as JP
from liodom_tpu.ops.features import select_edges as j_select_edges
from liodom_tpu.ops.features import smoothness as j_smoothness
from liodom_tpu.ops.neighbors import line_correspondences as j_corr

from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.odometry import local_map as LM
from liodom_tpu_torch.ops import features as F
from liodom_tpu_torch.ops import neighbors as NB
from liodom_tpu_torch.ops.solver import lm_solve
from liodom_tpu_torch.tools import bench_stages as BS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(frames=6, width=900, ring_width=1024)


@pytest.fixture(scope="module")
def small():
    cfg, mcfg, _ = BS.configs(SMALL["ring_width"])
    scans = BS.drive_scans(cfg, SMALL["frames"], SMALL["width"])
    it = BS.intermediates(scans, cfg, mcfg, torch.device("cpu"))
    return cfg, mcfg, scans, it


def _jax_loop(scans, ring_width):
    """``bench_stages.py:80-84``: JAX's state after all frames but the
    last."""
    cfg = JConfig(local_map_size=5, ring_width=ring_width)
    state = JP.init_state(cfg)
    for x, c in scans[:-1]:
        state, _, _ = JP.image_step(state, jnp.asarray(x), jnp.asarray(c),
                                    cfg)
    return cfg, state


def _to_jax_state(state):
    """The port's ``OdomState`` as the JAX package's (int64 scalars to its
    int32)."""
    def arr(t):
        a = t.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    return JP.OdomState(
        JLM.WindowState(*(arr(t) for t in state.window)),
        jse3.Pose(arr(state.odom.q), arr(state.odom.t)),
        jse3.Pose(arr(state.prev_odom.q), arr(state.prev_odom.t)),
        arr(state.received_xyz), arr(state.received_valid),
        arr(state.imu_ori))


def _jax_procedure(cfg, state, last):
    """``bench_stages.py:85-108`` with the JAX package's functions."""
    img = JRingImage(jnp.asarray(last[0]), jnp.asarray(last[1]))
    sm = jax.jit(lambda x, c: j_smoothness(JRingImage(x, c), cfg))(
        img.xyz, img.count)
    edges = j_select_edges(img, sm, cfg)
    eorder = jnp.argsort(~edges.valid, stable=True)
    evalid = edges.valid[eorder]
    edges_c = JEdgeCloud(jnp.where(evalid[:, None], edges.xyz[eorder], 0.0),
                         evalid)
    map_xyz, map_valid = JLM.flatten(state.window)
    pred = jse3.compose(state.odom, jse3.compose(jse3.inverse(state.prev_odom),
                                                 state.odom))
    edges_world = jse3.transform(pred, edges_c.xyz)
    corr = j_corr(edges_world, edges_c.valid, map_xyz, map_valid,
                  k=cfg.knn_k, max_sq_dist=cfg.knn_max_sq_dist,
                  eig_ratio=cfg.eig_ratio, min_line_sep=cfg.min_line_sep)
    return edges, edges_c, map_valid, edges_world, corr


def test_intermediates_match_the_jax_procedure(small):
    """The frame loop against JAX's at the port's pose bar (1 cm, 1e-3
    rad: the two engines sum the solve in another order), then JAX's
    procedure from the port's state on the last frame: the same edges,
    compaction, window, ``edges_world`` within 1e-5 m and the same
    correspondence validity."""
    cfg, _, scans, it = small
    jcfg, jstate = _jax_loop(scans, SMALL["ring_width"])
    assert float(np.abs(np.asarray(jstate.odom.t)
                        - it.state.odom.t.numpy()).max()) < 0.01
    assert float(np.abs(np.asarray(jstate.odom.q)
                        - it.state.odom.q.numpy()).max()) < 1e-3
    assert float(np.linalg.norm(np.asarray(jstate.odom.t))) > 1.0
    edges, edges_c, map_valid, edges_world, corr = _jax_procedure(
        jcfg, _to_jax_state(it.state), scans[-1])
    np.testing.assert_array_equal(it.edges.valid.numpy(),
                                  np.asarray(edges.valid))
    np.testing.assert_array_equal(it.edges.xyz.numpy(), np.asarray(edges.xyz))
    np.testing.assert_array_equal(it.edges_c.valid.numpy(),
                                  np.asarray(edges_c.valid))
    np.testing.assert_array_equal(it.edges_c.xyz.numpy(),
                                  np.asarray(edges_c.xyz))
    n = int(it.edges_c.valid.sum())
    assert n == int(np.asarray(edges_c.valid).sum()) > 1000
    np.testing.assert_array_equal(it.map_valid.numpy(), np.asarray(map_valid))
    np.testing.assert_allclose(it.edges_world.numpy(), np.asarray(edges_world),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(it.corr.valid.numpy(),
                                  np.asarray(corr.valid))
    assert int(it.corr.valid.sum()) > 500


def _same(a, b) -> bool:
    return BS.outputs_equal(a, b)


def test_stage_callables_are_the_pipeline_calls(small):
    """Each row's callable gives what the pipeline's call gives, and the
    sub-rows compose to their rows."""
    cfg, mcfg, _, it = small
    rows = BS.stages(it, cfg, mcfg)
    assert set(rows) == {"_dispatch_floor", *BS.STAGES,
                         *(n for v in BS.SUB_ROWS.values() for n in v)}
    out = {name: fn(*args) for name, (fn, args) in rows.items()}
    assert torch.equal(out["_dispatch_floor"], torch.ones((8, 128)))
    assert torch.equal(out["smoothness"], F.smoothness(it.img, cfg))
    assert torch.equal(out["smoothness"], it.smooth)
    assert _same(out["select_edges"], F.select_edges(it.img, it.smooth, cfg))
    assert _same(out["select_edges"], it.edges)
    corr = NB.line_correspondences(
        it.edges_world, it.edges_c.valid, it.map_xyz, it.map_valid,
        k=cfg.knn_k, max_sq_dist=cfg.knn_max_sq_dist,
        eig_ratio=cfg.eig_ratio, min_line_sep=cfg.min_line_sep)
    assert _same(out["knn_line_fit"], corr) and _same(corr, it.corr)
    # knn_prepare -> knn_launch (K3's plain version here) -> line_fit
    assert _same(out["knn_launch"], rows["knn_launch"][0](
        *out["knn_prepare"]))
    d2, near = out["knn_launch"]
    assert _same(out["line_fit"], rows["line_fit"][0](
        near, d2[..., cfg.knn_k - 1], it.edges_c.valid))
    assert torch.equal(out["line_fit"].valid, out["knn_line_fit"].valid)
    assert _same(out["lm_solve"], lm_solve(
        it.pred, it.edges_c.xyz, it.corr.lpa, it.corr.lpb, it.corr.valid,
        min_range=cfg.min_range, max_range=cfg.max_range,
        huber_delta=cfg.huber_delta, iters=cfg.inner_iters))
    assert _same(out["window_push"], LM.push(it.state.window, it.edges_world,
                                             it.edges_c.valid))
    co, cm = it.comb
    upd = G.update_map(cm, it.edges_c.xyz, it.edges_c.valid, it.cpose, mcfg)
    assert _same(out["map_update"], upd)
    assert _same(out["sums"], upd)
    assert _same(rows["sums"][0](cm, it.edges_c.valid, out["probe"]), upd)
    assert int(upd.valid.sum()) > int(cm.valid.sum()) > 1000
    assert _same(out["map_local"], G.get_local_map(
        cm, it.cpose.t, mcfg, capacity=mcfg.local_map_capacity))


def _jax_stage_rows():
    """The stage rows the JAX tool writes (``stage_ms["..."]``)."""
    src = (REPO / "bench_stages.py").read_text()
    return set(re.findall(r'stage_ms\["(\w+)"\]\s*=', src))


def test_main_on_the_cpu_prints_the_jax_keys(monkeypatch, tmp_path, capsys):
    before = hashlib.sha256((REPO / "BENCH_STAGES.json").read_bytes()
                            ).hexdigest()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(BS, "FRAMES", SMALL["frames"])
    monkeypatch.setattr(BS, "WIDTH", SMALL["width"])
    monkeypatch.setattr(BS, "RING_WIDTH", SMALL["ring_width"])
    monkeypatch.setattr(BS, "REPS", 2)
    assert BS.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    line = out.strip().splitlines()[-1]
    payload = json.loads(line)
    assert {"stage_ms", "odom_ms", "combined_ms", "roofline",
            "note"} <= set(payload)
    jax_rows = _jax_stage_rows()
    assert jax_rows == {"_dispatch_floor", *BS.STAGES}
    subs = {n for v in BS.SUB_ROWS.values() for n in v}
    assert set(payload["stage_ms"]) == jax_rows | subs
    for row in list(payload["stage_ms"].values()) + [payload["odom_ms"],
                                                     payload["combined_ms"]]:
        assert row["eager_ms"] > 0 and row["graph_ms"] is None
    assert payload["device"]["type"] == "cpu"
    assert payload["roofline"]["knn_line_fit"]["achieved_gflops"] is None
    anchors = payload["roofline"]["anchors"]
    assert anchors["hbm_bytes_s"] == 3.35e12
    assert anchors["fp32_ops_s"] == 67e12
    for word in ("tpu", "v5e", "mxu", "vpu"):
        assert not re.search(rf"\b{word}\b", line.lower()), word
    assert "smoothness" in err and "knn_prepare" in err
    assert list(tmp_path.iterdir()) == []           # no file without --out
    assert hashlib.sha256((REPO / "BENCH_STAGES.json").read_bytes()
                          ).hexdigest() == before

    assert BS.main(["--device", "cpu", "--out", "stages.json"]) == 0
    out, _ = capsys.readouterr()
    written = json.loads((tmp_path / "stages.json").read_text())
    assert set(written) == set(json.loads(out.strip().splitlines()[-1]))


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """On the card by default: without one and without ``--device cpu``
    it raises before measuring or writing anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BS.main(["--out", "stages.json"])
    assert list(tmp_path.iterdir()) == []
