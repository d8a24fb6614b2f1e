"""The port's host runtime (``liodom_tpu_torch/runtime``, ``core/io.py``,
``core/presets.py``) against the JAX package's on the same inputs: the
native loader and the host splits bit for bit, the host split against the
port's device split, ``KittiSequence``, the five results files byte for
byte, the trajectory metrics and the publisher's messages to 1e-12, the PLY
text, the presets, the channels, the checkpoint round trip and
the host<->device staging of the apps."""

import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu.core import io as jio
from liodom_tpu.core import presets as jpresets
from liodom_tpu.runtime import native as jnative
from liodom_tpu.runtime import publisher as jpub
from liodom_tpu.runtime import stats as jstats
from liodom_tpu.runtime import viz as jviz
from liodom_tpu_torch.core import io as tio
from liodom_tpu_torch.core import presets as tpresets
from liodom_tpu_torch.core.config import LiodomConfig, MapConfig
from liodom_tpu_torch.core.frame import RawScan
from liodom_tpu_torch.core.pose import Pose
from liodom_tpu_torch.core.synth import BoxWorld
from liodom_tpu_torch.mapping import grid as G
from liodom_tpu_torch.odometry import pipeline as P
from liodom_tpu_torch.ops.features import split_scan, split_scan_ouster
from liodom_tpu_torch.runtime import checkpoint as CK
from liodom_tpu_torch.runtime import device_io as DIO
from liodom_tpu_torch.runtime import native as tnative
from liodom_tpu_torch.runtime import publisher as tpub
from liodom_tpu_torch.runtime import stats as tstats
from liodom_tpu_torch.runtime import viz as tviz
from liodom_tpu_torch.runtime.channels import (Channel, Closed,
                                               FrequencyMonitor, LatestValue)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _write_bin(path, n, seed):
    rec = np.random.default_rng(seed).uniform(-50, 50, (n, 4)).astype(
        np.float32)
    rec.tofile(path)
    return rec


def _scan(seed=0, width=700, poison=False):
    pts = BoxWorld(seed=seed).render(np.zeros(3), np.eye(3), width=width,
                                     noise=0.01, seed=seed)
    pts = pts.astype(np.float32)
    if poison:                       # NaN, beyond max_range, inside min_range
        pts[::7] = np.nan
        pts[1::11] = 1e6
        pts[2::13] *= 0.01
    return pts


def test_loader_source_is_the_jax_packages():
    """One source for both loaders: a fix to one cannot leave the other
    behind."""
    ours = REPO / "liodom_tpu_torch/runtime/native_src/loader.cc"
    theirs = REPO / "liodom_tpu/runtime/native_src/loader.cc"
    assert ours.read_bytes() == theirs.read_bytes()


def test_native_library_is_keyed_by_source():
    path = Path(tnative.library_path())
    assert path.parent == REPO / "liodom_tpu_torch/runtime/native_src/build"
    assert path.name.startswith("libliodom_loader-")
    assert tnative.native_available()
    assert path.exists()


def test_read_bin_and_prefetcher_match_jax(tmp_path):
    rec = _write_bin(str(tmp_path / "a.bin"), 1234, 0)
    got = tnative.read_bin(str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(got, rec)
    np.testing.assert_array_equal(got, jnative.read_bin(str(tmp_path /
                                                            "a.bin")))
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f"{i:06d}.bin"))
        _write_bin(paths[-1], 500 + 10 * i, i)
    # capacity 600: the last files are clamped to it
    ours = list(tnative.iter_padded(paths, capacity=600, prefetch=3))
    theirs = list(jnative.iter_padded(paths, capacity=600, prefetch=3))
    assert len(ours) == len(theirs) == 12
    for i, ((xo, vo), (xt, vt)) in enumerate(zip(ours, theirs)):
        assert int(vo.sum()) == min(500 + 10 * i, 600)
        np.testing.assert_array_equal(xo, xt)
        np.testing.assert_array_equal(vo, vt)


@pytest.mark.parametrize("scan_lines", [64, 32, 16])
def test_host_splits_match_jax_and_the_device_split(scan_lines):
    """The numpy and native ring splits equal the JAX package's bit for bit
    and the port's device ``split_scan``: counts, image cells, the drops,
    and the NaN / range gating of the poisoned points."""
    cfg = LiodomConfig(scan_lines=scan_lines, ring_width=1024,
                       max_points=65536)
    pts = _scan(poison=True)
    rec = np.zeros((len(pts), 4), np.float32)
    rec[:, :3] = pts
    args = (scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range)
    with np.errstate(invalid="ignore"):
        img, cnt, drop = tnative.split_velodyne_np(pts, *args)
        jimg, jcnt, jdrop = jnative.split_velodyne_np(pts, *args)
    nimg, ncnt, ndrop = tnative.split_velodyne(rec, *args)
    jnimg, jncnt, jndrop = jnative.split_velodyne(rec, *args)
    for a, b in ((img, jimg), (cnt, jcnt), (nimg, img), (ncnt, cnt),
                 (nimg, jnimg), (ncnt, jncnt)):
        np.testing.assert_array_equal(a, b)
    assert drop == jdrop == ndrop == jndrop
    dev = split_scan(RawScan.from_points(torch.from_numpy(pts),
                                         cfg.max_points, device="cpu"), cfg)
    np.testing.assert_array_equal(dev.count.numpy(), cnt)
    np.testing.assert_array_equal(dev.xyz.numpy(), img)
    assert np.isfinite(img).all() and 0 < cnt.sum() < len(pts)


def test_ouster_split_matches_jax_and_the_device_split():
    rng = np.random.default_rng(5)
    h, w0 = 32, 256
    organized = (rng.standard_normal((h, w0, 3)) * 20).astype(np.float32)
    organized[rng.random((h, w0)) < 0.1] = np.nan
    organized[rng.random((h, w0)) < 0.05] *= 0.01
    cfg = LiodomConfig(lidar_type=1, scan_lines=h, ring_width=128)
    args = (cfg.ring_width, cfg.min_range, cfg.max_range)
    img, cnt, drop = tnative.split_ouster_np(organized, *args)
    jimg, jcnt, jdrop = jnative.split_ouster_np(organized, *args)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(cnt, jcnt)
    assert drop == jdrop > 0
    dev = split_scan_ouster(torch.from_numpy(organized), cfg)
    np.testing.assert_array_equal(dev.count.numpy(), cnt)
    np.testing.assert_array_equal(dev.xyz.numpy(), img)


def _sequence(tmp_path, n_scans=4):
    seq = tmp_path / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    for i in range(n_scans):
        pts = _scan(seed=i, width=300)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec.tofile(seq / "velodyne" / f"{i:06d}.bin")
    np.savetxt(seq / "times.txt", np.arange(n_scans) * 0.1)
    tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, 0.2]])
    with open(seq / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(str(v) for v in tr.reshape(-1)) + "\n")
    (tmp_path / "poses").mkdir()
    gt = np.tile(np.eye(4), (n_scans, 1, 1))
    gt[:, 0, 3] = np.arange(n_scans) * 1.5
    np.savetxt(tmp_path / "poses" / "00.txt",
               gt[:, :3, :].reshape(n_scans, 12))


def test_kitti_sequence_matches_jax(tmp_path):
    _sequence(tmp_path)
    ours = tio.KittiSequence(str(tmp_path), "00")
    theirs = jio.KittiSequence(str(tmp_path), "00")
    assert len(ours) == len(theirs) == 4
    assert ours.calib.keys() == theirs.calib.keys()
    for k in ours.calib:
        np.testing.assert_array_equal(ours.calib[k], theirs.calib[k])
    np.testing.assert_array_equal(ours.times, theirs.times)
    np.testing.assert_array_equal(ours.gt_velo(), theirs.gt_velo())
    np.testing.assert_array_equal(ours.scan(2), theirs.scan(2))
    a = list(ours.iter_images(64, 1024, 3.0, 75.0))
    b = list(theirs.iter_images(64, 1024, 3.0, 75.0))
    assert len(a) == len(b) == 4
    for (ia, ca, da), (ib, cb, db) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ca, cb)
        assert da == db
    pts = _scan(width=200)
    np.testing.assert_array_equal(tio.organized_from_unorganized(pts, 32, 64),
                                  jio.organized_from_unorganized(pts, 32, 64))


def _fill(stats_mod):
    rng = np.random.default_rng(3)
    st = stats_mod.Stats()
    for i in range(5):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = rng.normal(size=3) * 10
        st.add_pose(m)
        st.add_feature_extraction_time(rng.random())
        st.add_laser_odometry_time(rng.random() * 30, measured=i % 2 == 0)
        st.add_num_feats(int(rng.integers(100, 5000)))
        st.start_frame(float(i))
        st.stop_frame(i + rng.random())
    return st


def test_results_files_are_byte_identical(tmp_path):
    _fill(tstats).write_results(str(tmp_path / "ours"))
    _fill(jstats).write_results(str(tmp_path / "theirs"))
    names = sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert names == ["feat_ext_times.txt", "frame_times.txt",
                     "laser_odom_times.txt", "nfeats.txt", "poses.txt"]
    for name in names:
        assert ((tmp_path / "ours" / name).read_bytes()
                == (tmp_path / "theirs" / name).read_bytes()), name
    np.testing.assert_array_equal(
        tstats.load_kitti_poses(str(tmp_path / "ours" / "poses.txt")),
        jstats.load_kitti_poses(str(tmp_path / "theirs" / "poses.txt")))


def test_trajectory_metrics_match_jax():
    rng = np.random.default_rng(9)
    gt = np.zeros((30, 3, 4))
    est = np.zeros((30, 3, 4))
    for i in range(30):
        gt[i, :, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        gt[i, :, 3] = rng.normal(size=3) * 5
        est[i] = gt[i] + rng.normal(size=(3, 4)) * 1e-3
    assert abs(tstats.ate_rmse(est, gt) - jstats.ate_rmse(est, gt)) <= 1e-12
    for delta in (1, 5):
        for a, b in zip(tstats.rpe(est, gt, delta), jstats.rpe(est, gt,
                                                              delta)):
            assert abs(a - b) <= 1e-12


def test_publisher_messages_match_jax():
    rng = np.random.default_rng(4)
    t_bl = np.eye(4)
    t_bl[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t_bl[:3, 3] = [0.3, -0.1, 1.2]
    ours = tpub.OdomPublisher(t_base_laser=t_bl)
    theirs = jpub.OdomPublisher(t_base_laser=t_bl)
    for i in range(6):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3)
        for a, b in zip(ours.publish(pose, 0.1 * i),
                        theirs.publish(pose, 0.1 * i)):
            for fa, fb in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
                if isinstance(fa, np.ndarray):
                    np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-12)
                else:
                    assert fa == fb
    assert len(ours.history) == 6
    no_tf = tpub.OdomPublisher(publish_tf=False).publish(np.eye(4), 0.0)
    assert no_tf[2] is None


def test_ply_text_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(50, 3)).astype(np.float32) * 10
    valid = rng.random(50) > 0.3
    poses = np.tile(np.eye(4), (7, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(7, 3))
    for mod, d in ((tviz, tmp_path / "ours"), (jviz, tmp_path / "theirs")):
        assert mod.save_ply(str(d / "a.ply"), xyz) == 50
        mod.save_ply(str(d / "b.ply"), xyz, valid, color=(1, 2, 3))
        mod.save_trajectory_ply(str(d / "t.ply"), poses)
        mod.export_frame_debug(str(d), 3, xyz, valid, xyz[:10], None,
                               xyz[10:], valid[10:])
    files = sorted(p.relative_to(tmp_path / "theirs")
                   for p in (tmp_path / "theirs").rglob("*.ply"))
    assert len(files) == 6
    for f in files:
        assert ((tmp_path / "ours" / f).read_text()
                == (tmp_path / "theirs" / f).read_text()), f


def test_presets_match_jax():
    for name in ("kitti_preset", "ouster_preset"):
        for kw in ({}, {"mapping": True}):
            ours = getattr(tpresets, name)(**kw)
            theirs = getattr(jpresets, name)(**kw)
            for a, b in zip(ours, theirs):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (dataclasses.asdict(tpresets.ouster_preset(128)[0])
            == dataclasses.asdict(jpresets.ouster_preset(128)[0]))
    assert (dataclasses.asdict(tpresets.mapping_preset())
            == dataclasses.asdict(jpresets.mapping_preset()))


# --- the channel and rate-watchdog cases of tests/test_runtime.py ----------

def test_channel_fifo_and_backpressure():
    ch = Channel(maxsize=2)
    ch.push(1)
    ch.push(2)
    assert not ch.push(3, timeout=0.05)       # full -> timed out
    assert ch.pop() == 1
    assert ch.push(3, timeout=0.05)
    assert ch.pop() == 2 and ch.pop() == 3
    with pytest.raises(TimeoutError):
        ch.pop(timeout=0.05)
    lossy = Channel(maxsize=2)
    assert [lossy.offer_latest(i) for i in range(4)] == [0, 0, 1, 1]
    assert lossy.dropped == 2 and lossy.pop() == 2


def test_channel_threaded_producer_consumer_and_close():
    ch = Channel(maxsize=4)
    got = []

    def consumer():
        while True:
            try:
                got.append(ch.pop())
            except Closed:
                return

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(100):
        ch.push(i)
    ch.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert got == list(range(100))
    with pytest.raises(Closed):
        ch.push(1)
    lv = LatestValue()
    assert lv.get() is None
    lv.set(5)
    lv.set(7)
    assert lv.get() == 7 and lv.take() == 7 and lv.get() is None


def test_frequency_monitor():
    fm = FrequencyMonitor()
    warned = False
    for k in range(20):
        fm.tick_input(t=k * 0.1)
    for k in range(20):
        warned = warned or fm.tick_output(t=k * 0.2) is not None
    assert warned
    assert fm.input_hz() == pytest.approx(10.0, rel=0.01)
    assert fm.output_hz() == pytest.approx(5.0, rel=0.01)
    quiet = FrequencyMonitor()
    for k in range(20):
        quiet.tick_input(t=k * 0.1)
        assert quiet.tick_output(t=k * 0.1 + 0.02) is None


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    return (type(a) is type(b)
            and all(_tree_equal(x, y) for x, y in zip(a, b)))


def test_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    cfg = LiodomConfig(ring_width=256, local_map_size=2, scan_lines=16,
                       mapping=True)
    mcfg = MapConfig(map_capacity=512, local_map_capacity=64)
    state = P.init_state(cfg, received_capacity=64, device="cpu")
    state = state._replace(
        window=state.window._replace(
            xyz=torch.from_numpy(rng.normal(size=tuple(
                state.window.xyz.shape)).astype(np.float32)),
            next_slot=torch.tensor(1), nframes=torch.tensor(1)),
        odom=Pose(torch.tensor([0.6, 0.0, 0.8, 0.0]),
                  torch.tensor([1.0, 2.0, 3.0])))
    pts = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32) * 9)
    m = G.update_map(G.init_map(512, device="cpu"), pts,
                     torch.ones(200, dtype=torch.bool), Pose.identity(),
                     mcfg)
    traj = rng.normal(size=(5, 3, 4))
    CK.save(str(tmp_path), 5, CK.EngineCheckpoint(state, m, traj, 5))
    CK.save(str(tmp_path), 3, CK.EngineCheckpoint(state, None, traj[:3], 3))
    assert CK.latest_step(str(tmp_path)) == 5
    meta = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())
    assert meta == {"frame_index": 5, "has_map": True, "format": 1}
    tmpl = {"odom_state": P.init_state(cfg, received_capacity=64,
                                       device="cpu"),
            "map_state": G.init_map(512, device="cpu")}
    step, ck = CK.restore(str(tmp_path), template=tmpl)
    assert step == 5 and ck.frame_index == 5
    assert _tree_equal(ck.odom_state, state) and _tree_equal(ck.map_state, m)
    np.testing.assert_array_equal(ck.trajectory, traj)
    step, ck = CK.restore(str(tmp_path), step=3, template=tmpl)
    assert step == 3 and ck.map_state is None and len(ck.trajectory) == 3
    # without a template: nested dicts of tensors
    _, raw = CK.restore(str(tmp_path))
    assert torch.equal(raw.odom_state["odom"]["t"], state.odom.t)
    assert torch.equal(raw.map_state["code"], m.code)
    # a template of another shape is refused
    with pytest.raises(ValueError, match="odom_state.window.xyz"):
        CK.restore(str(tmp_path), template={
            "odom_state": P.init_state(cfg.replace(local_map_size=3),
                                       received_capacity=64, device="cpu"),
            "map_state": G.init_map(512, device="cpu")})
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "none"))


def test_stager_and_block_fetch_on_the_cpu():
    dev = torch.device("cpu")
    stager = DIO.Stager((4, 8, 3), dev)
    img = np.arange(96, dtype=np.float32).reshape(4, 8, 3)
    x, c = stager.put(img, np.array([1, 2, 3, 4]))
    img[0, 0, 0] = -1.0                 # the staged frame is a copy
    assert x.device == dev and x.dtype == torch.float32 and x[0, 0, 0] == 0
    assert c.dtype == torch.int32 and c.tolist() == [1, 2, 3, 4]
    q = torch.tensor([[1.0, 0, 0, 0], [0.6, 0.0, 0.8, 0.0]])
    t = torch.tensor([[1.0, 2, 3], [4.0, 5, 6]])
    pending = [(q[0], t[0], torch.tensor(7, dtype=torch.int32)),
               (q[1:], t[1:], torch.tensor([9], dtype=torch.int32))]
    mats, nes = DIO.fetch_poses(pending)
    np.testing.assert_array_equal(
        mats, Pose(q, t).matrix().numpy().astype(np.float64))
    assert nes.tolist() == [7, 9]
    audit = DIO.SyncAudit(dev)
    with audit, audit.allowed():
        pass
    assert audit.count == 0 and DIO.prepare_kernels(("smoothness",),
                                                    dev) == {}
    assert DIO.path_kernels(False) == ("smoothness", "select", "knn_coords",
                                       "lm_solve")
    assert DIO.path_kernels(True)[4:] == ("local_map_compact",
                                          "probe_insert", "map_fold")
    # the sharded steps search with K5, whatever LIODOM_KNN_IMPL says
    assert DIO.path_kernels(True, sharded=True) == (
        "smoothness", "select", "knn_index", "local_map_compact",
        "probe_insert", "map_fold")
    assert DIO.path_kernels(False, sharded=True)[2:] == ("knn_index",)
