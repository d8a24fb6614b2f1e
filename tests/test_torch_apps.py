"""The port's apps (``liodom_tpu_torch/apps``, ``--device cpu``) against the
JAX apps (``apps/*.py``, run in this process as
``tests/test_run_kitti_e2e.py`` runs them) on the same inputs: equal edge
counts, poses within 1 cm and 1e-3 rad a frame (the bar of
``tests/test_torch_pipeline.py``: the two engines sum the solver's normal
equations in another order), the results files' layout and headers
identical; ``--chunk`` within 1e-6 m of the per-frame run, resume bit for
bit, and a JAX checkpoint carried across and resumed by the port.  Each
JAX run is shared by the tests through a module-scoped fixture, with the
JAX package's persistent compilation cache off."""

import importlib.util
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from liodom_tpu.runtime import checkpoint as JCK
from liodom_tpu_torch import convert
from liodom_tpu_torch.apps import run_kitti, run_mapping, run_ouster
from liodom_tpu_torch.apps import run_synthetic
from liodom_tpu_torch.core.organize import organized_from_unorganized
from liodom_tpu_torch.core.synth import BoxWorld, drive_trajectory, yaw_matrix
from liodom_tpu_torch.runtime import checkpoint as CK

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RESULTS = ("poses.txt", "feat_ext_times.txt", "laser_odom_times.txt",
           "nfeats.txt", "frame_times.txt")
N_SCANS = 6
KITTI_FLAGS = ["--seq", "00", "--local-map-size", "3", "--ring-width", "512"]
# the received local map cut to 8,192 rows (the neighbourhood holds under
# 2,000 here): JAX's CPU run at the default 65,536 takes 48 s
MAPPING = ["--mapping", "--local-map-capacity", "8192"]


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache():
    """The JAX apps turn the persistent cache on when loaded; a warm
    ``.jax_cache/`` breaks ``tests/test_aot.py`` on a later worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIODOM_JAX_CACHE", "off")
        yield


@pytest.fixture(scope="module", autouse=True)
def _two_cores():
    """Every thread of this process on two cores while the file runs: the
    JAX apps compute on XLA's CPU thread pool, which spans every core, and
    the suite's other workers hold paced tests (``tests/test_run_stream.py``
    must finish a frame within its sensor period)."""
    threads = [int(t) for t in os.listdir("/proc/self/task")]
    before = {t: os.sched_getaffinity(t) for t in threads}
    cores = set(sorted(os.sched_getaffinity(0))[-2:])
    for t in threads:
        os.sched_setaffinity(t, cores)
    try:
        yield
    finally:
        for t in os.listdir("/proc/self/task"):
            os.sched_setaffinity(int(t), before.get(int(t),
                                                    before[threads[0]]))


def _run_jax(app: str, argv) -> int:
    """``apps/<app>.py``'s ``main()`` in this process, loaded under a name
    of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_app_{app}", REPO / "apps" / f"{app}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [f"{app}.py"] + [str(a) for a in argv]
    try:
        return mod.main()
    finally:
        sys.argv = old


def _run_port(app, argv) -> dict:
    rep = app.run([str(a) for a in argv] + ["--device", "cpu"])
    assert rep["rc"] == 0, rep
    return rep


def _poses(d: Path) -> np.ndarray:
    return np.loadtxt(d / "poses.txt").reshape(-1, 3, 4)


def _assert_close_poses(a: np.ndarray, b: np.ndarray, dt=0.01, dr=1e-3):
    """Every frame within ``dt`` m and ``dr`` rad."""
    assert a.shape == b.shape
    np.testing.assert_array_less(
        np.linalg.norm(a[:, :, 3] - b[:, :, 3], axis=1), dt)
    rel = np.einsum("fji,fjk->fik", a[:, :, :3], b[:, :, :3])
    sin = 0.5 * np.linalg.norm(np.stack(
        [rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
         rel[:, 1, 0] - rel[:, 0, 1]], axis=1), axis=1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1.0)
    np.testing.assert_array_less(np.arctan2(sin, cos), dr)


def _assert_results_match(ours: Path, theirs: Path):
    """Same five files, same rows, same header; equal edge counts and poses
    within the port-vs-JAX bar."""
    assert (sorted(p.name for p in ours.iterdir())
            == sorted(p.name for p in theirs.iterdir()) == sorted(RESULTS))
    for name in RESULTS:
        a = (ours / name).read_text().splitlines()
        b = (theirs / name).read_text().splitlines()
        assert len(a) == len(b), name
        assert [len(r.split()) for r in a] == [len(r.split()) for r in b]
    head = "laser_odom_times.txt"
    assert ((ours / head).read_text().splitlines()[0]
            == (theirs / head).read_text().splitlines()[0])
    np.testing.assert_array_equal(np.loadtxt(ours / "nfeats.txt"),
                                  np.loadtxt(theirs / "nfeats.txt"))
    _assert_close_poses(_poses(ours), _poses(theirs))


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """A KITTI tree as ``tests/test_run_kitti_e2e.py`` writes it: 6 scans
    of 500 columns, an identity ``Tr``."""
    root = tmp_path_factory.mktemp("kitti")
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    world = BoxWorld(seed=0)
    pos, yaws = drive_trajectory(N_SCANS, speed=1.0, yaw_rate=0.01)
    gt = np.tile(np.eye(4), (N_SCANS, 1, 1))
    for i in range(N_SCANS):
        pts = world.render(pos[i], yaw_matrix(yaws[i]), width=500,
                           noise=0.005, seed=i)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec.tofile(str(seq / "velodyne" / f"{i:06d}.bin"))
        gt[i, :3, :3] = yaw_matrix(yaws[i])
        gt[i, :3, 3] = pos[i]
    np.savetxt(seq / "times.txt", np.arange(N_SCANS) * 0.1)
    (seq / "calib.txt").write_text(
        "Tr: " + " ".join(str(v) for v in np.eye(4)[:3].reshape(-1)) + "\n")
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt",
               gt[:, :3, :].reshape(N_SCANS, 12))
    return root


@pytest.fixture(scope="module")
def jax_kitti(tree) -> dict:
    """JAX run_kitti: the run with a checkpoint at frame 4, its resume, and
    the mapping run."""
    out = {k: tree / f"jax_{k}" for k in ("res", "ck", "resumed", "map")}
    base = ["--root", tree] + KITTI_FLAGS
    assert _run_jax("run_kitti", base + [
        "--results-dir", out["res"], "--checkpoint-dir", out["ck"],
        "--checkpoint-every", 4]) == 0
    assert JCK.latest_step(str(out["ck"])) == 4
    # the resume runs from a copy: the checkpoint stays at frame 4
    shutil.copytree(out["ck"], tree / "jax_ck_resume")
    assert _run_jax("run_kitti", base + [
        "--results-dir", out["resumed"],
        "--checkpoint-dir", tree / "jax_ck_resume"]) == 0
    assert _run_jax("run_kitti", base + MAPPING + [
        "--results-dir", out["map"]]) == 0
    return out


@pytest.fixture(scope="module")
def port_kitti(tree) -> dict:
    """The port's run_kitti: per frame with a checkpoint at frame 4, its
    resume, ``--chunk 4``, and the mapping run and its resume."""
    out = {k: tree / f"port_{k}" for k in (
        "res", "ck", "resumed", "chunk", "map", "map_ck", "map_resumed")}
    base = ["--root", tree] + KITTI_FLAGS
    out["report"] = _run_port(run_kitti, base + [
        "--results-dir", out["res"], "--checkpoint-dir", out["ck"],
        "--checkpoint-every", 4])
    out["resumed_report"] = _run_port(run_kitti, base + [
        "--results-dir", out["resumed"], "--checkpoint-dir", out["ck"]])
    _run_port(run_kitti, base + ["--results-dir", out["chunk"],
                                 "--chunk", 4])
    _run_port(run_kitti, base + MAPPING + [
        "--results-dir", out["map"],
        "--checkpoint-dir", out["map_ck"], "--checkpoint-every", 4])
    out["map_resumed_report"] = _run_port(run_kitti, base + MAPPING + [
        "--results-dir", out["map_resumed"],
        "--checkpoint-dir", out["map_ck"]])
    return out


def test_run_kitti_matches_jax(jax_kitti, port_kitti):
    _assert_results_match(port_kitti["res"], jax_kitti["res"])
    rep = port_kitti["report"]
    assert rep["frames"] == N_SCANS and rep["host_syncs"] == 0
    assert rep["native_loader"] and (port_kitti["ck"] / "step_00000004"
                                     / "state.pt").exists()


def test_run_kitti_mapping_matches_jax(jax_kitti, port_kitti):
    _assert_results_match(port_kitti["map"], jax_kitti["map"])


def test_run_kitti_chunk_matches_per_frame(port_kitti):
    """``--chunk 4`` on 6 frames: one chained call and a 2-frame per-frame
    tail, within 1e-6 m of the per-frame run (bit for bit on the CPU)."""
    a, b = _poses(port_kitti["chunk"]), _poses(port_kitti["res"])
    np.testing.assert_array_less(np.abs(a[:, :, 3] - b[:, :, 3]), 1e-6)
    np.testing.assert_array_equal(np.loadtxt(port_kitti["chunk"]
                                             / "nfeats.txt"),
                                  np.loadtxt(port_kitti["res"]
                                             / "nfeats.txt"))


@pytest.mark.parametrize("whole,resumed", [("res", "resumed"),
                                           ("map", "map_resumed")])
def test_run_kitti_resume_is_bit_for_bit(port_kitti, whole, resumed):
    """A run resumed from the checkpoint at frame 4 writes the
    uninterrupted run's poses, text for text (the map's too, on the CPU)."""
    assert ((port_kitti[resumed] / "poses.txt").read_text()
            == (port_kitti[whole] / "poses.txt").read_text())
    # the resumed run counts the edges of the frames it ran
    assert ((port_kitti[resumed] / "nfeats.txt").read_text().splitlines()
            == (port_kitti[whole] / "nfeats.txt").read_text().splitlines()[
                4:])
    rep = port_kitti[f"{resumed}_report"]
    assert rep["start_frame"] == 4 and rep["frames"] == N_SCANS - 4


def test_jax_checkpoint_resumed_by_the_port(tree, jax_kitti):
    """A JAX checkpoint (orbax, read back without a template), carried
    across by ``convert.checkpoint_from_numpy`` and resumed by the port's
    run_kitti, continues as JAX's own resumed run."""
    step, jck = JCK.restore(str(jax_kitti["ck"]))
    assert step == 4
    ck = convert.checkpoint_from_numpy(jck, device="cpu")
    assert ck.frame_index == 4 and ck.map_state is None
    assert ck.odom_state.received_xyz.shape == (0, 3)
    port_ck = tree / "port_ck_from_jax"
    CK.save(str(port_ck), step, ck)
    res = tree / "port_from_jax"
    rep = _run_port(run_kitti, ["--root", tree] + KITTI_FLAGS + [
        "--results-dir", res, "--checkpoint-dir", port_ck])
    assert rep["start_frame"] == 4
    ours, theirs = _poses(res), _poses(jax_kitti["resumed"])
    np.testing.assert_array_equal(ours[:4], theirs[:4])   # restored rows
    _assert_close_poses(ours, theirs)


SYNTHETIC = {"plain": [], "mapping_raw": ["--mapping", "--raw-path",
                                          "--map-capacity", 65536,
                                          "--local-map-capacity", 8192]}


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("synthetic")
    out = {}
    for name, extra in SYNTHETIC.items():
        argv = ["--frames", 6, "--width", 256, "--ring-width", 512,
                "--local-map-size", 3] + extra
        assert _run_jax("run_synthetic", argv + [
            "--save-results-dir", root / f"jax_{name}"]) == 0
        rep = _run_port(run_synthetic, argv + [
            "--save-results-dir", root / f"port_{name}"])
        out[name] = (root / f"port_{name}", root / f"jax_{name}", rep)
    return out


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_run_synthetic_matches_jax(synthetic_runs, name):
    ours, theirs, rep = synthetic_runs[name]
    _assert_results_match(ours, theirs)
    assert rep["frames"] == 6 and rep["ate_m"] < 0.5
    if name == "mapping_raw":
        assert rep["map_overflow"] == 0 and rep["local_map_truncated"] == 0


OUSTER = ["--synthetic", "--frames", 4, "--width", 256,
          "--local-map-size", 3]


def test_run_ouster_matches_jax(tmp_path):
    assert _run_jax("run_ouster", OUSTER + [
        "--results-dir", tmp_path / "jax"]) == 0
    rep = _run_port(run_ouster, OUSTER + ["--results-dir", tmp_path / "port",
                                          "--checkpoint-dir", tmp_path / "ck",
                                          "--checkpoint-every", 4])
    _assert_results_match(tmp_path / "port", tmp_path / "jax")
    assert rep["rings"] == 64 and rep["frames"] == 4
    # a resume whose checkpoint covers --frames: nothing to do, exit 0
    rep = _run_port(run_ouster, OUSTER + ["--checkpoint-dir",
                                          tmp_path / "ck"])
    assert rep["start_frame"] == 4 and rep["frames"] == 0


def test_run_ouster_dir_matches_jax(tmp_path):
    """``--dir``: BoxWorld spins binned by elevation into 64 organised rows
    (NaN where a cell has no return) and read back from ``.npy`` files."""
    world = BoxWorld(seed=1)
    pos, yaws = drive_trajectory(4, speed=1.0, yaw_rate=0.01)
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i in range(4):
        np.save(clouds / f"{i:06d}.npy", organized_from_unorganized(
            world.render(pos[i], yaw_matrix(yaws[i]), width=256, noise=0.01,
                         seed=i), 64, 256))
    argv = ["--dir", clouds, "--local-map-size", 3]
    assert _run_jax("run_ouster", argv + [
        "--results-dir", tmp_path / "jax"]) == 0
    rep = _run_port(run_ouster, argv + ["--results-dir", tmp_path / "port"])
    _assert_results_match(tmp_path / "port", tmp_path / "jax")
    assert rep["rings"] == 64 and rep["frames"] == 4


def _ply_vertices(path: Path) -> int:
    for line in path.read_text().splitlines():
        if line.startswith("element vertex"):
            return int(line.split()[-1])
    raise AssertionError(f"no vertex count in {path}")


def test_run_mapping_matches_jax(tree, jax_kitti):
    argv = ["--root", tree, "--seq", "00", "--poses",
            jax_kitti["res"] / "poses.txt", "--ring-width", 512]
    assert _run_jax("run_mapping", argv + ["--out", tree / "jax_map_out"]) \
        == 0
    rep = _run_port(run_mapping, argv + ["--out", tree / "port_map_out"])
    n = _ply_vertices(tree / "jax_map_out" / "map.ply")
    assert rep["occupied_slots"] == n > 100
    assert _ply_vertices(tree / "port_map_out" / "map.ply") == n
    assert (tree / "port_map_out" / "map_local.ply").exists()
