#!/usr/bin/env python3
"""The kNN walk of K3, K4, K5 and K6 on the card: splits of the cluster walk
against each other and against an earlier walk, on the same inputs, in one
process.

    python3 scripts/knn_walk_experiment.py [--earlier DIR]
        [--splits 8x4,16x4,...] [--index-splits 8x4,16x2,...]
        [--list-splits 8x1,4x2,...] [--any-k-ks 5,17,64,512] [--out FILE]

Builds ``csrc/knn_coords.cu``, ``csrc/knn_lines.cu`` and
``csrc/knn_index.cu`` of this checkout as they are (``shipped``; the
splits the libraries' ``liodom_knn_walk_shape`` report are printed), once
for each other split ``SxG`` of ``--splits`` (S blocks a cluster, G thread
groups a block: a copy of the sources under ``kernels/build/experiment/``
whose ``knn_search.cuh`` has ``kCluster = S`` and ``kGroups = G`` written
in, K3/K4/K6 only, the report checked), once for each split of
``--index-splits`` (the same with ``knn_index.cu``'s ``kIndexCluster`` and
``kIndexGroups``, K5 only), once for each split of ``--list-splits``
(``knn_search.cuh``'s ``kListCluster`` and ``kListGroups``: the run-time-k
walk ``ListWalk`` of all three sources, each build's
``liodom_knn_any_k_shape`` checked) and, with ``--earlier`` (and ``--also
LABEL=DIR``), those of other ``csrc`` directories (for example an earlier
commit's, unpacked by ``git archive``; an earlier K5 with its separate
merge kernel and partial lists is called through its own entry point),
one ``nvcc`` a source, all started together, into
``kernels/build/experiment/``.

Inputs: the bench drive's last frame as ``chip_smoke.py``'s kernels phase
builds them (K3 and K6 on lane 0's edges against the window they met, K4
on lanes 0-3 at B = 4; K5 without a radius on that frame's 5,632 edge
slots against the combined step's matching map, window and received map,
the shape of the sharded flagship's call) and the tie-heavy scenes (one
pair; 4 as a batch; K5 on them without a radius).  Every build's outputs
on every input must be ``torch.equal`` to the shipped build's, the shipped
K3/K4 to ``knn_launch_plain`` and the shipped K5 to
``knn_index_launch_plain`` (every row) and ``knn_index_plain`` (every
valid query).  Then each build's kernels time by CUDA events over 50
launches, the builds in turns (forward, then backward).

The ``*_any_k`` entry points (``ListWalk``) of every build are held and
timed the same way: K3' on the bench frame at each k of ``--any-k-ks``
(its lists in shared memory, at 512 in the device scratch, each build's
scratch sized by its own shape call), K4' (B = 4), K5' (without a radius)
and K6' at k = 17, each output ``torch.equal`` to its plain version
(``knn_launch_plain``, ``knn_index_launch_plain``,
``knn_lines_launch_plain``'s endpoints) on the bench and tie inputs.
Prints one JSON object (and writes it to ``--out``); exits 1 if any
output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402
from liodom_tpu_torch import kernels  # noqa: E402
from liodom_tpu_torch.core import pose as se3  # noqa: E402
from liodom_tpu_torch.core.config import LiodomConfig  # noqa: E402
from liodom_tpu_torch.core.synth import tie_scene  # noqa: E402
from liodom_tpu_torch.mapping import service as S  # noqa: E402
from liodom_tpu_torch.odometry import local_map  # noqa: E402
from liodom_tpu_torch.odometry import pipeline as P  # noqa: E402
from liodom_tpu_torch.ops import features as F  # noqa: E402
from liodom_tpu_torch.ops import knn_pallas as KNN  # noqa: E402
from liodom_tpu_torch.parallel.sharded import init_batch_state  # noqa: E402

COORDS_SOURCES = ("knn_coords", "knn_lines")
SOURCES = COORDS_SOURCES + ("knn_index",)
REPS = 50
ANY_K = 17        # K4', K5' and K6' on ListWalk
# an earlier K5 (two kernels, partial lists in device memory): its entry
# point and split count
_OLD_INDEX_SIG = [("liodom_knn_index", [KNN._PTR] * 8 + [KNN._INT] * 9
                   + [KNN._PTR])]
_OLD_INDEX_SPLITS = 16


def split_csrc(src: Path, out: Path, split: str, index: bool = False,
               listwalk: bool = False) -> Path:
    """A copy of the ``.cu`` and ``.cuh`` sources of ``src`` in ``out``,
    with the walk's split ``SxG`` written into ``knn_search.cuh``'s
    ``kCluster`` and ``kGroups`` (K3/K4/K6), with ``index`` into
    ``knn_index.cu``'s ``kIndexCluster`` and ``kIndexGroups`` (K5), or with
    ``listwalk`` into ``knn_search.cuh``'s ``kListCluster`` and
    ``kListGroups`` (ListWalk)."""
    out.mkdir(parents=True, exist_ok=True)
    for f in list(src.glob("*.cu")) + list(src.glob("*.cuh")):
        shutil.copy(f, out / f.name)
    name_file = "knn_index.cu" if index else "knn_search.cuh"
    names = (("kIndexCluster", "kIndexGroups") if index
             else ("kListCluster", "kListGroups") if listwalk
             else ("kCluster", "kGroups"))
    text = (out / name_file).read_text()
    for name, value in zip(names, split.split("x")):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise SystemExit(f"{src}/{name_file}: no single {name}")
    (out / name_file).write_text(text)
    return out


def walk_shape(lib) -> tuple:
    """(blocks a cluster, thread groups a block) of a built library."""
    out = (ctypes.c_int * 3)()
    kernels.check(lib.liodom_knn_walk_shape(0, ctypes.addressof(out)),
                  "liodom_knn_walk_shape")
    return out[0], out[1]


def build(variants: dict, sources=SOURCES,
          out_dir: Path = kernels.BUILD_DIR / "experiment") -> dict:
    """{label: {source: (CDLL, ptxas usage)}}; variants {label: csrc
    directory, or (csrc directory, its sources)}, the sources ``sources``
    where not given; the libraries land in ``out_dir``."""
    nvcc = kernels.nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, v in variants.items():
        csrc, names = v if isinstance(v, tuple) else (v, sources)
        for name in names:
            so = out_dir / f"{name}-{label}.so"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", str(so),
                   str(Path(csrc) / f"{name}.cu")]
            jobs[label, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for (label, name), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{label} {name}.cu: nvcc exit "
                             f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        sigs = {"knn_coords": KNN._SIG, "knn_lines": KNN._LINES_SIG,
                "knn_index": KNN._INDEX_SIG}[name]
        if name == "knn_index" and not hasattr(lib, KNN._SHAPE_SIG[0]):
            sigs = _OLD_INDEX_SIG            # the two-kernel K5
        for symbol, argtypes in sigs:
            if symbol == KNN._SHAPE_SIG[0] and not hasattr(lib, symbol):
                continue                  # a walk that predates the query
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        libs.setdefault(label, {})[name] = (lib, CS.ptxas_usage(log))
    return libs


def coords(lib, q4, r4, flags, qperm):
    """K3 (flags 2-D) or K4 (3-D) of one build, as the port's wrappers
    call it."""
    batched = flags.ndim == 3
    lead = flags.shape[:-2]
    n_e, n_m = flags.shape[-2:]
    e = qperm.shape[-1]
    out_d = torch.empty(lead + (e, KNN.K), device=q4.device)
    out_c = torch.empty(lead + (e, KNN.K, 3), device=q4.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q4, r4, flags, qperm, out_d, out_c)]
    tail = [KNN.TILE_E, KNN.TILE_M, KNN.K, stream]
    if batched:
        err = lib.liodom_knn_coords_batched(*ptrs, lead[0], e, n_e, n_m,
                                            *tail)
    else:
        err = lib.liodom_knn_coords(*ptrs, e, n_e, n_m, *tail)
    kernels.check(err, "knn_coords")
    return out_d, out_c


def lines(lib, q4, r4, flags, qperm, gates):
    """K6 of one build on a batch of prepared pairs."""
    b, n_e, n_m = flags.shape
    e = qperm.shape[-1]
    lpa = torch.empty((b, e, 3), device=q4.device)
    lpb = torch.empty((b, e, 3), device=q4.device)
    ok = torch.empty((b, e), dtype=torch.bool, device=q4.device)
    err = lib.liodom_knn_lines(
        *[t.data_ptr() for t in (q4, r4, flags, qperm, lpa, lpb, ok)], b, e,
        n_e, n_m, KNN.TILE_E, KNN.TILE_M, KNN.K, float(gates[0]),
        float(gates[1]), float(gates[2]) ** 2,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "knn_lines")
    return lpa, lpb, ok


def index(lib, q4, r4, flags, qperm, m):
    """K5 of one build on a batch of prepared pairs, through the entry point
    the build has (an earlier two-kernel K5 with its partial lists)."""
    b, n_e, n_m = flags.shape
    e = qperm.shape[-1]
    out_d = torch.empty((b, e, KNN.K), device=q4.device)
    out_i = torch.empty((b, e, KNN.K), dtype=torch.int32, device=q4.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q4, r4, flags, qperm)]
    if hasattr(lib, KNN._SHAPE_SIG[0]):
        err = lib.liodom_knn_index(*ptrs, out_d.data_ptr(), out_i.data_ptr(),
                                   b, e, n_e, n_m, m, KNN.TILE_E, KNN.TILE_M,
                                   KNN.K, stream)
    else:
        splits = max(1, min(_OLD_INDEX_SPLITS, n_m))
        part_d = torch.empty((b, splits, n_e * KNN.TILE_E, KNN.K),
                             device=q4.device)
        part_i = torch.empty(part_d.shape, dtype=torch.int32,
                             device=q4.device)
        err = lib.liodom_knn_index(*ptrs, part_d.data_ptr(),
                                   part_i.data_ptr(), out_d.data_ptr(),
                                   out_i.data_ptr(), b, e, n_e, n_m, m,
                                   splits, KNN.TILE_E, KNN.TILE_M, KNN.K,
                                   stream)
    kernels.check(err, "knn_index")
    return out_d, out_i


def any_k_shape(lib, n_m: int, k: int) -> list:
    """A build's ``liodom_knn_any_k_shape`` (an earlier ListWalk fills the
    first 4 of the 6 ints)."""
    out = (ctypes.c_int * 6)()
    kernels.check(lib.liodom_knn_any_k_shape(n_m, k, ctypes.addressof(out)),
                  "liodom_knn_any_k_shape")
    return list(out)


_SCRATCH = {}   # a build's list scratch, kept across calls


def _any_k(lib, label, symbol, q4, r4, flags, qperm, k, outs,
           extra_ints=(), extra_floats=()) -> None:
    """``symbol`` of one build on prepared tensors with a batch dimension,
    as ``knn_pallas._any_k`` calls it, the scratch sized by the build."""
    b, n_e, n_m = flags.shape
    shape = any_k_shape(lib, n_m, k)
    scratch = None
    if not shape[1]:
        n = b * n_e * shape[3] // 4
        buf = _SCRATCH.get(label)
        if buf is None or buf.numel() < n:
            buf = _SCRATCH[label] = torch.empty(n, device=q4.device)
        scratch = buf.data_ptr()
    err = getattr(lib, symbol)(
        q4.data_ptr(), r4.data_ptr(), flags.data_ptr(), qperm.data_ptr(),
        scratch, *(t.data_ptr() for t in outs), b, qperm.shape[-1], n_e,
        n_m, *extra_ints, KNN.TILE_E, KNN.TILE_M, k, *extra_floats,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(err, symbol)


def coords_any_k(lib, label, q4, r4, flags, qperm, k):
    """K3' (flags 2-D) or K4' (3-D) of one build."""
    lead = flags.shape[:-2]
    e = qperm.shape[-1]
    out_d = torch.empty(lead + (e, k), device=q4.device)
    out_c = torch.empty(lead + (e, k, 3), device=q4.device)
    _any_k(lib, label, "liodom_knn_coords_any_k", q4, r4,
           flags if flags.ndim == 3 else flags[None], qperm, k,
           (out_d, out_c))
    return out_d, out_c


def lines_any_k(lib, label, q4, r4, flags, qperm, gates, k):
    """K6' of one build on a batch of prepared pairs."""
    b, e = flags.shape[0], qperm.shape[-1]
    lpa = torch.empty((b, e, 3), device=q4.device)
    lpb = torch.empty((b, e, 3), device=q4.device)
    ok = torch.empty((b, e), dtype=torch.bool, device=q4.device)
    _any_k(lib, label, "liodom_knn_lines_any_k", q4, r4, flags, qperm, k,
           (lpa, lpb, ok), extra_floats=(float(gates[0]), float(gates[1]),
                                         float(gates[2]) ** 2))
    return lpa, lpb, ok


def index_any_k(lib, label, q4, r4, flags, qperm, m, k):
    """K5' of one build on a batch of prepared pairs."""
    b, e = flags.shape[0], qperm.shape[-1]
    out_d = torch.empty((b, e, k), device=q4.device)
    out_i = torch.empty((b, e, k), dtype=torch.int32, device=q4.device)
    _any_k(lib, label, "liodom_knn_index_any_k", q4, r4, flags, qperm, k,
           (out_d, out_i), extra_ints=(m,))
    return out_d, out_i


def bench_inputs(cfg, dev, radius):
    """K3's (lane 0) and K4's (lanes 0-3) prepared inputs at the bench
    drive's last frame, as chip_smoke.py's kernels phase builds them, and
    K5's without a radius: that frame's edge slots (uncompacted) at its
    pose against the matching map the combined step's frame before left
    (window and received map), with the query points and the ref count."""
    lanes = CS.render_lanes(cfg, dev, range(CS.LANES), noise=0.01)
    imgs = lanes[0][0]
    states, poses, _ = CS.run_course(P.init_state(cfg), imgs, cfg)
    img = imgs[-1]
    ec = F.select_edges(img, F.smoothness(img, cfg), cfg)
    map_xyz, map_valid = KNN.spatial_sort_points(
        *local_map.flatten(states[-2].window))
    qxyz, qvalid = local_map.compact(ec.xyz, ec.valid)
    query = se3.transform(poses[-1], qxyz)
    prep = KNN.knn_prepare(query, qvalid, map_xyz, map_valid, radius,
                           ref_presorted=True)
    ccfg = cfg.replace(mapping=True)
    cstates, cposes, _ = CS.run_combined(*S.init_combined(ccfg, CS.MCFG),
                                         imgs, ccfg)
    m5_xyz, m5_valid = P._matching_map(cstates[-2][0], ccfg)
    q5 = se3.transform(cposes[-1], ec.xyz)
    pts5 = (q5[None], ec.valid[None], m5_xyz[None], m5_valid[None])
    prep5 = KNN.knn_prepare_batched(*pts5, None)

    bimgs = CS.stack_lanes([lanes[s][0] for s in range(CS.LANES)])
    bstates, bposes, _ = CS.run_course(init_batch_state(cfg, CS.LANES),
                                       bimgs, cfg, step=P.batch_image_step)
    bimg = bimgs[-1]
    ec_b = F.select_edges(bimg, F.smoothness(bimg, cfg), cfg)
    qxyz_b, qvalid_b = local_map.compact(ec_b.xyz, ec_b.valid)
    query_b = se3.transform(bposes[-1], qxyz_b)
    map_b, mvalid_b = KNN.spatial_sort_points(
        *local_map.flatten(bstates[-2].window))
    prep_b = KNN.knn_prepare_batched(query_b, qvalid_b, map_b, mvalid_b,
                                     radius, ref_presorted=True)
    return prep, prep_b, (prep5, m5_xyz.shape[0], pts5)


def tie_inputs(dev, radius):
    """The tie scenes (one pair; 4 as a batch) prepared with ``radius``:
    the tensors of each and its points."""
    scenes = [tie_scene(s, 3000, 20000) for s in range(CS.LANES)]
    q, qm, r, rm = (torch.from_numpy(np.stack([sc[i] for sc in scenes]))
                    .to(dev) for i in range(4))
    pts1 = (q[:1], qm[:1], r[:1], rm[:1])
    return ((KNN.knn_prepare_batched(*pts1, radius), pts1),
            (KNN.knn_prepare_batched(q, qm, r, rm, radius),
             (q, qm, r, rm)))


def index_vs_plain(prep, m, pts, d_k, i_k) -> bool:
    """A K5 build's answer against the keyed selection on every row and
    against the brute force on every valid query."""
    d_o, i_o = KNN.knn_index_launch_plain(*prep, m)
    ok = torch.equal(d_k, d_o) and torch.equal(i_k, i_o)
    d_p, i_p = KNN.knn_index_plain(*pts)
    valid = pts[1]
    return ok and torch.equal(d_k[valid], d_p[valid]) and torch.equal(
        i_k[valid], i_p[valid])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path,
                    help="another csrc directory to build and compare")
    ap.add_argument("--also", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="more csrc directories to build, compare and time")
    ap.add_argument("--splits", default="8x4,4x2,16x2,8x1",
                    help="other splits of K3/K4/K6 to build, cluster blocks "
                         "x thread groups a block (empty: none)")
    ap.add_argument("--index-splits", default="8x4,16x2,4x2,8x1",
                    help="other splits of K5 to build (empty: none)")
    ap.add_argument("--list-splits", default="",
                    help="other splits of ListWalk to build (empty: none)")
    ap.add_argument("--any-k-ks", default="5,17,64,512",
                    help="the k of K3' on ListWalk")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn_walk_experiment: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = CS.nvidia_smi_line()
    splits = [sg for sg in args.splits.split(",") if sg]
    index_splits = [sg for sg in args.index_splits.split(",") if sg]
    list_splits = [sg for sg in args.list_splits.split(",") if sg]
    any_ks = [int(x) for x in args.any_k_ks.split(",") if x]
    out_dir = kernels.BUILD_DIR / "experiment"
    variants = {"shipped": kernels.CSRC}
    for sg in splits:
        variants[sg] = (split_csrc(kernels.CSRC, out_dir / f"csrc-{sg}", sg),
                        COORDS_SOURCES)
    for sg in index_splits:
        variants[f"k5 {sg}"] = (split_csrc(
            kernels.CSRC, out_dir / f"csrc-k5-{sg}", sg, index=True),
            ("knn_index",))
    for sg in list_splits:
        variants[f"list {sg}"] = split_csrc(
            kernels.CSRC, out_dir / f"csrc-list-{sg}", sg, listwalk=True)
    if args.earlier is not None:
        variants["earlier"] = args.earlier
    for spec in args.also:
        label, _, path = spec.partition("=")
        variants[label] = Path(path)
    libs = build(variants)
    shipped = {n: "x".join(map(str, walk_shape(libs["shipped"][n][0])))
               for n in SOURCES}
    for label, v in libs.items():
        for name, (lib, _) in v.items():
            want = label.split()[-1] if label in splits or label.startswith(
                "k5 ") else None
            if want is not None and "x".join(map(str, walk_shape(lib))) \
                    != want:
                raise SystemExit(f"{label} {name}: the build reports "
                                 f"{walk_shape(lib)}")
    if shipped["knn_coords"] in splits or f"k5 {shipped['knn_index']}" in libs:
        raise SystemExit(f"a split asked for is the shipped one {shipped}")
    for sg in list_splits:
        for name, (lib, _) in libs[f"list {sg}"].items():
            got = "x".join(map(str, any_k_shape(lib, 1, ANY_K)[4:6]))
            if got != sg:
                raise SystemExit(f"list {sg} {name}: the build reports {got}")

    cfg = LiodomConfig(local_map_size=5)
    radius = cfg.knn_max_sq_dist ** 0.5
    gates = (cfg.knn_max_sq_dist, cfg.eig_ratio, cfg.min_line_sep)
    prep, prep_b, (prep5, m5, pts5) = bench_inputs(cfg, dev, radius)
    (tie, _), (tie_b, _) = tie_inputs(dev, radius)
    (tie5, tpts5), (tie5_b, tpts5_b) = tie_inputs(dev, None)
    inputs = {"bench_k3": prep, f"bench_b{CS.LANES}": prep_b,
              "tie_scene": tuple(t[0] for t in tie),
              f"tie_scene_b{CS.LANES}": tie_b}
    m_tie = tpts5[2].shape[1]
    inputs5 = {"bench_k5": (prep5, m5, pts5),
               "tie_scene": (tie5, m_tie, tpts5),
               f"tie_scene_b{CS.LANES}": (tie5_b, m_tie, tpts5_b)}

    def run_all(label):
        out = {}
        if "knn_coords" in libs[label]:
            co = libs[label]["knn_coords"][0]
            li = libs[label]["knn_lines"][0]
            for name, p in inputs.items():
                pl = p if p[2].ndim == 3 else tuple(x[None] for x in p)
                out[name] = coords(co, *p) + lines(li, *pl, gates)
        if "knn_index" in libs[label]:
            ix = libs[label]["knn_index"][0]
            for name, (p, m, _) in inputs5.items():
                out[f"k5 {name}"] = index(ix, *p, m)
        return out

    ref = run_all("shipped")
    equal, failed = {}, []
    for name, p in inputs.items():
        ok = all(torch.equal(a, b) for a, b in
                 zip(ref[name][:2], KNN.knn_launch_plain(*p)))
        equal[f"shipped vs knn_launch_plain, {name}"] = ok
        failed += [] if ok else [name]
    for name, (p, m, pts) in inputs5.items():
        ok = index_vs_plain(p, m, pts, *ref[f"k5 {name}"])
        equal[f"shipped k5 vs knn_index_launch_plain and knn_index_plain, "
              f"{name}"] = ok
        failed += [] if ok else [f"k5 {name}"]
    for label in libs:
        if label == "shipped":
            continue
        got = run_all(label)
        for name in got:
            ok = all(torch.equal(a, b) for a, b in zip(got[name], ref[name]))
            equal[f"{label} vs shipped, {name}"] = ok
            failed += [] if ok else [f"{label} {name}"]
    torch.cuda.synchronize()

    prep_l = tuple(x[None] for x in prep)
    times = {label: {} for label in libs}
    order = list(libs) + list(libs)[::-1]
    for label in order:
        t = times[label]
        if "knn_coords" in libs[label]:
            co = libs[label]["knn_coords"][0]
            li = libs[label]["knn_lines"][0]
            t.setdefault("k3", []).append(
                CS.cuda_ms(lambda: coords(co, *prep), REPS))
            t.setdefault("k4", []).append(
                CS.cuda_ms(lambda: coords(co, *prep_b), REPS))
            t.setdefault("k6", []).append(CS.cuda_ms(
                lambda: lines(li, *prep_l, gates), REPS))
        if "knn_index" in libs[label]:
            ix = libs[label]["knn_index"][0]
            t.setdefault("k5", []).append(
                CS.cuda_ms(lambda: index(ix, *prep5, m5), REPS))
    # ListWalk: every build's *_any_k outputs against the plain versions,
    # then timed in turns
    any_k = {label: {} for label in libs if set(SOURCES) <= set(libs[label])}
    for label in any_k:
        co = libs[label]["knn_coords"][0]
        li = libs[label]["knn_lines"][0]
        ix = libs[label]["knn_index"][0]
        cases = {}
        for kk in any_ks:
            for name in ("bench_k3", "tie_scene"):
                p = inputs[name]
                cases[f"k3 {name} k={kk}"] = (
                    coords_any_k(co, label, *p, kk),
                    KNN.knn_launch_plain(*p, k=kk))
        for name in (f"bench_b{CS.LANES}", f"tie_scene_b{CS.LANES}"):
            p = inputs[name]
            cases[f"k4 {name} k={ANY_K}"] = (
                coords_any_k(co, label, *p, ANY_K),
                KNN.knn_launch_plain(*p, k=ANY_K))
            cases[f"k6 {name} k={ANY_K}"] = (
                lines_any_k(li, label, *p, gates, ANY_K)[:2],
                KNN.knn_lines_launch_plain(*p, *gates, k=ANY_K)[:2])
        for name, (p, m, _) in inputs5.items():
            cases[f"k5 {name} k={ANY_K}"] = (
                index_any_k(ix, label, *p, m, ANY_K),
                KNN.knn_index_launch_plain(*p, m, k=ANY_K))
        for name, (got, want) in cases.items():
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            equal[f"{label} any_k vs plain, {name}"] = ok
            failed += [] if ok else [f"{label} any_k {name}"]
    torch.cuda.synchronize()
    any_k_order = list(any_k) + list(any_k)[::-1]
    for label in any_k_order:
        t = any_k[label]
        co = libs[label]["knn_coords"][0]
        li = libs[label]["knn_lines"][0]
        ix = libs[label]["knn_index"][0]
        for kk in any_ks:
            t.setdefault(f"k3 k={kk}", []).append(CS.cuda_ms(
                lambda: coords_any_k(co, label, *prep, kk),
                2 if kk > 100 else 20))
        t.setdefault(f"k4 k={ANY_K}", []).append(CS.cuda_ms(
            lambda: coords_any_k(co, label, *prep_b, ANY_K), 20))
        t.setdefault(f"k5 k={ANY_K}", []).append(CS.cuda_ms(
            lambda: index_any_k(ix, label, *prep5, m5, ANY_K), 20))
        t.setdefault(f"k6 k={ANY_K}", []).append(CS.cuda_ms(
            lambda: lines_any_k(li, label, *prep_l, gates, ANY_K), 20))
    any_k_shapes = {label: {f"k={kk}": any_k_shape(
        libs[label]["knn_coords"][0], prep[2].shape[-1], kk)
        for kk in any_ks} for label in any_k}
    per_tile = {name: p[2].sum(-1).float() for name, p in inputs.items()}
    per_tile["bench_k5"] = prep5[2].sum(-1).float()
    res = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "shipped_splits": shipped, "reps": REPS, "turns": order,
           "ms": times,
           "ms_mean": {label: {k: float(np.mean(v)) for k, v in t.items()}
                       for label, t in times.items()},
           "flagged_pairs": {n: int(t.sum()) for n, t in per_tile.items()},
           "flagged_tiles_per_query_tile_max":
               {n: int(t.max()) for n, t in per_tile.items()},
           "flagged_tiles_per_query_tile_mean":
               {n: float(t.mean()) for n, t in per_tile.items()},
           "any_k_turns": any_k_order, "any_k_ms": any_k,
           "any_k_ms_mean": {label: {k: float(np.mean(v))
                                     for k, v in t.items()}
                             for label, t in any_k.items()},
           "any_k_shape": any_k_shapes,
           "ptxas": {label: {n: u for n, (_, u) in v.items()}
                     for label, v in libs.items()},
           "torch_equal": equal, "failed": failed}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
