"""Build and load the hand-written CUDA kernels of ``liodom_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Nothing is compiled when this module is imported: a library is built the
first time a kernel is asked for on a CUDA tensor, or by :func:`build_all`,
which starts one ``nvcc`` per source in parallel.  Builds land in
``kernels/build/`` (git-ignored; ``runtime/cache.py`` may name another
directory before the first build), named by a hash of the source and the
flags (and of the shared headers ``csrc/*.cuh``), so an edited source is
rebuilt and an unchanged one is reused.

Every call into a library goes through here: :data:`ABI` holds each
source's entry points and their argument types, :func:`launch` runs an
entry point on a tensor's device and current stream, raises on the CUDA
error it reports and counts it by symbol (:func:`launch_counts`), and
:func:`query` reads a launch shape or layout, launching nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KNN_SHAPES = {"liodom_knn_walk_shape": [_I, _P],
               "liodom_knn_any_k_shape": [_I, _I, _P]}
# The C interface of each source: its entry points and their argument types
# (pointers as c_void_p).  Every entry point returns the cudaError_t of its
# work as an int; a launch takes the stream last, a query (a launch shape or
# layout) an out array.
ABI: Dict[str, Dict[str, list]] = {
    "smoothness": {
        "liodom_smoothness": [_P] * 3 + [_I] * 2 + [_P],
        "liodom_smoothness_shape": [_P]},
    "select": {
        "liodom_select_edges": [_P] * 6 + [_I] * 5 + [_F] * 2 + [_P],
        "liodom_select_edges_global": [_P] * 7 + [_I] * 5 + [_F] * 2 + [_P],
        "liodom_select_shape": [_I] * 3 + [_P],
        "liodom_select_global_shape": [_I] * 3 + [_P]},
    "knn_coords": {
        "liodom_knn_coords_batched": [_P] * 6 + [_I] * 7 + [_P],
        "liodom_knn_coords_any_k": [_P] * 7 + [_I] * 7 + [_P],
        **_KNN_SHAPES},
    "knn_lines": {
        "liodom_knn_lines": [_P] * 7 + [_I] * 7 + [_F] * 3 + [_P],
        "liodom_knn_lines_any_k": [_P] * 8 + [_I] * 7 + [_F] * 3 + [_P],
        **_KNN_SHAPES},
    "knn_index": {
        "liodom_knn_index": [_P] * 6 + [_I] * 8 + [_P],
        "liodom_knn_index_any_k": [_P] * 7 + [_I] * 8 + [_P],
        **_KNN_SHAPES},
    "lm_solve": {
        "liodom_lm_solve": [_P] * 5 + [ctypes.c_longlong, _P] + [_I] * 3
        + [_F] * 7 + [_P] * 3,
        "liodom_lm_solve_shape": [_I, _P]},
    "local_map_compact": {
        "liodom_local_map_compact": [_P] * 5 + [_I] * 3 + [_P] * 5,
        "liodom_local_map_compact_global": [_P] * 5 + [_I] * 3 + [_P] * 5,
        "liodom_local_map_compact_shape": [_I, _I, _P],
        "liodom_local_map_fence": [_I, _P]},
    "probe_insert": {
        "liodom_probe_insert": [_P, _I, _P, _P, _I, _I] + [_P] * 6,
        "liodom_probe_insert_shape": [_P]},
    "map_fold": {
        "liodom_map_fold": [_P] * 8 + [_I] * 2 + [_F] * 4 + [_P] * 6,
        "liodom_map_fold_shape": [_I, _P]},
}
SOURCES = tuple(ABI)
# the source of each entry point :func:`launch` is given (the kNN's two
# queries are in all three kNN sources: :func:`query` is given the source)
_SOURCE_OF = {symbol: name for name, table in ABI.items() for symbol in table}

# -fmad=false: the kernels round every product and sum as the plain PyTorch
# versions do (no fused multiply-add), which keeps them bit-exact with those.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_launches: Dict[str, int] = {}       # launch_counts' table
_count_lock = threading.Lock()
_started = False            # a build or a load has used BUILD_DIR
_scratch: Dict[tuple, object] = {}   # device_scratch's tensors
_retired: List[object] = []          # outgrown ones, kept alive


def set_build_dir(path) -> Path:
    """Make ``path`` the build directory if no library has been built or
    loaded yet; returns the build directory in use, created."""
    global BUILD_DIR
    with _lock:
        if path is not None and not _started:
            BUILD_DIR = Path(path).resolve()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return BUILD_DIR


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default install location; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of liodom_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: compiler log}`` (``ptxas`` register and shared-memory report)
    for the sources compiled by this call; raises if any compile fails."""
    global _started
    nvcc = nvcc_path()
    _started = True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name, nvcc)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, its entry
    points typed from :data:`ABI`."""
    global _started
    with _lock:
        _started = True
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name, nvcc_path())
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in ABI[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(symbol: str, device, *args) -> None:
    """Launch entry point ``symbol`` on ``device`` (a CUDA device) on its
    current stream: ``args``, then the stream.  Loads the library, raises
    if the entry point reports a CUDA error, and counts the launch under
    ``symbol`` (:func:`launch_counts`)."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{symbol}: no kernel for device {device}")
    fn = getattr(load(_SOURCE_OF[symbol]), symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, symbol)
    with _count_lock:
        _launches[symbol] = _launches.get(symbol, 0) + 1


def launch_counts() -> Dict[str, int]:
    """The launches since the last :func:`reset_launch_counts`, by entry
    symbol (a symbol never launched is absent)."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        _launches.clear()


def query(name: str, symbol: str, *args, size: int,
          ctype=ctypes.c_int) -> List[int]:
    """Entry point ``symbol`` of ``csrc/<name>.cu`` that launches nothing
    (a launch shape or layout): ``args``, then an out array of ``size``
    ``ctype``, returned as a list.  Builds the library if needed."""
    out = (ctype * size)()
    check(getattr(load(name), symbol)(*args, ctypes.addressof(out)), symbol)
    return list(out)


def require_cpu(t, what: str) -> None:
    """The plain versions serve CPU tensors only; any other non-CUDA device
    has no kernel and no plain route."""
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {t.device}")


def device_scratch(name: str, device, numel: int, dtype, floor: int = 0,
                   zeroed: bool = False):
    """Scratch ``name`` of a kernel on ``device``: one tensor of ``dtype``
    for each (name, device), at least ``numel`` elements (``floor`` at the
    least), grown when outgrown.  An outgrown tensor is kept alive, since a
    captured CUDA graph may still launch on its address.  ``zeroed``: made
    zero-filled, for a kernel that reads what its last launch left there;
    otherwise left unset, for one that writes before it reads.  Launches on
    one device must be ordered (one stream)."""
    import torch
    key = (name, torch.device(device))
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        if buf is not None:
            _retired.append(buf)
        make = torch.zeros if zeroed else torch.empty
        buf = make(max(numel, floor), dtype=dtype, device=device)
        _scratch[key] = buf
    return buf


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
