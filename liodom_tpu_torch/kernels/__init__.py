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
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("smoothness", "select", "knn_coords", "knn_lines", "knn_index",
           "lm_solve", "local_map_compact", "probe_insert", "map_fold")

# -fmad=false: the kernels round every product and sum as the plain PyTorch
# versions do (no fused multiply-add), which keeps them bit-exact with those.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
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


def load(name: str, signatures: Iterable[tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.

    ``signatures``: ``(symbol, argtypes)`` pairs; every entry point returns
    the ``cudaError_t`` of its launch as an int."""
    global _started
    with _lock:
        _started = True
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name, nvcc_path())
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in signatures:
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


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
