"""Where the kernels' libraries persist (port of ``runtime/cache.py``).

The JAX package's cold start is an XLA compile per (shape, config), which
its persistent compilation cache makes a once-per-machine cost.  The port's
is the ``nvcc`` build of each kernel source (``kernels/__init__.py``); the
libraries are named by a hash of their source and flags and kept, so a
warm directory serves the first frame without a compile.  Every app calls
:func:`enable_persistent_cache` when it is imported, as the JAX apps do.

There is no ``off``: the kernels must be built to run at all.
"""

from __future__ import annotations

from typing import Optional

from liodom_tpu_torch import kernels


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Make (and return) the directory the kernels are built into and
    loaded from: ``path``, or ``kernels/build/`` (git-ignored) by default.
    Idempotent; a ``path`` takes effect only before the first build or
    load, and a call without one keeps the directory in use."""
    return str(kernels.set_build_dir(path))
