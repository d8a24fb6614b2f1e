"""liodom_tpu_torch — the PyTorch / CUDA port of liodom_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout
(``core/``, ``ops/``, ``odometry/``).  It imports torch and numpy only.  The
per-frame entry point is :func:`liodom_tpu_torch.odometry.pipeline.image_step`;
its kernels (smoothness, edge selection, kNN) are CUDA C++ under ``csrc/``,
built for ``sm_90a`` at first use by :mod:`liodom_tpu_torch.kernels`.  Entry
points run on CUDA unless the caller passes ``device="cpu"``, which takes
the kernels' plain PyTorch versions.
"""
