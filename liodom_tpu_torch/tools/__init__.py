"""The port's operational tools, run as modules (nothing runs at import)::

    python -m liodom_tpu_torch.tools.bench [--device cpu]
    python -m liodom_tpu_torch.tools.bench_stages [--device cpu] [--out FILE]
    python -m liodom_tpu_torch.tools.warm_cache [RING_WIDTH] [--dir DIR]
        [--device cpu]

``bench`` is the port of ``bench.py`` (the throughput rows, each eager and
as a CUDA graph, gated on pose parity), ``bench_stages`` the port of
``bench_stages.py`` (each stage of the frame timed alone, eager and as a
CUDA graph), ``warm_cache`` the port of ``scripts/warm_cache.py`` (the
deploy-time build of the kernels and the native loader, then the
production steps captured).  All run on the card unless ``--device cpu``,
and raise without one.
"""
