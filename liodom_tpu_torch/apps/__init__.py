"""The port's apps, run as modules (nothing runs at import but making the
kernels' library directory, ``runtime/cache.py``)::

    python -m liodom_tpu_torch.apps.run_synthetic [--device cpu]
    python -m liodom_tpu_torch.apps.run_kitti --root DIR --seq 00 [--mapping]
        [--aot]
    python -m liodom_tpu_torch.apps.run_mapping --root DIR --poses FILE
    python -m liodom_tpu_torch.apps.run_ouster --synthetic [--aot]
    python -m liodom_tpu_torch.apps.run_stream --frames 100 --rate 10
    python -m liodom_tpu_torch.apps.run_longcourse --frames 1000

Each takes the JAX app's flags (``apps/*.py``) plus ``--device``: CUDA
unless ``--device cpu``, and without a card and that flag it raises.
``--aot`` captures the step as a CUDA graph before frame 0
(``runtime/aot.py``).  ``main(argv)`` prints the JAX app's lines and, last,
one JSON line of the run's report (frames, kernel build, first frame,
scans/s, host synchronisations between due points); ``run(argv)`` returns
that report.
"""
