"""The port's apps, run as modules (nothing runs at import)::

    python -m liodom_tpu_torch.apps.run_synthetic [--device cpu]
    python -m liodom_tpu_torch.apps.run_kitti --root DIR --seq 00 [--mapping]
    python -m liodom_tpu_torch.apps.run_mapping --root DIR --poses FILE
    python -m liodom_tpu_torch.apps.run_ouster --synthetic

Each takes the JAX app's flags (``apps/*.py``; ``--aot`` excepted) plus
``--device``: CUDA unless ``--device cpu``, and without a card and that
flag it raises.  ``main(argv)`` prints the JAX app's lines and, last, one
JSON line of the run's report (frames, kernel build, first frame, scans/s,
host synchronisations between due points); ``run(argv)`` returns that
report.
"""
