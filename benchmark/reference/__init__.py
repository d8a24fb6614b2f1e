"""The benchmark's plain reference of one frame of LiODOM.

Plain NumPy (the ring split, on the host) and plain PyTorch (the rest, on
any device), written from the reference's semantics and the port's plain
CPU paths, and importing nothing of the port: the split
(``feature_extractor.cc:104-179``), the smoothness stencil (:195-232), the
greedy edge selection (:256-313), the exact 5-NN and line test
(``laser_odometry.cc:318-357``), the Huber LM solve (:196-228), the
sliding window (:24-69) and the hash-grid map's semantics (``map.cc``):
a VoxelGrid of 0.4 m leaves inside 30/35 m cells, and the neighbourhood
of cells around a pose.

Every matrix product goes through :func:`linalg.mm`, which takes the
precision of the run: ``float32``, or ``tf32``, the control (operands
rounded to TF32's 10-bit mantissa before a float32 product, as the tensor
cores do).
"""
