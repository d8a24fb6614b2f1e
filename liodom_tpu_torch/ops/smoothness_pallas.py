"""K1, the 11-tap smoothness stencil: CUDA kernel wrapper + plain version.

Port of ``liodom_tpu/ops/smoothness_pallas.py``.  Per point j of each ring,
``smooth[j] = || sum_{l=-5..5} p[j+l] - 11 p[j] ||^2`` over the interior
``j in [5, count-5)``, 0 elsewhere (feature_extractor.cc:195-232).

:func:`smoothness_kernel` dispatches on the tensor's device: a CUDA tensor
launches ``csrc/smoothness.cu``; a CPU tensor takes :func:`smoothness_plain`.
The two are bit-exact (same tap order, every operation rounded on its own).
"""

from __future__ import annotations

import ctypes

import torch

from liodom_tpu_torch import kernels

_SIG = [("liodom_smoothness", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
         + [ctypes.c_void_p])]


def smoothness_plain(xyz: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """xyz (R, W, 3), count (R,) -> smoothness (R, W); plain PyTorch.

    Tap order of the TPU kernel: ``acc = -11 p`` then ``acc += p[j+l]`` for
    l = -5..5, then ``ax*ax + ay*ay + az*az`` left to right.  The roll's
    wrap-around only reaches non-interior columns, which are masked."""
    w = xyz.shape[1]
    acc = -11.0 * xyz
    for l in range(-5, 6):
        acc = acc + torch.roll(xyz, -l, dims=1)
    s = (acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1]
         + acc[..., 2] * acc[..., 2])
    cols = torch.arange(w, dtype=torch.int32, device=xyz.device)
    interior = (cols[None, :] >= 5) & (cols[None, :] < count[:, None] - 5)
    return torch.where(interior, s, torch.zeros((), dtype=s.dtype,
                                                device=s.device))


def smoothness_cuda(xyz: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors: xyz (R, W, 3) f32, count (R,) i32."""
    if not (xyz.is_cuda and count.device == xyz.device):
        raise ValueError("smoothness_cuda needs both tensors on one CUDA "
                         "device")
    if xyz.dtype != torch.float32 or count.dtype != torch.int32:
        raise TypeError(f"smoothness_cuda takes float32 xyz and int32 count, "
                        f"got {xyz.dtype} and {count.dtype}")
    if xyz.ndim != 3 or xyz.shape[2] != 3 or count.shape != xyz.shape[:1]:
        raise ValueError(f"smoothness_cuda shapes: xyz {tuple(xyz.shape)}, "
                         f"count {tuple(count.shape)}")
    if not (xyz.is_contiguous() and count.is_contiguous()):
        raise ValueError("smoothness_cuda needs contiguous tensors")
    r, w = xyz.shape[0], xyz.shape[1]
    out = torch.empty((r, w), dtype=torch.float32, device=xyz.device)
    lib = kernels.load("smoothness", _SIG)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_smoothness(xyz.data_ptr(), count.data_ptr(),
                                    out.data_ptr(), r, w, stream)
    kernels.check(err, "liodom_smoothness")
    smoothness_cuda.launches += 1
    return out


smoothness_cuda.launches = 0


def smoothness_kernel(xyz: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """K1 on the tensor's device: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if xyz.is_cuda:
        return smoothness_cuda(xyz, count)
    kernels.require_cpu(xyz, "smoothness")
    return smoothness_plain(xyz, count)
