"""ROI max-pool forward: the CUDA kernel ``csrc/roi_pool.cu`` and its dispatch.

Port of the TPU kernels ``wssdl_bus_tpu/ops/roi_pool_pallas.py``
``_fc_fwd_kernel`` (wrappers ``roi_pool_fc_image`` / ``roi_pool_fc``, the VGG
serving path) and ``_fwd_kernel`` (``roi_pool_image`` / ``roi_pool_grouped``).
One kernel serves both: its output [B, P, Ph, Pw, C] is contiguous NHWC, so
the flat fc6 operand [B, P, Ph*Pw*C] is a view of the same bytes.

:func:`roi_pool_fc` launches the kernel for CUDA tensors and takes the plain
version (``ops/roi_pool.py:roi_pool``) for CPU tensors; it never falls back
from one to the other.  The backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool, rois_with_batch_index

_FLAVORS = {"gpu": 0, "cpu": 1}


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    fn = _build.load("roi_pool").wssdl_roi_pool_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def roi_pool_fc_plain(feat: torch.Tensor, rois: torch.Tensor,
                      pooled_h: int = 7, pooled_w: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      flavor: str = "gpu") -> torch.Tensor:
    """The plain version of :func:`roi_pool_fc`, on any device."""
    b, p, _ = rois.shape
    out = roi_pool(feat, rois_with_batch_index(rois), pooled_h, pooled_w,
                   spatial_scale, flavor)
    return out.reshape(b, p, pooled_h * pooled_w * feat.shape[-1])


def roi_pool_fc(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int = 7,
                pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                flavor: str = "gpu") -> torch.Tensor:
    """Batched ROI max pooling written as the flat fc6 operand.

    Args:
      feat: [B, H, W, C] f32 NHWC, contiguous, C % 4 == 0 on CUDA.
      rois: [B, P, 4] f32 (x1, y1, x2, y2) in input-image coordinates; ROI
        p of image b pools against feat[b].
    Returns [B, P, Ph*Pw*C] f32 in NHWC (ph, pw, c) flatten order.
    """
    if feat.device.type == "cpu" and rois.device.type == "cpu":
        return roi_pool_fc_plain(feat, rois, pooled_h, pooled_w,
                                 spatial_scale, flavor)
    if feat.device.type != "cuda" or rois.device != feat.device:
        raise ValueError(f"roi_pool_fc: feat on {feat.device}, rois on "
                         f"{rois.device}; want both on one CUDA device or "
                         "both on the CPU")
    if feat.dtype != torch.float32 or rois.dtype != torch.float32:
        raise TypeError(f"roi_pool_fc takes f32 feat and rois, got "
                        f"{feat.dtype} / {rois.dtype}")
    if not (feat.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_pool_fc takes contiguous feat and rois")
    b, h, w, c = feat.shape
    if rois.ndim != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois {tuple(rois.shape)}: want [{b}, P, 4]")
    if c % 4 or feat.data_ptr() % 16:
        raise ValueError(f"roi_pool_fc needs C % 4 == 0 and a 16-byte "
                         f"aligned feat (C = {c})")
    if flavor not in _FLAVORS:
        raise ValueError(f"flavor must be 'gpu' or 'cpu', got {flavor!r}")
    p = rois.shape[1]
    out = torch.empty((b, p, pooled_h * pooled_w * c), dtype=torch.float32,
                      device=feat.device)
    if b == 0 or p == 0:
        return out
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(feat.data_ptr(), rois.data_ptr(), b, h, w, c, p,
                     pooled_h, pooled_w, float(spatial_scale),
                     _FLAVORS[flavor], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: cudaError {err}")
    roi_pool_fc.launches += 1
    return out


roi_pool_fc.launches = 0


def roi_pool_grouped(feat: torch.Tensor, rois: torch.Tensor,
                     pooled_h: int = 7, pooled_w: int = 7,
                     spatial_scale: float = 1.0 / 16.0,
                     flavor: str = "gpu") -> torch.Tensor:
    """[B, H, W, C] x [B, P, 4] -> [B, P, Ph, Pw, C]: :func:`roi_pool_fc`'s
    output viewed 5-D (the same bytes; its launch counts there)."""
    b, p, _ = rois.shape
    return roi_pool_fc(feat, rois, pooled_h, pooled_w, spatial_scale,
                       flavor).view(b, p, pooled_h, pooled_w, feat.shape[-1])
