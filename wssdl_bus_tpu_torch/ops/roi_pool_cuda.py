"""ROI max-pool: the CUDA kernels of ``csrc/roi_pool.cu`` and their dispatch.

Port of the TPU kernels ``wssdl_bus_tpu/ops/roi_pool_pallas.py``
``_fc_fwd_kernel`` (wrappers ``roi_pool_fc_image`` / ``roi_pool_fc``, the VGG
path) and ``_fwd_kernel`` (``roi_pool_image`` / ``roi_pool_grouped``) in the
forward, and ``_bwd_kernel`` (the f32 VJP ``_fc_vjp_bwd``) in the backward.
One forward kernel serves both: its output [B, P, Ph, Pw, C] is contiguous
NHWC, so the flat fc6 operand [B, P, Ph*Pw*C] is a view of the same bytes.

:func:`roi_pool_fc` is differentiable with respect to ``feat``: for CUDA
tensors a ``torch.autograd.Function`` whose forward launches the forward
kernel and whose backward launches :func:`roi_pool_fc_backward`'s kernel,
saving only (feat, rois), never the pooled output.  For CPU tensors it is
:func:`roi_pool_fc_plain`, the same function with the plain forward
(``ops/roi_pool.py:roi_pool``) and the plain backward
(``ops/roi_pool.py:roi_pool_grad``).  Neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.roi_pool import (roi_pool, roi_pool_grad,
                                              rois_with_batch_index)

_FLAVORS = {"gpu": 0, "cpu": 1}


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    lib = _build.load("roi_pool")
    fwd = lib.wssdl_roi_pool_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    bwd = lib.wssdl_roi_pool_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
    return fwd, bwd


def _plain_forward(feat, rois, pooled_h, pooled_w, spatial_scale, flavor):
    b, p, _ = rois.shape
    out = roi_pool(feat, rois_with_batch_index(rois), pooled_h, pooled_w,
                   spatial_scale, flavor)
    return out.reshape(b, p, pooled_h * pooled_w * feat.shape[-1])


class _RoiPoolFc(torch.autograd.Function):
    """The pool with its backward: the kernels, or with ``plain`` the plain
    versions.  Saves (feat, rois) only, never the pooled output."""

    @staticmethod
    def forward(ctx, feat, rois, pooled_h, pooled_w, spatial_scale, flavor,
                plain):
        ctx.save_for_backward(feat, rois)
        ctx.args = (pooled_h, pooled_w, spatial_scale, flavor)
        ctx.plain = plain
        fwd = _plain_forward if plain else _launch_forward
        return fwd(feat, rois, *ctx.args)

    @staticmethod
    def backward(ctx, grad):
        feat, rois = ctx.saved_tensors
        if ctx.plain:
            dfeat = roi_pool_grad(feat, rois, grad, *ctx.args)
        else:
            dfeat = roi_pool_fc_backward(feat, rois, grad.contiguous(),
                                         *ctx.args)
        return dfeat, None, None, None, None, None, None


def roi_pool_fc_plain(feat: torch.Tensor, rois: torch.Tensor,
                      pooled_h: int = 7, pooled_w: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      flavor: str = "gpu") -> torch.Tensor:
    """The plain version of :func:`roi_pool_fc`, on any device, with the
    plain backward (``ops/roi_pool.py:roi_pool_grad``) under autograd."""
    return _RoiPoolFc.apply(feat, rois, pooled_h, pooled_w, spatial_scale,
                            flavor, True)


def _check_cuda(feat, rois, flavor):
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


def _launch_forward(feat, rois, pooled_h, pooled_w, spatial_scale, flavor):
    b, h, w, c = feat.shape
    p = rois.shape[1]
    out = torch.empty((b, p, pooled_h * pooled_w * c), dtype=torch.float32,
                      device=feat.device)
    if b == 0 or p == 0:
        return out
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[0](feat.data_ptr(), rois.data_ptr(), b, h, w, c, p,
                        pooled_h, pooled_w, float(spatial_scale),
                        _FLAVORS[flavor], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: cudaError {err}")
    roi_pool_fc.launches += 1
    return out


def roi_pool_fc(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int = 7,
                pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                flavor: str = "gpu") -> torch.Tensor:
    """Batched ROI max pooling written as the flat fc6 operand,
    differentiable with respect to ``feat``.

    Args:
      feat: [B, H, W, C] f32 NHWC, contiguous, C % 4 == 0 on CUDA.
      rois: [B, P, 4] f32 (x1, y1, x2, y2) in input-image coordinates; ROI
        p of image b pools against feat[b].
    Returns [B, P, Ph*Pw*C] f32 in NHWC (ph, pw, c) flatten order.
    """
    if feat.device.type == "cpu" and rois.device.type == "cpu":
        return roi_pool_fc_plain(feat, rois, pooled_h, pooled_w,
                                 spatial_scale, flavor)
    _check_cuda(feat, rois, flavor)
    return _RoiPoolFc.apply(feat, rois, pooled_h, pooled_w, spatial_scale,
                            flavor, False)


roi_pool_fc.launches = 0


def roi_pool_fc_backward(feat: torch.Tensor, rois: torch.Tensor,
                         grad: torch.Tensor, pooled_h: int = 7,
                         pooled_w: int = 7, spatial_scale: float = 1.0 / 16.0,
                         flavor: str = "gpu") -> torch.Tensor:
    """dfeat [B, H, W, C] of :func:`roi_pool_fc` for the cotangent ``grad``
    [B, P, Ph*Pw*C] (or its [B, P, Ph, Pw, C] view): the CUDA kernel for
    CUDA tensors, ``ops/roi_pool.py:roi_pool_grad`` for CPU tensors."""
    if all(t.device.type == "cpu" for t in (feat, rois, grad)):
        return roi_pool_grad(feat, rois, grad, pooled_h, pooled_w,
                             spatial_scale, flavor)
    _check_cuda(feat, rois, flavor)
    b, h, w, c = feat.shape
    p = rois.shape[1]
    if grad.device != feat.device or grad.dtype != torch.float32:
        raise TypeError(f"grad must be f32 on {feat.device}, got "
                        f"{grad.dtype} on {grad.device}")
    if grad.numel() != b * p * pooled_h * pooled_w * c \
            or grad.shape[:2] != (b, p):
        raise ValueError(f"grad {tuple(grad.shape)}: want [{b}, {p}, "
                         f"{pooled_h * pooled_w * c}]")
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        raise ValueError("grad must be contiguous and 16-byte aligned")
    if pooled_w > 32:
        raise ValueError(f"the backward kernel takes pooled_w <= 32, got "
                         f"{pooled_w}")
    dfeat = torch.empty_like(feat)
    active = torch.empty((max(b * p, 1),), dtype=torch.int32,
                         device=feat.device)
    if b == 0:
        return dfeat
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[1](feat.data_ptr(), rois.data_ptr(), grad.data_ptr(), b,
                        h, w, c, p, pooled_h, pooled_w, float(spatial_scale),
                        _FLAVORS[flavor], active.data_ptr(), dfeat.data_ptr(),
                        stream)
    if err != 0:
        raise RuntimeError(f"roi_pool backward kernel launch failed: "
                           f"cudaError {err}")
    roi_pool_fc_backward.launches += 1
    return dfeat


roi_pool_fc_backward.launches = 0


def roi_pool_grouped(feat: torch.Tensor, rois: torch.Tensor,
                     pooled_h: int = 7, pooled_w: int = 7,
                     spatial_scale: float = 1.0 / 16.0,
                     flavor: str = "gpu") -> torch.Tensor:
    """[B, H, W, C] x [B, P, 4] -> [B, P, Ph, Pw, C]: :func:`roi_pool_fc`'s
    output viewed 5-D (the same bytes; its launch counts there)."""
    b, p, _ = rois.shape
    return roi_pool_fc(feat, rois, pooled_h, pooled_w, spatial_scale,
                       flavor).view(b, p, pooled_h, pooled_w, feat.shape[-1])
