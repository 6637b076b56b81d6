"""The fused VGG stem: the CUDA kernel ``csrc/conv1.cu`` and its dispatch.

Port of the TPU kernel ``wssdl_bus_tpu/ops/conv1_pallas.py:_stem_kernel``
(wrapper ``vgg_stem_fused``).  :func:`vgg_stem_fused` launches the kernel
for CUDA tensors and takes the plain version (``ops/conv1.py:
vgg_stem_plain``) for CPU tensors; it never falls back from one to the
other.  The kernel runs conv1_2 on the tensor cores (wgmma), so it agrees
with the plain version to f32 reassociation, not bit for bit
(``ops/conv1.py``); it reads conv1_2's kernel packed to bf16 by
``ops/conv2_pool.py:pack_conv2_weights_bf16``.  Neither has a backward:
callers run it under ``torch.no_grad()`` with a frozen stem
(``models/detector.py:FasterRCNN.apply_trunk``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.conv1 import BH, stem_shape_ok, vgg_stem_plain
from wssdl_bus_tpu_torch.ops.conv2_pool import pack_conv2_weights_bf16


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    fn = _build.load("conv1").wssdl_vgg_stem_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def check_weights(device, **named):
    """Each named tensor must be f32, contiguous, on ``device`` and of its
    given shape: ``name=(tensor, shape)``."""
    for name, (t, shape) in named.items():
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32 on {device}, got {t.dtype} "
                            f"on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)}: want a contiguous "
                             f"{shape}")


def vgg_stem_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused stem: x [B, H, W, 3] f32 NHWC -> [B, H/2, W/2, 64] f32.

    ``stem_shape_ok(x.shape)`` must hold (ValueError otherwise, as in the
    JAX package).  w1 [3, 3, 3, 64], w2 [3, 3, 64, 64] (HWIO), b1, b2 [64]:
    conv1_1's and conv1_2's parameters.  One kernel launch per call."""
    if not stem_shape_ok(tuple(x.shape)):
        raise ValueError(
            f"vgg_stem_fused: input shape {tuple(x.shape)} fails the "
            f"chunking preconditions (need [B, H, W, 3] with H % {2 * BH} "
            "== 0, W % 4 == 0, W >= 16) - gate call sites on "
            "fused_stem_ok()")
    if x.device.type == "cpu":
        return vgg_stem_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"vgg_stem_fused: x on {x.device}; want a CUDA "
                         "device or the CPU")
    b, h, w, _ = x.shape
    check_weights(x.device, x=(x, (b, h, w, 3)), w1=(w1, (3, 3, 3, 64)),
                  b1=(b1, (64,)), w2=(w2, (3, 3, 64, 64)), b2=(b2, (64,)))
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        wpk = pack_conv2_weights_bf16(w2)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     wpk.data_ptr(), b2.data_ptr(), b, h, w, out.data_ptr(),
                     stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: cudaError {err}")
    vgg_stem_fused.launches += 1
    return out


vgg_stem_fused.launches = 0
