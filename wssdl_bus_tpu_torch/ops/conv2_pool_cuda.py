"""The VGG stem tail: the CUDA kernel ``csrc/conv2_pool.cu`` and its
dispatch.

Port of the TPU kernel ``wssdl_bus_tpu/ops/conv2_pool_pallas.py:
_tail_kernel`` (wrapper ``vgg_conv2_pool``).  :func:`vgg_conv2_pool`
launches the kernel for CUDA tensors and takes the plain version
(``ops/conv2_pool.py:vgg_conv2_pool_plain``) for CPU tensors; it never
falls back from one to the other.  The kernel fetches a1's halo tiles
with TMA (a tensor map built per call) and sums on the tensor cores, so it
agrees with the plain version to f32 reassociation (``ops/conv2_pool.py``).
No backward, as for the fused stem.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wssdl_bus_tpu_torch.ops.conv1_cuda import check_weights
from wssdl_bus_tpu_torch.ops.conv2_pool import (R, conv2_pool_shape_ok,
                                                pack_conv2_weights_bf16,
                                                vgg_conv2_pool_plain)


@functools.lru_cache(maxsize=None)
def _lib():
    from wssdl_bus_tpu_torch.ops import _build

    fn = _build.load("conv2_pool").wssdl_vgg_conv2_pool
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def vgg_conv2_pool(a1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """Stem tail: a1 [B, H, W, 64] NHWC (bf16; another dtype is rounded to
    bf16 first, as in the JAX package) -> [B, H/2, W/2, 64] f32.

    ``conv2_pool_shape_ok(a1.shape)`` must hold (ValueError otherwise).  w2
    [3, 3, 64, 64] (HWIO) and b2 [64]: conv1_2's parameters.  One kernel
    launch per call."""
    if not conv2_pool_shape_ok(tuple(a1.shape)) or a1.shape[-1] != 64:
        raise ValueError(
            f"vgg_conv2_pool: input shape {tuple(a1.shape)} fails the "
            f"chunking preconditions (need [B, H, W, 64] with H % {R} == 0,"
            f" H >= {2 * R}, W % 16 == 0, W >= 32) - gate call sites on "
            "conv2_pool_ok()")
    if a1.device.type == "cpu":
        return vgg_conv2_pool_plain(a1, w2, b2)
    if a1.device.type != "cuda":
        raise ValueError(f"vgg_conv2_pool: a1 on {a1.device}; want a CUDA "
                         "device or the CPU")
    a1 = a1.to(torch.bfloat16).contiguous()
    b, h, w, _ = a1.shape
    check_weights(a1.device, w2=(w2, (3, 3, 64, 64)), b2=(b2, (64,)))
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.float32,
                      device=a1.device)
    with torch.cuda.device(a1.device):
        wpk = pack_conv2_weights_bf16(w2)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(a1.data_ptr(), wpk.data_ptr(), b2.data_ptr(), b, h, w,
                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stem tail kernel launch failed: cudaError {err}")
    vgg_conv2_pool.launches += 1
    return out


vgg_conv2_pool.launches = 0
