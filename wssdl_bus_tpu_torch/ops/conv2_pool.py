"""The VGG stem tail (conv1_2 -> ReLU -> 2x2/2 max-pool from a bf16 conv1_1
activation): conv1_1 as a library conv, the tail's shape and dispatch gates,
the library-conv reference, and the plain version of the CUDA kernel
``csrc/conv2_pool.cu`` (wrapper ``ops/conv2_pool_cuda.py:vgg_conv2_pool``).

Counterpart of ``wssdl_bus_tpu/ops/conv2_pool_pallas.py:102-161``.  Layouts
as in ``ops/conv1.py``: NHWC activations, HWIO kernels.

The tail's input is ``a1 = bf16(relu(conv1_1(x) + b1))``; conv1_1 stays a
library conv (cuDNN: TF32 by default, true f32 with TF32 off), as the JAX
package keeps it in XLA.  The kernel then computes ``relu(sum a1 *
bf16(w2) + b2)`` with SAME zeros and the 2x2/2 max-pool, f32 out, summing
the exact bf16 products on the tensor cores in wgmma's order; the plain
version sums them in the fixed order of ``ops/conv1.py``, so the two agree
to f32 reassociation (1e-5 of the output's largest magnitude) and bit for
bit on a dyadic grid, as the fused stem does.

The kernel reads conv1_2's kernel packed by :func:`pack_conv2_weights_bf16`
([tap, c_out, c_in] bf16: each tap's rows are the GEMM's K-major B
operand).  The JAX package's ``pack_conv2_weights`` (the pair-packed
128-lane weight blocks with structural zeros) is the TPU kernel's layout
for its matrix unit and is not carried over.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from wssdl_bus_tpu_torch.ops.conv1 import (_nchw_conv, bf16_round,
                                           conv3x3_taps, max_pool_2x2)

R = 8            # the JAX kernel's conv1_2 output rows per grid step

__all__ = ["R", "conv2_pool_shape_ok", "conv2_pool_ok", "vgg_conv1_1",
           "vgg_conv2_pool_reference", "vgg_conv2_pool_plain",
           "pack_conv2_weights_bf16"]


def conv2_pool_shape_ok(shape) -> bool:
    """[B, H, W, *] with H % 8 == 0, H >= 16, W % 16 == 0 and W >= 32 (the
    JAX package's predicate, ``conv2_pool_pallas.py:140-149``)."""
    if len(shape) != 4:
        return False
    h, w = shape[1], shape[2]
    return h % R == 0 and h >= 2 * R and w % 16 == 0 and w >= 32


def _device_ok(device) -> bool:
    return torch.device(device).type == "cuda"


def conv2_pool_ok(shape, device) -> bool:
    """Tail eligibility of an [B, H, W, *] image shape on ``device``: opted
    in with ``WSSDL_STEM_TAIL=1``, on a CUDA device, and
    :func:`conv2_pool_shape_ok`."""
    if os.environ.get("WSSDL_STEM_TAIL", "0") != "1":
        return False
    if not _device_ok(device):
        return False
    return conv2_pool_shape_ok(shape)


def vgg_conv1_1(x, w1, b1, out_dtype=torch.float32) -> torch.Tensor:
    """conv1_1 + bias + ReLU as a library conv, NHWC in and out, cast to
    ``out_dtype`` (contiguous)."""
    y = torch.relu(_nchw_conv(x, w1, b1)).to(out_dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def vgg_conv2_pool_reference(a1, w2, b2) -> torch.Tensor:
    """conv1_2 + bias + ReLU + 2x2/2 max-pool as library ops in f32; NHWC."""
    y = torch.relu(_nchw_conv(a1.float(), w2.float(), b2.float()))
    return F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1).contiguous()


def pack_conv2_weights_bf16(w2: torch.Tensor) -> torch.Tensor:
    """conv1_2's HWIO kernel [3, 3, 64, 64] -> [9, 64, 64] bf16, contiguous:
    tap (dy * 3 + dx), output channel, input channel; the B operand of both
    stem kernels (``csrc/vgg_stem.cuh``), each tap a K-major 64 x 64 tile."""
    kh, kw, ci, co = w2.shape
    return w2.reshape(kh * kw, ci, co).transpose(1, 2) \
        .to(torch.bfloat16).contiguous()


def vgg_conv2_pool_plain(a1, w2, b2) -> torch.Tensor:
    """The plain version of the tail kernel, on any device: a1 [B, H, W, 64]
    (bf16, or f32 rounded to bf16 first) -> [B, H/2, W/2, 64] f32, with the
    kernel's roundings, summing in the fixed (dy, dx, c) order (the
    kernel's tensor cores reassociate: module docstring)."""
    y = conv3x3_taps(bf16_round(a1.float()), bf16_round(w2.float()),
                     b2.float())
    return max_pool_2x2(y)
