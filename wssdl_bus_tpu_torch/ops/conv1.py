"""The fused VGG stem (conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2/2 max-pool):
its shape and dispatch gates, the library-conv reference, and the plain
version of the CUDA kernel ``csrc/conv1.cu`` (wrapper
``ops/conv1_cuda.py:vgg_stem_fused``).

Counterpart of ``wssdl_bus_tpu/ops/conv1_pallas.py:94-138``.  Tensors keep
the JAX package's layouts: images and activations NHWC, conv kernels HWIO
([3, 3, C_in, C_out]), biases [C_out].

Numerics of the kernel and of :func:`vgg_stem_plain`: x and both kernels
are rounded to bf16; conv1_1's output ``relu(sum + b1)`` is rounded to
bf16 too, and is 0 outside the image (the SAME zeros conv1_2 sees); every
tap product is a product of two bf16 values, exact in f32.  The plain
version sums each output's taps in one fixed order, ``(dy, dx, c)``
ascending from 0.0, then adds the bias, then takes the ReLU.  The kernel
computes conv1_1 in that same order with ``fmaf`` (with exact products
``acc + a*b`` equals ``fma(a, b, acc)``), so its bf16 conv1_1 tile is the
plain version's bit for bit; it sums conv1_2's products on the tensor
cores (wgmma), in the hardware's order.  Kernel and plain version
therefore agree to f32 reassociation, within 1e-5 of the output's largest
magnitude, and bit for bit where every partial sum is exact (a dyadic
grid: integer x, kernels and biases multiples of 1/8).  The Pallas kernel
sums the same products in the MXU's order: against it the port agrees to
f32 reassociation too (and exactly on the dyadic grid).

The gate is the JAX package's: opt-in with ``WSSDL_FUSED_STEM=1``, read at
call time, and the JAX package's chunking predicate :func:`stem_shape_ok`
letter for letter, so the same shapes take the stem in both packages (the
CUDA kernel itself needs no chunking).  The TPU-backend check becomes a
check that the input lies on a CUDA device.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

BH = 8          # the JAX kernel's conv1_2 output rows per grid step

__all__ = ["BH", "stem_shape_ok", "fused_stem_ok", "vgg_stem_reference",
           "vgg_stem_plain", "conv3x3_taps", "bf16_round"]


def stem_shape_ok(shape) -> bool:
    """[B, H, W, 3] with H % 16 == 0, W % 4 == 0, H >= 16 and W >= 16 (the
    JAX package's row/column chunking, ``conv1_pallas.py:118-126``)."""
    if len(shape) != 4 or shape[3] != 3:
        return False
    h, w = shape[1], shape[2]
    return h % (2 * BH) == 0 and w % 4 == 0 and h >= 2 * BH and w >= 16


def _device_ok(device) -> bool:
    return torch.device(device).type == "cuda"


def fused_stem_ok(shape, device) -> bool:
    """Fused-stem eligibility of an [B, H, W, 3] input on ``device``: opted
    in with ``WSSDL_FUSED_STEM=1``, on a CUDA device, and
    :func:`stem_shape_ok`."""
    if os.environ.get("WSSDL_FUSED_STEM", "0") != "1":
        return False
    if not _device_ok(device):
        return False
    return stem_shape_ok(shape)


def _nchw_conv(x, w, b):
    """SAME 3x3 conv of NHWC ``x`` with HWIO ``w`` plus ``b``; NCHW out."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(),
                    padding=1) + b[:, None, None]


def vgg_stem_reference(x, w1, b1, w2, b2):
    """The stem as library ops in f32 (cuDNN on the card, where TF32 applies
    unless disabled): conv + bias + ReLU twice, 2x2/2 VALID max-pool.
    NHWC in and out."""
    a = torch.relu(_nchw_conv(x, w1, b1))
    a = torch.relu(_nchw_conv(a.permute(0, 2, 3, 1), w2, b2))
    return F.max_pool2d(a, 2, 2).permute(0, 2, 3, 1).contiguous()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even) and back to f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def conv3x3_taps(a: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """relu(SAME 3x3 conv + b) of NHWC ``a`` [B, H, W, Ci] (f32) with HWIO
    ``w`` [3, 3, Ci, Co] (f32), summing each output's taps in the kernels'
    order: (dy, dx, c) ascending from 0.0, one ``addcmul`` per tap, then the
    bias, then the ReLU.  [B, H, W, Co] f32."""
    bsz, h, wd, ci = a.shape
    co = w.shape[-1]
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((bsz, h, wd, co), dtype=torch.float32, device=a.device)
    for dy in range(3):
        for dx in range(3):
            view = ap[:, dy:dy + h, dx:dx + wd]
            for c in range(ci):
                acc.addcmul_(view[..., c:c + 1], w[dy, dx, c])
    return torch.relu(acc + b)


def max_pool_2x2(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of NHWC ``y`` with even H and W."""
    bsz, h, w, c = y.shape
    return y.reshape(bsz, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def vgg_stem_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The plain version of the fused-stem kernel, on any device: x
    [B, H, W, 3] -> [B, H/2, W/2, 64] f32, with the kernel's roundings and
    the fixed order of sums (module docstring), the f32 reference the
    kernel is held to.  Slow: 27 + 576 accumulate passes over
    the full-resolution activation; never a yardstick of speed."""
    a1 = bf16_round(conv3x3_taps(bf16_round(x.float()), bf16_round(w1.float()),
                                 b1.float()))
    y = conv3x3_taps(a1, bf16_round(w2.float()), b2.float())
    return max_pool_2x2(y)
