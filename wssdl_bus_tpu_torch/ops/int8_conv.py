"""The int8 convolution of int8 serving: its weight layout and its plain
PyTorch version.

The JAX package computes each quantized conv as XLA's s8 x s8 -> s32
``lax.conv_general_dilated(..., preferred_element_type=int32)``
(``wssdl_bus_tpu/models/quantize.py:_conv``, called by ``quant_trunk_apply``
and ``_ResnetInt8.conv``) followed by an f32 epilogue.  The port computes
the same function, ``y = [relu](float(acc) * scale[o] + bias[o])`` with
``acc = sum xq * wq`` over the taps and input channels, in one kernel
(``csrc/int8_conv.cu``, wrapper ``ops/int8_conv_cuda.py:int8_conv``);
PyTorch has no int8 convolution that returns the int32 accumulator.

Layouts: activations NHWC (``xq`` int8, the output f32), TF "SAME"
padding (``models/layers.py:same_pads``, asymmetric at stride 2).  The
kernel reads the weights repacked once, offline (:func:`pack_weight`): an
int8 HWIO kernel becomes ``[Cout, Kpad]``, row ``o`` holding the taps in
(dy, dx, ci) order, the order of the NHWC input's bytes under one tap, then
zeros up to ``Kpad``, a multiple of the kernel's K step ``K_STEP``.

The plain version (:func:`int8_conv_plain`) takes the accumulator as a
float64 convolution of the int8 values, a sum over the taps of float64
matrix products, which is exact in any order (every product is below 2^14
and every sum below 127^2 * 4608 < 2^27, far inside float64's 2^53), then
runs the epilogue as two roundings, a multiply and then an add, as the
kernel does (its epilogue uses round-to-nearest intrinsics): the kernel
equals it bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wssdl_bus_tpu_torch.models.layers import same_pads

K_STEP = 64      # csrc/int8_conv.cu: the K depth of one shared-memory tile


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """int8 HWIO [kh, kw, Cin, Cout] -> [Cout, Kpad] int8, contiguous: the
    taps of output channel ``o`` in (dy, dx, ci) order, zero-padded to a
    multiple of ``K_STEP``."""
    if w_hwio.dtype != torch.int8 or w_hwio.ndim != 4:
        raise TypeError(f"want an int8 HWIO kernel, got {w_hwio.dtype} "
                        f"{tuple(w_hwio.shape)}")
    kh, kw, cin, cout = w_hwio.shape
    k = kh * kw * cin
    kpad = -(-k // K_STEP) * K_STEP
    out = torch.zeros((cout, kpad), dtype=torch.int8, device=w_hwio.device)
    out[:, :k] = w_hwio.reshape(k, cout).t()
    return out


def unpack_weight(packed: torch.Tensor, kh: int, kw: int,
                  cin: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight`: -> int8 HWIO [kh, kw, Cin, Cout]."""
    k = kh * kw * cin
    return packed[:, :k].t().reshape(kh, kw, cin, packed.shape[0])


def conv_pads(h: int, w: int, kh: int, kw: int, stride: int):
    """TF "SAME" pads ((top, bottom), (left, right)) and the output size."""
    (t, b), (lf, rt) = same_pads(h, kh, stride), same_pads(w, kw, stride)
    return (t, b), (lf, rt), (-(-h // stride), -(-w // stride))


def int8_conv_acc_plain(xq: torch.Tensor, packed: torch.Tensor, kh: int,
                        kw: int, stride: int = 1) -> torch.Tensor:
    """The int32 accumulator [B, Ho, Wo, Cout] of the "SAME" conv of int8
    NHWC ``xq`` with the packed kernel, exact: a float64 sum over the taps
    of [B, Ho, Wo, Cin] x [Cin, Cout] matrix products."""
    b, h, w, cin = xq.shape
    (t, bt), (lf, rt), (ho, wo) = conv_pads(h, w, kh, kw, stride)
    wt = unpack_weight(packed, kh, kw, cin).to(torch.float64)
    x = F.pad(xq.to(torch.float64), (0, 0, lf, rt, t, bt))
    acc = torch.zeros((b, ho, wo, wt.shape[-1]), dtype=torch.float64,
                      device=xq.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += x[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride] @ wt[dy, dx]
    return acc.to(torch.int32)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """``[relu](float(acc) * scale + bias)``, per output channel (last
    dim), f32: two roundings, the JAX package's ``acc.astype(f32) * scale
    + bias``."""
    y = acc.to(torch.float32) * scale + bias
    return torch.relu(y) if relu else y


def int8_conv_plain(xq: torch.Tensor, packed: torch.Tensor, kh: int,
                    kw: int, scale: torch.Tensor, bias: torch.Tensor,
                    stride: int = 1, relu: bool = False) -> torch.Tensor:
    """The plain version of ``ops/int8_conv_cuda.py:int8_conv``: xq int8
    NHWC [B, H, W, Cin], ``packed`` from :func:`pack_weight`, scale / bias
    f32 [Cout] -> f32 NHWC [B, ceil(H/s), ceil(W/s), Cout]."""
    return epilogue(int8_conv_acc_plain(xq, packed, kh, kw, stride), scale,
                    bias, relu)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8, the JAX package's ``_quantize``: ``clip(round(x /
    scale), -127, 127)``, a true division (``scale`` a tensor on x's
    device: PyTorch multiplies by the reciprocal of a divisor given as a
    CPU scalar on the card) and round half to even."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
