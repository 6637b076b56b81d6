"""Seeded weights, made on the device in one draw.

Every convolution kernel is He's normal (standard deviation sqrt(2 /
fan-in)), the last convolution of each residual branch scaled by one over
the square root of the number of residual blocks (Fixup's rule, Zhang et
al. 2019): BatchRenorm is the identity at its initial running statistics,
so without the scale each block would double the residual stream's
variance.  The RPN's and the head's output layers keep the detector's own
initialisation (standard deviation 0.01, the box regressor 0.001).  Every
kernel is cut at two standard deviations; biases and shifts are 0, scales
1, running means 0 and running variances 1.  The kernels are one
``torch.rand`` of all their elements on a generator of the device, in
sorted-name order, mapped through the normal's inverse distribution.
"""

from __future__ import annotations

import math

import torch

_CONST = {"bias": 0.0, "beta": 0.0, "gamma": 1.0, "mean": 0.0, "var": 1.0}
_OUTPUT_STD = {"trunk.rpn_cls_score.": 0.01, "trunk.rpn_bbox_pred.": 0.01,
               "head.cls_score.": 0.01, "head.bbox_pred.": 0.001}


def kernel_std(name: str, shape, blocks: int) -> float:
    for prefix, std in _OUTPUT_STD.items():
        if name.startswith(prefix):
            return std
    std = math.sqrt(2.0 / math.prod(shape[1:]))
    if name.endswith(".conv3.conv.weight"):
        std /= math.sqrt(blocks)
    return std


def make_weights(spec, seed: int, device) -> dict:
    """{name: tensor} for ``spec`` [(name, shape)], f32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = sorted((n, s) for n, s in spec if n.endswith(".weight"))
    blocks = sum(1 for n, _ in kernels if n.endswith(".conv3.conv.weight"))
    total = sum(math.prod(s) for _, s in kernels)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0))
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    z = z.clamp(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        out[name] = (z[at:at + n] * kernel_std(name, shape, blocks)) \
            .reshape(shape)
        at += n
    for name, shape in spec:
        if name not in out:
            out[name] = torch.full(shape, _CONST[name.rsplit(".", 1)[-1]],
                                   dtype=torch.float32, device=device)
    return out
