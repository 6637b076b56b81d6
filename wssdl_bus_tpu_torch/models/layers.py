"""Layer primitives of the VGG detector (counterparts of
``wssdl_bus_tpu/models/layers.py:160-236``: ``ConvBlock``, ``Fc``,
``max_pool``), and flax's ``nn.Dropout`` as the head uses it.

Modules run NCHW tensors (in ``torch.channels_last`` memory on the card, the
layout cuDNN prefers); ``Fc`` flattens a 4-D input in NHWC (h, w, c) order,
the JAX package's fc6 row order.  Normalisation layers and the bf16 compute
scope arrive with the ResNet and mixed-precision slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """conv + bias (+ ReLU), the reference's ``conv`` op without a norm.
    ``padding="SAME"`` at stride 1 pads (k-1)/2 on every side; "VALID" pads
    nothing."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 padding: str = "SAME", relu: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.conv = nn.Conv2d(in_ch, features, kernel,
                              padding=(kernel - 1) // 2 if padding == "SAME"
                              else 0)
        self.relu = relu

    def forward(self, x):
        y = self.conv(x)
        return F.relu(y) if self.relu else y


class Fc(nn.Module):
    """Dense layer (+ ReLU).  A 4-D input must arrive NHWC and is flattened
    in (h, w, c) order, like the JAX package's ``Fc``."""

    def __init__(self, in_features: int, features: int, relu: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.relu = relu

    def forward(self, x):
        if x.ndim == 4:
            x = x.reshape(x.shape[0], -1)
        y = self.dense(x)
        return F.relu(y) if self.relu else y


def max_pool(x, k: int = 2, s: int = 2):
    """k x k max pool at stride s, VALID (floor) like ``nn.max_pool(...,
    padding="VALID")``; NCHW input."""
    return F.max_pool2d(x, k, s)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` semantics: in training, ``where(keep, x / p, 0)``
    with keep probability p = 1 - rate; the identity in eval mode.

    ``keep`` (a bool tensor of x's shape) injects the mask, as the tests do
    with the JAX package's draws; otherwise it is drawn as ``uniform < p``
    from ``generator`` on x's device."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.keep_prob = 1.0 - rate

    def forward(self, x, keep=None, generator=None):
        if not self.training:
            return x
        if keep is None:
            keep = torch.rand(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype) < self.keep_prob
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))
