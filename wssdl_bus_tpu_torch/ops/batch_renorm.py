"""Training-mode BatchRenorm (+ ReLU): the plain PyTorch version of the
CUDA kernels in ``csrc/batch_renorm.cu`` (``ops/batch_renorm_cuda.py``
dispatches).  The same arithmetic in PyTorch ops, on any device: the CPU
takes it, and the tests on the card hold the kernels against it.

The forward folds the batch statistics and the running ones into six
per-channel vectors (``VECS``) and writes ``y = (x - mean) * a + c`` (+
ReLU); the backward takes ``x``, the cotangent and those vectors alone,
recomputes the ReLU's mask from ``x``, and gives ``dx``, ``dgamma`` and
``dbeta`` in closed form (r and d are constants to the gradient, mean and
sigma_b are not).  Tensors are NCHW, channels in dim 1.
"""

from __future__ import annotations

import torch

# the rows of the per-channel vectors, as csrc/batch_renorm.cu writes them
VECS = ("mean", "inv", "r", "d", "a", "c")


def _axes(x: torch.Tensor) -> tuple:
    return (0,) + tuple(range(2, x.ndim))


def _rows(vecs: torch.Tensor, ndim: int, *names):
    """The named rows of ``vecs``, each viewed to broadcast over dim 1."""
    shape = (1, -1) + (1,) * (ndim - 2)
    return tuple(vecs[VECS.index(n)].view(shape) for n in names)


def affine(x: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * a + c``: the output before the ReLU."""
    mean, a, c = _rows(vecs, x.ndim, "mean", "a", "c")
    return (x - mean) * a + c


def batch_renorm_forward_plain(x, gamma, beta, ra_mean, ra_var,
                               update: bool, momentum: float, eps: float,
                               relu: bool):
    """-> (y, vecs).  ``x`` f32 NCHW; the batch moments over every dim but
    1 (the var biased) and the running statistics ``ra_mean`` / ``ra_var``
    fold into the [6, C] ``vecs``: mean, ``1 / sigma_b``, r, d, ``a =
    gamma * r / sigma_b`` and ``c = beta + gamma * d``, with ``sigma_b =
    sqrt(var + eps)``, ``sigma_m = sqrt(ra_var + eps)``, ``r = sigma_b /
    sigma_m``, ``d = (mean - ra_mean) / sigma_m``.  Then, where ``update``
    holds, the running statistics are set in place to ``momentum * ra + (1
    - momentum) * batch``.  ``y`` is :func:`affine`, zero where it is <= 0
    when ``relu``."""
    axes = _axes(x)
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, correction=0)
    sigma_b = torch.sqrt(var + eps)
    sigma_m = torch.sqrt(ra_var + eps)
    r = sigma_b / sigma_m
    d = (mean - ra_mean) / sigma_m
    vecs = torch.stack([mean, 1.0 / sigma_b, r, d, gamma * r / sigma_b,
                        beta + gamma * d])
    if update:
        ra_mean.copy_(momentum * ra_mean + (1.0 - momentum) * mean)
        ra_var.copy_(momentum * ra_var + (1.0 - momentum) * var)
    y = affine(x, vecs)
    if relu:
        y = torch.where(y <= 0, 0.0, y)
    return y, vecs


def batch_renorm_backward_plain(x, dy, vecs, relu: bool):
    """-> (dx, dgamma, dbeta) of the forward that gave ``vecs`` on ``x``,
    for the cotangent ``dy``: with ``g`` = ``dy`` (zero where the
    recomputed :func:`affine` is <= 0 when ``relu``), ``xhat = (x - mean)
    * inv``, ``s1 = sum g``, ``s2 = sum g * xhat`` over every dim but 1:
    ``dbeta = s1``, ``dgamma = r * s2 + d * s1``, ``dx = a * ((g - s1 / M)
    - xhat * (s2 / M))``."""
    axes = _axes(x)
    if relu:
        dy = torch.where(affine(x, vecs) <= 0, 0.0, dy)
    mean, inv, a = _rows(vecs, x.ndim, "mean", "inv", "a")
    xhat = (x - mean) * inv
    s1 = dy.sum(dim=axes)
    s2 = (dy * xhat).sum(dim=axes)
    r, d = vecs[VECS.index("r")], vecs[VECS.index("d")]
    m = float(x.numel() // x.shape[1])
    shape = (1, -1) + (1,) * (x.ndim - 2)
    p, q = (s1 / m).view(shape), (s2 / m).view(shape)
    dx = a * ((dy - p) - xhat * q)
    return dx, r * s2 + d * s1, s1
