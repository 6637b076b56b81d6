"""Layer primitives (counterparts of ``wssdl_bus_tpu/models/layers.py``:
``BatchRenorm``, ``GroupNormRef``, ``gn_groups``, ``ConvBlock``, ``Fc``,
``max_pool``), and flax's ``nn.Dropout`` as the VGG head uses it.

Modules run NCHW tensors (in ``torch.channels_last`` memory on the card, the
layout cuDNN prefers); ``Fc`` flattens a 4-D input in NHWC (h, w, c) order,
the JAX package's fc6 row order.  The norms keep the JAX tree's names:
``BatchRenorm``'s affine parameters are ``gamma`` / ``beta`` and its running
statistics the buffers ``mean`` / ``var`` (``models/convert.py`` maps them
to the ``params`` and ``batch_stats`` collections).

Mixed precision (the JAX package's ``compute_dtype_scope``): a
``ConvBlock`` or ``Fc`` whose ``compute_dtype`` is set (bfloat16) casts its
input, kernel and bias to it and computes the conv / matmul and the bias
add there, with f32 parameters; the activation chain stays in that dtype
between convs, both norms cast their input to f32 first, and
``models/detector.py`` casts the trunk's and the head's outputs back to
f32.  The dtype is an attribute of each module, set once by
``models/detector.py:build_detector`` (:func:`set_compute_dtype`), not a
scope: PyTorch runs eagerly, and an attribute travels with the model into
every thread that runs it (the prefetch and evaluation threads) where a
thread-local scope would not.

Activation remat (``models/detector.py:FasterRCNN.remat``) runs each
residual block (each VGG16 conv stage, the VGG16 head) under
:func:`checkpoint`, ``torch.utils.checkpoint``'s non-reentrant form, which
recomputes the block's forward in the backward.
``BatchRenorm`` updates its running statistics in its training forward,
where the JAX package's checkpointed function returns them
(``wssdl_bus_tpu/models/detector.py:218-228``); so within a checkpoint the
first run records the statistics each norm read, and the recompute
normalises with those and updates nothing (``_RenormReplay``).  That scope
is thread-local: the recompute runs in the thread of the backward (on the
card, autograd's device thread), and each run enters it there.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from wssdl_bus_tpu_torch.ops.batch_renorm_cuda import batch_renorm_train
from wssdl_bus_tpu_torch.utils.logging import span


class BatchRenorm(nn.Module):
    """Batch normalization with renorm correction, as
    ``tf.layers.batch_normalization(training=..., renorm=True)`` with its
    defaults: momentum 0.99 in the flax sense (``ra = 0.99 * ra + 0.01 *
    batch``), epsilon 1e-3, r and d unclipped.

    In training mode the batch moments over every dimension but channels
    (dim 1) normalise ``x``; ``r = sigma_b / sigma_m`` and ``d = (mean -
    ra_mean) / sigma_m`` come from the running statistics before the update
    and carry no gradient; the running var takes the biased batch var.  The
    running statistics update in place unless :attr:`update_stats` is False
    (:func:`running_stats_frozen`), and never in the recompute of a
    :func:`checkpoint`, which reads the statistics its first run read.  The
    training forward and its backward, with the ReLU that follows when
    ``relu``, are ``ops/batch_renorm_cuda.py:batch_renorm_train`` (CUDA
    kernels on the card, their plain version on the CPU).  In eval mode
    the output is ``(x - ra_mean) * rsqrt(ra_var + eps) * gamma +
    beta``."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 epsilon: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.update_stats = True
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, relu: bool = False):
        """``relu``: a ReLU after the norm, in the training kernels' passes
        (``ops/batch_renorm_cuda.py:batch_renorm_train``)."""
        x = x.float()       # statistics in f32 under a bf16 compute dtype
        if not self.training:
            shape = (1, -1) + (1,) * (x.ndim - 2)
            inv = torch.rsqrt(self.var + self.epsilon)
            y = (x - self.mean.view(shape)) * inv.view(shape) \
                * self.gamma.view(shape) + self.beta.view(shape)
            return F.relu(y) if relu else y
        replay = getattr(_REMAT, "scope", None)
        ra_mean, ra_var, update = (
            (self.mean, self.var, self.update_stats) if replay is None
            else replay.running_stats(self))
        return batch_renorm_train(x, self.gamma, self.beta, ra_mean, ra_var,
                                  update, self.momentum, self.epsilon, relu)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Within the block, every ``BatchRenorm`` under ``module`` normalises
    training-mode inputs with their batch statistics but leaves its running
    statistics untouched: the alternating regime's weak step, whose batch
    statistics the JAX package discards (``train/engine.py:
    _train_step_mil_impl``; the reference runs its update ops only with the
    supervised step, train_bus.py:357-361 vs :391-394)."""
    norms = [m for m in module.modules() if isinstance(m, BatchRenorm)]
    prev = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, p in zip(norms, prev):
            m.update_stats = p


_REMAT = threading.local()      # .scope: the _RenormReplay run in this thread


class _RenormReplay:
    """One :func:`checkpoint` call's record of the running statistics each
    ``BatchRenorm`` read, in call order.  Its first run (the first scope of
    :meth:`contexts`) reads and updates the buffers as usual and saves a
    copy of what each norm read; each recompute (the second scope) reads
    the saved copies in the same order and updates nothing.  The
    recompute then computes r and d, and so every activation and gradient,
    exactly as the first run did; and a statistic updates once a step,
    whatever the backward recomputes (an early-stopped recompute reads a
    prefix of the record)."""

    def __init__(self):
        self.seen = []
        self.replaying = False
        self.pos = 0

    def contexts(self):
        """``checkpoint``'s ``context_fn``: the (first run, recompute)
        context managers."""
        return _ReplayScope(self, False), _ReplayScope(self, True)

    def running_stats(self, norm: "BatchRenorm"):
        """-> (running mean, running var, whether to update them) for
        ``norm``'s training forward within the checkpoint."""
        if not self.replaying:
            self.seen.append((norm, norm.mean.clone(), norm.var.clone()))
            return norm.mean, norm.var, norm.update_stats
        seen, mean, var = self.seen[self.pos]
        if seen is not norm:
            raise RuntimeError("checkpoint recompute reached the BatchRenorm "
                               "modules in another order than its forward")
        self.pos += 1
        return mean, var, False


class _ReplayScope:
    """Makes ``replay`` the scope of this thread, recording or replaying;
    may be entered again (a second backward recomputes again).  A
    recompute is the span ``recompute`` (``utils/logging.py:span``)."""

    def __init__(self, replay: _RenormReplay, replaying: bool):
        self.replay, self.replaying = replay, replaying
        self.prev = self.span = None

    def __enter__(self):
        self.prev = getattr(_REMAT, "scope", None)
        self.replay.replaying, self.replay.pos = self.replaying, 0
        _REMAT.scope = self.replay
        if self.replaying:
            self.span = span("recompute")
            self.span.__enter__()

    def __exit__(self, *exc):
        _REMAT.scope = self.prev
        if self.span is not None:
            self.span.__exit__(*exc)
            self.span = None


def checkpoint(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept: ``torch.utils.checkpoint`` in its
    non-reentrant form (the reentrant one returns no parameter gradients
    when no input requires one, as the trunk's image blob never does), with
    every ``BatchRenorm`` in ``fn`` replayed as :class:`_RenormReplay`
    describes.  ``fn`` draws no random numbers: the checkpoint neither
    saves nor restores any generator's state for its recompute
    (``preserve_rng_state=False``; the default form would restore only the
    default generators, never an explicit one), so the caller draws such
    masks first and passes them in (``models/vgg.py:VGGRCNNHead.forward``)."""
    replay = _RenormReplay()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=replay.contexts, **kwargs)


class GroupNormRef(nn.Module):
    """The reference's hand-rolled group norm (network.py:528-545): channel
    ``c`` belongs to group ``c % G`` (interleaved, which
    ``torch.nn.GroupNorm``'s contiguous groups are not), moments over the
    spatial dims and C // G per (image, group), eps 1e-5, affine [C]
    ``gamma`` / ``beta``.  ``G = min(num_groups, C)``.

    The split is taken on the NHWC view ``[B, H, W, C // G, G]``, which is
    free for a channels_last NCHW tensor."""

    def __init__(self, channels: int, num_groups: int,
                 epsilon: float = 1e-5):
        super().__init__()
        self.groups = min(num_groups, channels)
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, relu: bool = False):
        """``relu``: a ReLU after the norm."""
        x = x.float()       # statistics in f32 under a bf16 compute dtype
        c = x.shape[1]
        xh = x.movedim(1, -1)
        xg = xh.reshape(xh.shape[:-1] + (c // self.groups, self.groups))
        axes = tuple(range(1, xg.ndim - 1))
        mean = xg.mean(dim=axes, keepdim=True)
        var = xg.var(dim=axes, correction=0, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + self.epsilon)).reshape(xh.shape)
        y = (y * self.gamma + self.beta).movedim(-1, 1)
        return F.relu(y) if relu else y


def gn_groups(channels: int, min_num_g: int = 8, min_chs_per_g: int = 4
              ) -> int:
    """The reference's group count, ``min(GN_MIN_NUM_G, C //
    GN_MIN_CHS_PER_G)`` and at least 1 (network.py:126); the defaults are
    ``cfg.TRAIN.GN_MIN_NUM_G`` / ``GN_MIN_CHS_PER_G``'s."""
    return max(1, min(min_num_g, channels // min_chs_per_g))


def make_norm(norm, channels: int, gn_params=(8, 4)):
    """``BatchRenorm`` for "BN", ``GroupNormRef`` (``gn_groups`` of
    ``gn_params`` = (GN_MIN_NUM_G, GN_MIN_CHS_PER_G)) for "GN", None for
    no norm."""
    if norm == "BN":
        return BatchRenorm(channels)
    if norm == "GN":
        return GroupNormRef(channels, gn_groups(channels, *gn_params))
    if norm is not None:
        raise ValueError(f"norm must be 'BN', 'GN' or None, got {norm!r}")
    return None


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF / flax "SAME" padding of one spatial dim: (before, after), with
    ``out = ceil(size / stride)`` and the odd pixel after (a 7x7/2 conv on
    an even side pads 2 / 3, a 3x3/2 pads 0 / 1 on an even side and 1 / 1
    on an odd one)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """conv (+ norm) (+ ReLU), the reference's ``conv`` op
    (network.py:100-135).  With a norm ("BN": ``bn``, "GN": ``gn``) the conv
    has no bias.  ``padding="SAME"`` pads as TF does: at stride 1 (k-1)/2
    on every side, at a larger stride by :func:`same_pads` of the input's
    size at each call: an explicit ``F.pad`` where before and after differ,
    the conv's own padding where they agree (the head's 7x7 ROIs: a padded
    copy would be kept for the backward, +1.6 GiB in a ResNet-50 training
    step); "VALID" pads nothing."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 padding: str = "SAME", relu: bool = True, stride: int = 1,
                 norm=None, gn_params=(8, 4)):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.same = padding == "SAME"
        self.stride = stride
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=(kernel - 1) // 2
                              if self.same and stride == 1 else 0,
                              bias=norm is None)
        self.norm_name = {"BN": "bn", "GN": "gn"}.get(norm)
        nrm = make_norm(norm, features, gn_params)
        if nrm is not None:
            self.add_module(self.norm_name, nrm)
        self.relu = relu
        self.compute_dtype = None

    def forward(self, x, f32: bool = False):
        """``f32``: compute in f32 whatever ``compute_dtype`` (the int8
        path's RPN convs, ``models/quantize.py``)."""
        weight, bias = self.conv.weight, self.conv.bias
        dt = None if f32 else self.compute_dtype
        if dt is not None:
            # flax's Conv(dtype=dt): input, kernel and bias in dt, the bias
            # added after the conv in dt
            x, weight = x.to(dt), weight.to(dt)
        padding = self.conv.padding
        if self.same and self.stride > 1:
            k = self.conv.kernel_size[0]
            (t, b), (lf, rt) = (same_pads(s, k, self.stride)
                                for s in x.shape[2:])
            if (t, lf) == (b, rt):
                padding = (t, lf)
            else:
                x = F.pad(x, (lf, rt, t, b))
        if dt is None:
            y = F.conv2d(x, weight, bias, self.stride, padding)
        else:
            y = F.conv2d(x, weight, None, self.stride, padding)
            if bias is not None:
                y = y + bias.to(dt).view(1, -1, 1, 1)
        if self.norm_name is not None:
            return getattr(self, self.norm_name)(y, relu=self.relu)
        return F.relu(y) if self.relu else y


class Fc(nn.Module):
    """Dense layer (+ ReLU).  A 4-D input must arrive NHWC and is flattened
    in (h, w, c) order, like the JAX package's ``Fc``."""

    def __init__(self, in_features: int, features: int, relu: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.relu = relu
        self.compute_dtype = None

    def forward(self, x, f32: bool = False):
        """``f32``: compute in f32 whatever ``compute_dtype`` (the int8
        path's ResNet dense layers, ``models/quantize.py``)."""
        if x.ndim == 4:
            x = x.reshape(x.shape[0], -1)
        dt = None if f32 else self.compute_dtype
        if dt is None:
            y = self.dense(x)
        else:
            # flax's Dense(dtype=dt): the matmul and the bias add in dt
            y = F.linear(x.to(dt), self.dense.weight.to(dt)) \
                + self.dense.bias.to(dt)
        return F.relu(y) if self.relu else y


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype (None for f32, or ``torch.bfloat16``) of every
    ``ConvBlock`` and ``Fc`` under ``module``; -> ``module``."""
    if dtype is not None and dtype != torch.bfloat16:
        raise ValueError(f"compute dtype must be None or bfloat16, got "
                         f"{dtype}")
    for m in module.modules():
        if isinstance(m, (ConvBlock, Fc)):
            m.compute_dtype = dtype
    return module


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

    def draw(self, shape, generator=None, device=None):
        """A keep mask of ``shape`` drawn from ``generator``, as
        :meth:`forward` draws it (in f32 whatever x's dtype, as flax's
        bernoulli is)."""
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32) < self.keep_prob

    def forward(self, x, keep=None, generator=None):
        if not self.training:
            return x
        if keep is None:
            keep = self.draw(x.shape, generator, x.device)
        return torch.where(keep, x / self.keep_prob, torch.zeros_like(x))
