"""The ResNet slice's layer primitives (``wssdl_bus_tpu_torch/models/
layers.py``: ``BatchRenorm``, ``GroupNormRef``, the strided ``SAME``
``ConvBlock`` with a norm, the 3x3/2 VALID max-pool) against the JAX
package's flax modules (``wssdl_bus_tpu/models/layers.py``) on the same
numpy inputs from a seed.

Tolerances: f32 reductions over a few hundred elements in another order,
so outputs and gradients agree to 1e-5 relative (2e-5 absolute on
unit-scale values); the running statistics are one fused multiply-add of
the batch moments, held to 1e-6.  Where the port must not touch state
(``running_stats_frozen``) the check is bit for bit."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wssdl_bus_tpu.models import layers as JL
from wssdl_bus_tpu_torch.models.layers import (BatchRenorm, ConvBlock,
                                               GroupNormRef, gn_groups,
                                               running_stats_frozen,
                                               same_pads)

RTOL, ATOL = 1e-5, 2e-5


def _nchw(a):
    """An NHWC numpy array as an NCHW channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _bn_case(seed, c=8):
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 5, 7, c) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(3, 5, 7, c).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = rng.uniform(0.5, 3.0, c).astype(np.float32)
    return x, g, gamma, beta, mean, var


def _port_bn(gamma, beta, mean, var):
    m = BatchRenorm(len(gamma))
    with torch.no_grad():
        for name, v in (("gamma", gamma), ("beta", beta), ("mean", mean),
                        ("var", var)):
            getattr(m, name).copy_(torch.from_numpy(v))
    return m


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_renorm_matches_flax(train):
    """Output, the updated running statistics (train) and the gradients of
    x, gamma and beta."""
    x, g, gamma, beta, mean, var = _bn_case(1)
    mod = JL.BatchRenorm(use_running_average=not train)
    variables = {"params": {"gamma": jnp.asarray(gamma),
                            "beta": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean),
                                 "var": jnp.asarray(var)}}

    def f(xx, gm, bt):
        v = {"params": {"gamma": gm, "beta": bt},
             "batch_stats": variables["batch_stats"]}
        if train:
            return mod.apply(v, xx, mutable=["batch_stats"])
        return mod.apply(v, xx), {}

    want, stats = f(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    _, vjp = jax.vjp(lambda *a: f(*a)[0], jnp.asarray(x),
                     jnp.asarray(gamma), jnp.asarray(beta))
    dx, dgamma, dbeta = vjp(jnp.asarray(g))

    m = _port_bn(gamma, beta, mean, var).train(train)
    xt = _nchw(x).requires_grad_(True)
    out = m(xt)
    out.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), RTOL, ATOL)
    np.testing.assert_allclose(m.gamma.grad.numpy(), np.asarray(dgamma),
                               RTOL, 1e-4)
    np.testing.assert_allclose(m.beta.grad.numpy(), np.asarray(dbeta),
                               RTOL, 1e-4)
    if train:
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(m, name).numpy(),
                np.asarray(stats["batch_stats"][name]), 1e-6, 1e-6)
            assert not np.allclose(getattr(m, name).numpy(),
                                   {"mean": mean, "var": var}[name])
    else:
        np.testing.assert_array_equal(m.mean.numpy(), mean)
        np.testing.assert_array_equal(m.var.numpy(), var)


def test_batch_renorm_frozen_stats_bit_for_bit():
    """Under ``running_stats_frozen`` a training forward normalises with
    the batch statistics, gives the same output and gradients as an
    updating forward, and leaves the running statistics bit for bit; the
    flag is restored after the block."""
    x, g, gamma, beta, mean, var = _bn_case(2)
    outs = []
    for frozen in (False, True):
        m = _port_bn(gamma, beta, mean, var).train()
        xt = _nchw(x).requires_grad_(True)
        if frozen:
            with running_stats_frozen(m):
                out = m(xt)
            assert m.update_stats
            np.testing.assert_array_equal(m.mean.numpy(), mean)
            np.testing.assert_array_equal(m.var.numpy(), var)
        else:
            out = m(xt)
            assert not np.array_equal(m.mean.numpy(), mean)
        out.backward(_nchw(g))
        outs.append((out.detach(), xt.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_batch_renorm_biased_var_and_momentum():
    """The running var takes the BIASED batch var with flax's momentum
    (ra = 0.99 ra + 0.01 batch), unlike nn.BatchNorm2d's unbiased var and
    its momentum=0.1 meaning."""
    x = _nchw(np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32))
    m = BatchRenorm(5).train()
    m(x)
    v = x.var(dim=(0, 2, 3), correction=0)
    mu = x.mean(dim=(0, 2, 3))
    torch.testing.assert_close(m.var, 0.99 + 0.01 * v, rtol=0, atol=1e-7)
    torch.testing.assert_close(m.mean, 0.01 * mu, rtol=0, atol=1e-7)


@pytest.mark.parametrize("c,num_groups,gn_params", [
    (32, 8, None),        # interleaved groups, the default heuristic
    (4, 8, None),         # C < G: G = C
    (48, None, (16, 2)),  # non-default GN_MIN_NUM_G / GN_MIN_CHS_PER_G
])
def test_group_norm_matches_flax(c, num_groups, gn_params):
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 5, 6, c) * 3.0 + 1.0).astype(np.float32)
    g = rng.randn(2, 5, 6, c).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    if gn_params is not None:
        with JL.gn_config_scope(*gn_params):
            num_groups = JL.gn_groups(c)
        assert num_groups == gn_groups(c, *gn_params) == 16
    mod = JL.GroupNormRef(num_groups)
    v = {"params": {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}}
    want, vjp = jax.vjp(lambda xx: mod.apply(v, xx), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))

    m = GroupNormRef(c, num_groups)
    with torch.no_grad():
        m.gamma.copy_(torch.from_numpy(gamma))
        m.beta.copy_(torch.from_numpy(beta))
    xt = _nchw(x).requires_grad_(True)
    out = m(xt)
    out.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), RTOL, ATOL)
    assert out.is_contiguous(memory_format=torch.channels_last)
    if m.groups > 1 and m.groups < c:
        # torch.nn.GroupNorm's contiguous groups give another answer
        ref = F.group_norm(xt.detach(), m.groups, m.gamma, m.beta, 1e-5)
        assert (ref - out).abs().max() > 1e-2


def test_gn_groups_matches_flax():
    for c in (3, 4, 16, 64, 256, 2048):
        for params in ((8, 4), (32, 16), (4, 1)):
            with JL.gn_config_scope(*params):
                assert JL.gn_groups(c) == gn_groups(c, *params), (c, params)


@pytest.mark.parametrize("hw", [(16, 20), (15, 17), (16, 17)])
@pytest.mark.parametrize("kernel", [7, 3, 1])
def test_strided_same_conv_matches_flax(hw, kernel):
    """stride 2, TF SAME: asymmetric where the input size asks for it."""
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, *hw, 5).astype(np.float32)
    w = rng.randn(kernel, kernel, 5, 6).astype(np.float32) * 0.2
    b = rng.randn(6).astype(np.float32)
    conv = fnn.Conv(6, (kernel, kernel), strides=(2, 2), padding="SAME")
    want = conv.apply({"params": {"kernel": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}}, jnp.asarray(x))
    m = ConvBlock(5, 6, kernel, stride=2, relu=False)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        m.conv.bias.copy_(torch.from_numpy(b))
    out = m(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert out.shape[2:] == tuple(-(-s // 2) for s in hw)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), RTOL, ATOL)


def test_same_pads_examples():
    assert same_pads(608, 7, 2) == (2, 3)     # conv0 on an even side
    assert same_pads(152, 3, 2) == (0, 1)     # 3x3/2 on an even side
    assert same_pads(19, 3, 2) == (1, 1)      # ... on an odd side
    assert same_pads(7, 1, 2) == (0, 0)       # convshortcut 1x1/2
    assert same_pads(7, 3, 2) == (1, 1)       # group3 on a 7x7 ROI


@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_conv_block_with_norm_matches_flax(norm):
    """conv 3x3/2 without a bias + the norm + ReLU, in training mode, on an
    odd-sized input: output, running statistics and the kernel gradient."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 13, 10, 16).astype(np.float32)
    g = rng.randn(2, 7, 5, 32).astype(np.float32)
    w = (rng.randn(3, 3, 16, 32) * 0.1).astype(np.float32)
    mod = JL.ConvBlock(32, 3, 2, norm=norm, train=True)
    sub = "bn" if norm == "BN" else "gn"
    params = {"conv": {"kernel": jnp.asarray(w)},
              sub: {"gamma": jnp.ones(32), "beta": jnp.zeros(32)}}
    stats = {"bn": {"mean": jnp.zeros(32), "var": jnp.ones(32)}}

    def f(p):
        v = {"params": p}
        if norm == "BN":
            v["batch_stats"] = stats
            return mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        return mod.apply(v, jnp.asarray(x)), {}

    want, new = f(params)
    _, vjp = jax.vjp(lambda p: f(p)[0], params)
    (dp,) = vjp(jnp.asarray(g))

    m = ConvBlock(16, 32, 3, stride=2, norm=norm).train()
    assert m.conv.bias is None
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    out = m(_nchw(x))
    out.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(
        m.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
        np.asarray(dp["conv"]["kernel"]), 1e-4, 1e-4)
    if norm == "BN":
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(m.bn, name).numpy(),
                np.asarray(new["batch_stats"]["bn"][name]), 1e-6, 1e-6)


@pytest.mark.parametrize("hw", [(16, 20), (15, 17)])
def test_max_pool_valid_matches_flax(hw):
    x = np.random.RandomState(0).randn(2, *hw, 4).astype(np.float32)
    want = JL.max_pool(jnp.asarray(x), 3, 2, "VALID")
    got = F.max_pool2d(_nchw(x), 3, 2)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_conv0_max_pool_unrounded_matches_flax():
    """conv0 (7x7/2 SAME, asymmetric pads on an even side, BatchRenorm in
    eval mode, ReLU) and the 3x3/2 max-pool after it, on an unrounded
    image-scale blob and He kernel: the f32 summation drift of conv0, which
    ``tests/test_torch_resnet_engine.py::test_train_steps_match_jax`` rounds
    away, reaches the pooled values as drift only (a max of values within
    the drift), held to 1e-5 of the pooled map's max.  Which cell wins a
    near-tied window is left unchecked: that follows each machine's
    rounding."""
    rng = np.random.RandomState(10)
    x = (rng.randn(2, 32, 44, 3) * 50.0 + 10.0).astype(np.float32)
    w = (rng.randn(7, 7, 3, 16) * np.sqrt(2.0 / 147)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.randn(16).astype(np.float32)
    mean = rng.randn(16).astype(np.float32) * 5.0
    var = rng.uniform(50.0, 400.0, 16).astype(np.float32)
    mod = JL.ConvBlock(16, 7, 2, norm="BN", train=False)
    want = mod.apply({"params": {"conv": {"kernel": jnp.asarray(w)},
                                 "bn": {"gamma": jnp.asarray(gamma),
                                        "beta": jnp.asarray(beta)}},
                      "batch_stats": {"bn": {"mean": jnp.asarray(mean),
                                             "var": jnp.asarray(var)}}},
                     jnp.asarray(x))
    want = np.asarray(JL.max_pool(want, 3, 2, "VALID"))
    m = ConvBlock(3, 16, 7, stride=2, norm="BN").eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        m.bn.load_state_dict({k: torch.from_numpy(v) for k, v in (
            ("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var))})
        got = _nhwc(F.max_pool2d(m(_nchw(x)), 3, 2))
    assert got.shape == want.shape == (2, 7, 10, 16) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
