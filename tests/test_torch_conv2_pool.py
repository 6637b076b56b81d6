"""The port's stem tail (``ops/conv2_pool.py``, ``ops/conv2_pool_cuda.py``:
on CPU tensors ``vgg_conv2_pool`` is the plain version of the CUDA kernel
``csrc/conv2_pool.cu``) against the JAX package's Pallas ``vgg_conv2_pool``
in interpret mode, its gates against the JAX gates, and conv1_1.

Tolerances, as for the fused stem (``tests/test_torch_stem.py``): the same
exact bf16 products summed in another order, so on random data within 1e-5
of the output's largest magnitude (measured at most 5.4e-7 at these four
shapes), and bit for bit where every partial sum is exact (a1 multiples of
1/8 in [0, 4], kernel and bias multiples of 1/8 in [-1, 1]).  The border
case pins the SAME zeros: an activation that is nonzero only on the image
border."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.ops.conv2_pool_pallas import \
    conv2_pool_shape_ok as jax_shape_ok
from wssdl_bus_tpu.ops.conv2_pool_pallas import vgg_conv1_1 as jax_conv1_1
from wssdl_bus_tpu.ops.conv2_pool_pallas import vgg_conv2_pool as jax_tail
from wssdl_bus_tpu_torch.ops.conv2_pool import (R, conv2_pool_ok,
                                                conv2_pool_shape_ok,
                                                vgg_conv1_1,
                                                vgg_conv2_pool_reference)
from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool

SHAPES = [
    (1, 16, 32, 64),   # minimum eligible H and W
    (3, 16, 48, 64),   # odd batch, minimal rows
    (2, 48, 64, 64),   # several JAX row chunks per image
    (1, 32, 80, 64),   # W % 16 == 0 but not a power of two
]
REL_TOL = 1e-5


def _weights(rng):
    w2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    return w2, b2


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _both(a1, w2, b2):
    want = np.asarray(jax_tail(jnp.asarray(a1).astype(jnp.bfloat16), w2, b2,
                               interpret=True))
    got = vgg_conv2_pool(torch.from_numpy(a1).to(torch.bfloat16),
                         torch.from_numpy(w2), torch.from_numpy(b2))
    return got.numpy(), want


@pytest.mark.parametrize("shape", SHAPES)
def test_tail_matches_pallas_random(shape, rng):
    w2, b2 = _weights(rng)
    a1 = np.abs(rng.randn(*shape)).astype(np.float32)
    got, want = _both(a1, w2, b2)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (shape[0], shape[1] // 2,
                                       shape[2] // 2, 64)
    scale = np.abs(want).max()
    assert scale > 0.5
    assert np.abs(got - want).max() <= REL_TOL * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_tail_bit_for_bit_on_dyadic_grid(shape, rng):
    a1 = (rng.randint(0, 33, shape) / 8.0).astype(np.float32)
    w2 = (rng.randint(-8, 9, (3, 3, 64, 64)) / 8.0).astype(np.float32)
    b2 = (rng.randint(-8, 9, 64) / 8.0).astype(np.float32)
    got, want = _both(a1, w2, b2)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).mean() > 0.3


def test_tail_border_zeros_exact(rng):
    """Only the image border is nonzero: every out-of-image tap must add
    exactly zero.  Against the Pallas kernel to f32 reassociation, and
    against the f32 library conv to f32 rounding (a1 and the kernel are
    bf16-exact here, so the bf16 roundings change nothing)."""
    w2, b2 = _weights(rng)
    w2 = _bf16(w2)
    a1 = np.zeros((1, 16, 32, 64), np.float32)
    border = np.abs(_bf16(rng.randn(16, 32, 64).astype(np.float32)))
    a1[0, 0, :], a1[0, -1, :] = border[0], border[-1]
    a1[0, :, 0], a1[0, :, -1] = border[:, 0], border[:, -1]
    got, want = _both(a1, w2, b2)
    ref = vgg_conv2_pool_reference(torch.from_numpy(a1), torch.from_numpy(w2),
                                   torch.from_numpy(b2)).numpy()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_conv1_1_matches_jax(rng):
    """conv1_1 + bias + ReLU as a library conv, stored in bf16: the tail's
    input, equal to the JAX package's up to f32 reassociation (the rare
    element whose f32 value straddles a bf16 rounding boundary moves by one
    bf16 ulp)."""
    x = rng.randn(2, 16, 32, 3).astype(np.float32)
    w1 = (rng.randn(3, 3, 3, 64) * 0.1).astype(np.float32)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv1_1(x, w1, b1, out_dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = vgg_conv1_1(*(torch.from_numpy(a) for a in (x, w1, b1)),
                      out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
    assert (got == want).mean() > 0.999


def test_tail_shape_gate():
    assert conv2_pool_shape_ok((4, 608, 800, 64))
    assert conv2_pool_shape_ok((1, 2 * R, 32, 64))
    assert not conv2_pool_shape_ok((1, 2 * R - 8, 32, 64))  # H too small
    assert not conv2_pool_shape_ok((1, 2 * R + 4, 32, 64))  # H % R != 0
    assert not conv2_pool_shape_ok((1, 32, 40, 64))         # W % 16 != 0
    assert not conv2_pool_shape_ok((1, 32, 16, 64))         # W too small
    assert not conv2_pool_shape_ok((32, 32, 64))            # not 4-D
    for h in range(0, 50, 2):
        for w in range(0, 70, 4):
            for shape in ((1, h, w, 64), (2, h, w, 3)):
                assert conv2_pool_shape_ok(shape) == jax_shape_ok(shape)


def test_tail_rejects_bad_shape(rng):
    w2, b2 = (torch.from_numpy(a) for a in _weights(rng))
    a1 = torch.from_numpy(rng.randn(1, 24, 40, 64).astype(np.float32))
    with pytest.raises(ValueError, match="chunking preconditions"):
        vgg_conv2_pool(a1, w2, b2)


def test_tail_gate_is_opt_in_and_cuda_only(monkeypatch):
    shape = (4, 608, 800, 3)      # the image shape, as apply_trunk asks
    monkeypatch.delenv("WSSDL_STEM_TAIL", raising=False)
    assert not conv2_pool_ok(shape, "cuda")
    monkeypatch.setenv("WSSDL_STEM_TAIL", "0")
    assert not conv2_pool_ok(shape, "cuda")
    monkeypatch.setenv("WSSDL_STEM_TAIL", "1")
    assert conv2_pool_ok(shape, torch.device("cuda"))
    assert not conv2_pool_ok(shape, "cpu")               # CUDA only
    assert not conv2_pool_ok((4, 608, 808, 3), "cuda")   # W % 16 != 0
