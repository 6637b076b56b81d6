"""The int8 conv of int8 serving (``ops/int8_conv.py``, the plain version
of the kernel ``csrc/int8_conv.cu``) against a numpy int64 oracle and
against the JAX package's s8 x s8 -> s32 conv
(``wssdl_bus_tpu/models/quantize.py:_conv(..., preferred_element_type=
int32)``), exactly, at every kernel / stride / padding kind the int8
trunks run: 3x3 stride 1, 3x3 stride 2 and 7x7 stride 2 with TF-SAME's
asymmetric pads on even and odd sides, 1x1 stride 1 and 2, Cin = 3 (K =
27 and 147, padded to the kernel's K step) and +-127 extremes.  The
epilogue and the quantize step are held against the JAX package's bit for
bit (power-of-two grids for the epilogue, so the JAX side's own rounding
is exact; ties at .5 for the quantize step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.models.quantize import _conv as jax_conv
from wssdl_bus_tpu.models.quantize import _quantize as jax_quantize
from wssdl_bus_tpu_torch.ops.int8_conv import (K_STEP, epilogue,
                                               int8_conv_acc_plain,
                                               int8_conv_plain, pack_weight,
                                               quantize, unpack_weight)
from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv

# (kernel, stride, Cin, Cout, H, W): every kind the int8 trunks run
CASES = [
    (3, 1, 16, 64, 9, 11),     # VGG16 / ResNet 3x3 SAME
    (3, 1, 3, 64, 8, 10),      # conv1_1: Cin = 3, K = 27
    (3, 2, 32, 64, 10, 12),    # 3x3/2, even sides: pads 0 / 1
    (3, 2, 32, 64, 7, 9),      # 3x3/2, odd sides: pads 1 / 1
    (7, 2, 3, 64, 16, 20),     # conv0, even sides: pads 2 / 3, K = 147
    (7, 2, 3, 64, 15, 13),     # conv0, odd sides: pads 3 / 3
    (1, 1, 64, 128, 5, 7),     # bottleneck 1x1
    (1, 2, 64, 128, 6, 7),     # 1x1/2 shortcut
]


def oracle(x, w, stride):
    """numpy int64 TF-SAME conv of NHWC x with HWIO w."""
    kh, kw, _, cout = w.shape
    b, h, wd, _ = x.shape
    ho, wo = -(-h // stride), -(-wd // stride)
    ph = max((ho - 1) * stride + kh - h, 0)
    pw = max((wo - 1) * stride + kw - wd, 0)
    xp = np.pad(x.astype(np.int64), ((0, 0), (ph // 2, ph - ph // 2),
                                     (pw // 2, pw - pw // 2), (0, 0)))
    out = np.zeros((b, ho, wo, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            win = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                     dx:dx + (wo - 1) * stride + 1:stride]
            out += np.einsum("bhwc,cd->bhwd", win, w[dy, dx].astype(np.int64))
    return out


def _case(k, ci, co, h, w, rng, extreme=False):
    if extreme:
        # +-127 with one sign per image and per output channel: interior
        # sums reach 127^2 * k^2 * Cin in magnitude
        x = np.empty((2, h, w, ci), np.int8)
        x[0], x[1] = 127, -127
        wt = np.broadcast_to(rng.choice(np.array([-127, 127], np.int8), co),
                             (k, k, ci, co)).copy()
    else:
        x = rng.randint(-127, 128, (2, h, w, ci)).astype(np.int8)
        wt = rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8)
    return x, wt


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("k,stride,ci,co,h,w", CASES)
def test_acc_exact_against_oracle_and_jax(k, stride, ci, co, h, w, extreme):
    rng = np.random.RandomState(k * 100 + stride * 10 + ci + extreme)
    x, wt = _case(k, ci, co, h, w, rng, extreme)
    packed = pack_weight(torch.from_numpy(wt))
    acc = int8_conv_acc_plain(torch.from_numpy(x), packed, k, k, stride)
    assert acc.dtype == torch.int32
    want = oracle(x, wt, stride)
    np.testing.assert_array_equal(acc.numpy(), want)
    jacc = jax_conv(jnp.asarray(x), jnp.asarray(wt), "SAME", stride=stride,
                    preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    if extreme:   # the largest sums of this K
        assert np.abs(want).max() == 127 * 127 * k * k * ci


@pytest.mark.parametrize("k,ci", [(3, 3), (7, 3), (3, 64), (1, 256)])
def test_pack_layout(k, ci):
    """[Cout, Kpad]: taps in (dy, dx, ci) order, zeros to a multiple of the
    kernel's K step; unpack inverts it."""
    rng = np.random.RandomState(k + ci)
    wt = rng.randint(-127, 128, (k, k, ci, 64)).astype(np.int8)
    packed = pack_weight(torch.from_numpy(wt))
    kk = k * k * ci
    assert packed.shape == (64, -(-kk // K_STEP) * K_STEP)
    assert packed.is_contiguous() and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed[:, :kk].numpy(),
                                  wt.reshape(kk, 64).T)
    assert not packed[:, kk:].any()
    np.testing.assert_array_equal(
        unpack_weight(packed, k, k, ci).numpy(), wt)


@pytest.mark.parametrize("relu", [False, True])
def test_epilogue_bitwise_against_jax_on_pow2_grids(relu):
    """float(acc) * scale + bias (+ ReLU) equals the JAX package's
    ``acc.astype(f32) * scale + bias`` bit for bit: scales and biases on
    power-of-two grids make every product and sum exact in f32, so the JAX
    side's own rounding (fused or not) cannot differ."""
    rng = np.random.RandomState(5)
    acc = rng.randint(-2 ** 20, 2 ** 20, (2, 3, 4, 64)).astype(np.int32)
    scale = (2.0 ** rng.randint(-12, -4, 64)).astype(np.float32)
    bias = (rng.randint(-64, 65, 64) * 2.0 ** -6).astype(np.float32)
    got = epilogue(torch.from_numpy(acc), torch.from_numpy(scale),
                   torch.from_numpy(bias), relu).numpy()
    y = jnp.asarray(acc).astype(jnp.float32) * scale + bias
    want = np.asarray(jnp.maximum(y, 0.0) if relu else y)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got != 0).any()


def test_quantize_bitwise_against_jax():
    """clip(round(x / scale)) in [-127, 127], round half to even, exactly
    the JAX package's ``_quantize``, ties and clipping included."""
    rng = np.random.RandomState(6)
    scale = np.float32(0.037)
    x = (rng.randn(4, 5, 6, 16) * 3).astype(np.float32)
    ties = (np.arange(-130, 131) + 0.5).astype(np.float32)  # k + .5 exact
    got = quantize(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_quantize(
        jnp.asarray(x), jnp.float32(scale))))
    got_t = quantize(torch.from_numpy(ties), torch.tensor(1.0)).numpy()
    np.testing.assert_array_equal(got_t, np.asarray(jax_quantize(
        jnp.asarray(ties), jnp.float32(1.0))))
    assert got_t.dtype == np.int8 and got_t.min() == -127 \
        and got_t.max() == 127
    assert (got_t[129:132] == [0, 0, 2]).all()    # -0.5, 0.5, 1.5 -> even


@pytest.mark.parametrize("k,stride,ci,co,h,w", CASES[:5])
def test_wrapper_takes_the_plain_version_on_the_cpu(k, stride, ci, co, h, w):
    """On CPU tensors ``int8_conv`` is the plain version and launches
    nothing; the full function holds against the oracle + epilogue."""
    rng = np.random.RandomState(9)
    x, wt = _case(k, ci, co, h, w, rng)
    scale = rng.uniform(1e-4, 1e-3, co).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    args = (torch.from_numpy(x), pack_weight(torch.from_numpy(wt)), k, k,
            torch.from_numpy(scale), torch.from_numpy(bias), stride, True)
    before = int8_conv.launches
    got = int8_conv(*args)
    assert int8_conv.launches == before
    np.testing.assert_array_equal(got.numpy(), int8_conv_plain(*args).numpy())
    want = np.maximum(oracle(x, wt, stride).astype(np.float32) * scale
                      + bias, 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
