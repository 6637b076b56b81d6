"""The stem kernels' weight packing and the tolerance they are held to.

``ops/conv2_pool.py:pack_conv2_weights_bf16`` lays conv1_2's HWIO kernel
out as the kernels' B operand ([tap, c_out, c_in] bf16).  The kernels sum
the exact bf16 x bf16 products on the tensor cores in wgmma's order, the
plain versions in a fixed (dy, dx, c) order, and ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py`` hold the two within 1e-5 of the
output's largest magnitude.  Here the plain versions are held to that
bound against a float64 evaluation of the same products, which no f32
order of sums can beat by much: the bound is sound for f32
reassociation.  On CPU tensors the wrappers take the plain versions.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wssdl_bus_tpu_torch.ops.conv1 import bf16_round, vgg_stem_plain
from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
from wssdl_bus_tpu_torch.ops.conv2_pool import (pack_conv2_weights_bf16,
                                                vgg_conv2_pool_plain)
from wssdl_bus_tpu_torch.ops.conv2_pool_cuda import vgg_conv2_pool

REL_TOL = 1e-5


def _bf16(a: np.ndarray) -> np.ndarray:
    return bf16_round(torch.from_numpy(a)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_is_the_tap_cout_cin_rearrangement(seed):
    w2 = np.random.RandomState(seed).randn(3, 3, 64, 64).astype(np.float32)
    got = pack_conv2_weights_bf16(torch.from_numpy(w2))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (9, 64, 64)
    want = np.ascontiguousarray(_bf16(w2).reshape(9, 64, 64)
                                .transpose(0, 2, 1))
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and back: tap (dy, dx), c_out, c_in -> HWIO
    back = got.float().numpy().transpose(0, 2, 1).reshape(3, 3, 64, 64)
    np.testing.assert_array_equal(back, _bf16(w2))


def _conv3x3_f64(a, w, b):
    """relu(SAME 3x3 conv + b) in float64, NHWC / HWIO in and out."""
    y = F.conv2d(torch.from_numpy(a).double().permute(0, 3, 1, 2),
                 torch.from_numpy(w).double().permute(3, 2, 0, 1),
                 padding=1) + torch.from_numpy(b).double()[:, None, None]
    return torch.relu(y).permute(0, 2, 3, 1)


def _pool_f64(y):
    bsz, h, w, c = y.shape
    return y.reshape(bsz, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4)).numpy()


def _assert_within_tol(got, want64):
    scale = np.abs(want64).max()
    assert scale > 0.1
    err = np.abs(got.astype(np.float64) - want64).max()
    assert err <= REL_TOL * scale, err / scale


@pytest.mark.parametrize("shape", [(1, 16, 32, 64), (2, 24, 48, 64),
                                   (1, 32, 32, 64)])
def test_tail_plain_within_tolerance_of_float64(shape):
    rng = np.random.RandomState(shape[1] + shape[2])
    a1 = _bf16(np.abs(rng.randn(*shape)).astype(np.float32))
    w2 = (rng.randn(3, 3, 64, 64) * 0.06).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    got = vgg_conv2_pool_plain(*(torch.from_numpy(t) for t in (a1, w2, b2)))
    want = _pool_f64(_conv3x3_f64(a1, _bf16(w2), b2))
    _assert_within_tol(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 32, 24, 3),
                                   (1, 16, 40, 3)])
def test_stem_plain_within_tolerance_of_float64(shape):
    """conv1_1 made exact (integer x, kernel and bias multiples of 1/8) so
    both sides round the same conv1_1 values to bf16; a random conv1_2."""
    rng = np.random.RandomState(shape[1] * shape[2])
    x = rng.randint(-4, 5, shape).astype(np.float32)
    w1 = (rng.randint(-8, 9, (3, 3, 3, 64)) / 8.0).astype(np.float32)
    b1 = (rng.randint(-8, 9, 64) / 8.0).astype(np.float32)
    w2 = (rng.randn(3, 3, 64, 64) * 0.06).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    got = vgg_stem_plain(*(torch.from_numpy(t) for t in (x, w1, b1, w2, b2)))
    a1 = _bf16(_conv3x3_f64(x, w1, b1).float().numpy())
    want = _pool_f64(_conv3x3_f64(a1, _bf16(w2), b2))
    _assert_within_tol(got.numpy(), want)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 16, 16, 3).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(3, 3, 3, 64) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(3, 3, 64, 64) * 0.05)
                          .astype(np.float32))
    a1 = torch.from_numpy(np.abs(rng.randn(1, 16, 32, 64))
                          .astype(np.float32)).to(torch.bfloat16)
    counts = (vgg_stem_fused.launches, vgg_conv2_pool.launches)
    assert torch.equal(vgg_stem_fused(x, w1, b, w2, b),
                       vgg_stem_plain(x, w1, b, w2, b))
    assert torch.equal(vgg_conv2_pool(a1, w2, b),
                       vgg_conv2_pool_plain(a1, w2, b))
    # no kernel ran: the counters count launches only
    assert (vgg_stem_fused.launches, vgg_conv2_pool.launches) == counts
