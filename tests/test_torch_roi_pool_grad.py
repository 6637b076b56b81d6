"""The port's ROI-pool backward, ``ops/roi_pool.py:roi_pool_grad`` (the plain
version of the CUDA kernel ``wssdl_roi_pool_bwd``) and the CPU autograd path of
``ops/roi_pool_cuda.py:roi_pool_fc``, against the VJP of the JAX package's
Pallas kernels run in interpret mode, as ``tests/test_roi_pool_pallas.py``
runs them: ``roi_pool_image`` (``_bwd_kernel``) and the flat
``roi_pool_fc_image`` whose f32 VJP unflattens the cotangent into the same
kernel.

Both sides route each bin's cotangent to one cell by the same rule and add
in the same order, so dfeat must be identical, ties included (where the
jit ``roi_pool`` fallback's autograd would split them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.roi_pool_pallas import (roi_pool_fc_image,
                                               roi_pool_image)
from wssdl_bus_tpu_torch.ops.roi_pool import active_rows, roi_pool_grad
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                   roi_pool_fc_backward,
                                                   roi_pool_fc_plain)

SCALE = 1.0 / 16.0


def _pallas_dfeat(feat, rois, g, flavor="gpu"):
    """VJP of roi_pool_image (interpret mode) at cotangent g [P, 7, 7, C]."""
    _, vjp = jax.vjp(lambda f: roi_pool_image(f, jnp.asarray(rois), 7, 7,
                                              SCALE, True, flavor),
                     jnp.asarray(feat))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _port_dfeat(feat, rois, g, flavor="gpu"):
    return roi_pool_grad(torch.from_numpy(feat)[None],
                         torch.from_numpy(rois)[None],
                         torch.from_numpy(g)[None], 7, 7, SCALE,
                         flavor)[0].numpy()


@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_grad_matches_pallas(rng, flavor):
    """Random map, 13 ROIs (two Pallas ROI blocks) incl. a 1x1-forced one,
    a dense random cotangent."""
    feat, rois = make_case(rng)
    g = rng.randn(len(rois), 7, 7, feat.shape[-1]).astype(np.float32)
    want = _pallas_dfeat(feat, rois, g, flavor)
    got = _port_dfeat(feat, rois, g, flavor)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() > 100


def test_grad_ties_go_to_one_cell():
    """A constant map: every bin's whole cotangent lands on one cell (the
    first column, then first row, of its window), so with a cotangent of
    ones dfeat holds only whole numbers summing to 49 per channel."""
    feat = np.zeros((16, 16, 4), np.float32)
    rois = np.array([[0.0, 0.0, 16 * 7 - 1, 16 * 7 - 1]], np.float32)
    g = np.ones((1, 7, 7, 4), np.float32)
    want = _pallas_dfeat(feat, rois, g)
    got = _port_dfeat(feat, rois, g)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 49 * 4
    assert set(np.unique(got).tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


def test_grad_skips_zero_cotangent_rois(rng):
    """40 overlapping ROIs of which two carry cotangents (the MIL pattern):
    the other 38 are skipped and the result still matches."""
    feat, rois = make_case(rng, p=40)
    g = np.zeros((40, 7, 7, feat.shape[-1]), np.float32)
    g[3] = rng.randn(7, 7, feat.shape[-1])
    g[17] = 2.0
    act = active_rows(torch.from_numpy(g)[None])
    assert act[0].nonzero().flatten().tolist() == [3, 17]
    np.testing.assert_array_equal(_port_dfeat(feat, rois, g),
                                  _pallas_dfeat(feat, rois, g))


def test_flat_cotangent_and_autograd_match_pallas_fc(rng):
    """The flat [B, P, 49*C] cotangent, as fc6's input gradient arrives:
    ``roi_pool_fc`` on CPU tensors runs the plain forward and, under
    autograd, ``roi_pool_grad``.  Image 0 against the Pallas fc kernel's
    VJP, image 1 (half its rows zero) against ``roi_pool_image``'s, fed
    the same cotangent unflattened (interpret mode is slow)."""
    feats, roiss = zip(*(make_case(rng, p=8) for _ in range(2)))
    feat = np.stack(feats)
    rois = np.stack(roiss)
    d = 49 * feat.shape[-1]
    g = rng.randn(2, 8, d).astype(np.float32)
    g[1, ::2] = 0.0                     # skipped rows in the second image
    _, vjp = jax.vjp(lambda f: roi_pool_fc_image(
        f, jnp.asarray(rois[0]), 7, 7, SCALE, True, "gpu"),
        jnp.asarray(feat[0]))
    want = np.stack([np.asarray(vjp(jnp.asarray(g[0]))[0]),
                     _pallas_dfeat(feat[1], rois[1],
                                   g[1].reshape(8, 7, 7, -1))])

    tf = torch.from_numpy(feat).requires_grad_(True)
    out = roi_pool_fc(tf, torch.from_numpy(rois))
    assert out.shape == (2, 8, d)
    # autograd keeps the inputs for the backward, never the pooled output
    assert [t.shape for t in out.grad_fn.saved_tensors] == \
        [tf.shape, rois.shape]
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tf.grad.numpy(), want)
    direct = roi_pool_fc_backward(torch.from_numpy(feat),
                                  torch.from_numpy(rois), torch.from_numpy(g))
    np.testing.assert_array_equal(direct.numpy(), want)
    # the plain wrapper is the same function on any device
    tf.grad = None
    roi_pool_fc_plain(tf, torch.from_numpy(rois)).backward(
        torch.from_numpy(g))
    np.testing.assert_array_equal(tf.grad.numpy(), want)


def test_grad_differs_from_amax_autograd_only_on_ties():
    """``amax``'s own autograd (the plain forward's) splits a tie evenly;
    the port's backward puts it on the first cell, as the kernel does."""
    feat = np.zeros((4, 4, 4), np.float32)
    feat[1, 1] = feat[1, 2] = 5.0       # a tie inside one bin
    rois = np.array([[16.0, 16.0, 47.0, 31.0]], np.float32)   # cells 1..2
    g = np.ones((1, 7, 7, 4), np.float32)
    got = _port_dfeat(feat, rois, g)
    np.testing.assert_array_equal(got, _pallas_dfeat(feat, rois, g))
    assert set(np.unique(got).tolist()) <= set(range(50))
