"""The ResNet head's pool: the port's ``ops/roi_pool_cuda.py:
roi_pool_grouped`` on CPU tensors (its plain version,
``roi_pool_grouped_plain``: the plain forward and the plain backward under
autograd) against the JAX package's Pallas kernels run in interpret mode,
``roi_pool_image`` (``_fwd_kernel``, and ``_bwd_kernel`` as its VJP), at the
ResNet widths C = 256 (ResNet-18/34) and C = 1024 (ResNet-50/101: four of
the backward's 256-channel blocks) on small maps.

Both sides take each bin's max, route its cotangent to one cell by the same
rule and add in the same order, so values and dfeat must be identical:
ties included (a post-ReLU map of zeros, as ``relu(norm(group2))`` gives,
where the JAX package's CPU fallback, the jit ``roi_pool``, would split a
tie's gradient), and a NaN in one ROI's cotangent, which skips only that
ROI's 256-channel block (``_bwd_kernel``'s ``sum(|g|) > 0``).  The CUDA
kernel is held to the plain version on the card (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_image
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_grouped,
                                                   roi_pool_grouped_plain)

SCALE = 1.0 / 16.0


def _pallas(feats, rois, g):
    """Per image: roi_pool_image in interpret mode and its VJP at g."""
    outs, dfeats = [], []
    for f, r, gi in zip(feats, rois, g):
        out, vjp = jax.vjp(lambda x: roi_pool_image(x, jnp.asarray(r), 7, 7,
                                                    SCALE, True),
                           jnp.asarray(f))
        outs.append(np.asarray(out))
        dfeats.append(np.asarray(vjp(jnp.asarray(gi))[0]))
    return np.stack(outs), np.stack(dfeats)


def _port(feats, rois, g, fn=roi_pool_grouped):
    f = torch.from_numpy(feats).requires_grad_(True)
    out = fn(f, torch.from_numpy(rois), 7, 7, SCALE)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), f.grad.numpy()


def _case(c, relu=False, seed=0):
    rng = np.random.RandomState(seed + c)
    cases = [make_case(rng, h=9, w=11, c=c, p=9) for _ in range(2)]
    feats = np.stack([f for f, _ in cases])
    if relu:
        feats = np.maximum(feats, 0.0)
    rois = np.stack([r for _, r in cases])
    g = rng.randn(2, 9, 7, 7, c).astype(np.float32)
    return feats, rois, g


@pytest.mark.parametrize("c", [256, 1024])
@pytest.mark.parametrize("relu", [False, True], ids=["random", "relu_ties"])
def test_grouped_pool_matches_pallas(c, relu):
    feats, rois, g = _case(c, relu)
    want, dwant = _pallas(feats, rois, g)
    got, dgot = _port(feats, rois, g)
    assert got.shape == (2, 9, 7, 7, c)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dgot, dwant)
    if relu:
        assert (feats == 0).mean() > 0.4
        # each bin's cotangent on one cell: the zero ties of a window
        # receive nothing but that cell's share
        assert np.count_nonzero(dgot) <= np.count_nonzero(g)
    # the plain version, named, is the same function
    got_p, dgot_p = _port(feats, rois, g, roi_pool_grouped_plain)
    np.testing.assert_array_equal(got_p, got)
    np.testing.assert_array_equal(dgot_p, dgot)


def test_grouped_pool_nan_cotangent_skips_one_block():
    """C = 1024: a NaN in one ROI's cotangent at channel 300 (block 1 of 4)
    skips that ROI's block 1 only; the other three blocks and every other
    ROI route as usual."""
    feats, rois, g = _case(1024, seed=5)
    g[0, 3, 2, 4, 300] = np.nan
    _, dwant = _pallas(feats, rois, g)
    _, dgot = _port(feats, rois, g)
    np.testing.assert_array_equal(dgot, dwant)
    assert np.isfinite(dgot).all()
    clean = g.copy()
    clean[0, 3, :, :, 256:512] = 0.0
    _, dclean = _port(feats, rois, clean)
    np.testing.assert_array_equal(dgot, dclean)
