"""The port's ROI max-pool (plain ``wssdl_bus_tpu_torch/ops/roi_pool.py`` and
the CPU dispatch of ``ops/roi_pool_cuda.py``) against the JAX package's
Pallas kernels in interpret mode, its jit ``roi_pool`` and the numpy oracle.
Max is exact, so values must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracles import roi_pool_oracle
from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from wssdl_bus_tpu.ops.roi_pool_pallas import (roi_pool_fc_image,
                                               roi_pool_image)
from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                   roi_pool_grouped)

SCALE = 1.0 / 16.0


def _rois5(rois, b=0):
    return np.concatenate([np.full((len(rois), 1), b, np.float32), rois], 1)


@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_fc_dispatch_matches_pallas(rng, flavor):
    feat, rois = make_case(rng, p=8)   # one ROI block: interpret mode is slow
    want = np.asarray(roi_pool_fc_image(jnp.asarray(feat), jnp.asarray(rois),
                                        7, 7, SCALE, True, flavor))
    before = roi_pool_fc.launches
    got = roi_pool_fc(torch.from_numpy(feat)[None],
                      torch.from_numpy(rois)[None], flavor=flavor)
    assert roi_pool_fc.launches == before
    assert got.shape == (1, len(rois), 7 * 7 * feat.shape[-1])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_grouped_matches_pallas_and_oracle(rng, flavor):
    feat, rois = make_case(rng)
    want = np.asarray(roi_pool_image(jnp.asarray(feat), jnp.asarray(rois),
                                     7, 7, SCALE, True, flavor))
    got = roi_pool_grouped(torch.from_numpy(feat)[None],
                           torch.from_numpy(rois)[None], flavor=flavor)
    np.testing.assert_array_equal(got[0].numpy(), want)
    oracle = roi_pool_oracle(feat[None], _rois5(rois), 7, 7, SCALE, flavor)
    np.testing.assert_array_equal(got[0].numpy(), oracle)


def test_cpu_flavor_has_empty_bins(rng):
    """Small ROIs under the truncated 'cpu' edges leave bins empty inside
    the ROI; those bins output exactly 0."""
    feat = rng.randn(12, 14, 8).astype(np.float32) + 10.0   # all positive
    rois = np.array([[16, 16, 16 * 4, 16 * 3], [32, 0, 32 + 16 * 2, 16 * 5],
                     [0, 0, 0, 0]], np.float32)
    got = roi_pool(torch.from_numpy(feat)[None],
                   torch.from_numpy(_rois5(rois)), flavor="cpu").numpy()
    oracle = roi_pool_oracle(feat[None], _rois5(rois), 7, 7, SCALE, "cpu")
    np.testing.assert_array_equal(got, oracle)
    assert (got == 0).all(axis=-1).any()


@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_rois_past_the_map_and_batches(rng, flavor):
    """ROIs that reach past the feature map (and start beyond it), over a
    two-image batch: clipped bins, and each ROI pools its own image."""
    feats = rng.randn(2, 10, 13, 12).astype(np.float32)
    rois = np.array([[100, 40, 400, 300], [-30, -20, 60, 50],
                     [250, 170, 260, 180], [0, 0, 207, 159]], np.float32)
    rois5 = np.concatenate([_rois5(rois, 0), _rois5(rois, 1)])
    got = roi_pool(torch.from_numpy(feats), torch.from_numpy(rois5),
                   flavor=flavor).numpy()
    want = np.asarray(jax_roi_pool(jnp.asarray(feats), jnp.asarray(rois5),
                                   7, 7, SCALE, flavor=flavor))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, roi_pool_oracle(feats, rois5, 7, 7, SCALE, flavor))
    grouped = roi_pool_grouped(torch.from_numpy(feats),
                               torch.from_numpy(np.stack([rois, rois])),
                               flavor=flavor).numpy()
    np.testing.assert_array_equal(grouped.reshape(got.shape), got)
