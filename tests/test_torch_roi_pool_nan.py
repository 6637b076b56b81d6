"""The port's ROI-pool backward under NaNs and infinities, against the
Pallas kernels in interpret mode: ``ops/roi_pool.py:roi_pool_grad`` against
``_bwd_kernel`` (through ``_bwd_call``, the f32 VJP's kernel) and
``roi_pool_grad_bf16`` against ``_fc_bwd_kernel`` (``_fc_bwd_call``, the
bf16 output's), on the same inputs.

What the kernels do there, and the plain versions must follow:

* bin row i reads ``h // 7 + 2`` map rows from ``min(lo_i, h - span)`` and
  masks a cell outside the bin by adding -1e30, so a NaN anywhere in those
  rows, even outside the bin or the ROI's columns, takes the bin's
  cotangent (``jnp.argmax`` takes the first NaN), and an in-bin -inf loses
  to an outside cell;
* the f32 kernel skips a ROI for a channel block of 256 channels whose
  cotangent holds a NaN (``sum(|g|) > 0`` is false); the bf16 kernel lists
  a ROI whose cotangent has any nonzero or NaN entry;
* a NaN or inf cotangent reaches its chosen cell only, and an empty bin's
  non-finite cotangent (times 0: NaN) lands on a cell chosen over its
  row's whole window.

Equality is exact: the same NaN positions and equal values elsewhere
(``np.testing.assert_array_equal``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.ops.roi_pool_pallas import _bwd_call, _fc_bwd_call
from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad, roi_pool_grad_bf16

SCALE = 1.0 / 16.0
_bwd = jax.jit(_bwd_call, static_argnums=(3, 4, 5, 6, 7))
_fc_bwd = jax.jit(_fc_bwd_call, static_argnums=(3, 4, 5, 6, 7))


def _pallas(feat, rois, g, bf16):
    if bf16:
        return np.asarray(_fc_bwd(
            jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(rois),
            jnp.asarray(g.reshape(len(rois), -1)).astype(jnp.bfloat16),
            7, 7, SCALE, True, "gpu"))
    return np.asarray(_bwd(jnp.asarray(feat), jnp.asarray(rois),
                           jnp.asarray(g), 7, 7, SCALE, True, "gpu"))


def _port(feat, rois, g, bf16):
    tg = torch.from_numpy(g)[None]
    fn = roi_pool_grad_bf16 if bf16 else roi_pool_grad
    return fn(torch.from_numpy(feat)[None], torch.from_numpy(rois)[None],
              tg.to(torch.bfloat16) if bf16 else tg, 7, 7, SCALE)[0].numpy()


def _check(feat, rois, g, bf16):
    want = _pallas(feat, rois, g, bf16)
    got = _port(feat, rois, g, bf16)
    np.testing.assert_array_equal(got, want)
    return got


def _case(seed=0):
    """A [32, 32, 8] map and one ROI over map cells 4..17."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(32, 32, 8).astype(np.float32)
    rois = np.array([[64, 64, 287, 287]], np.float32)
    g = rng.randn(1, 7, 7, 8).astype(np.float32)
    return feat, rois, g


# (row, col) of a NaN at channel 0: inside a bin; bin row 0's span below
# its bin; the same rows outside the ROI's columns; below the ROI inside
# bin row 6's span; outside every span
NAN_AT = [(4, 4), (8, 5), (8, 25), (20, 5), (3, 5)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("at", NAN_AT + [None])
def test_nan_in_map_routes_as_pallas(at, bf16):
    feat, rois, g = _case()
    if at is not None:
        feat[at[0], at[1], 0] = np.nan
    got = _check(feat, rois, g, bf16)
    assert np.isfinite(got).all()
    assert (got != 0).sum() > 200


def test_nan_routing_leaves_the_bin():
    """A NaN outside the ROI's columns takes the cotangent of every bin of
    each bin row whose window holds it: the ROI covers map cells 4..17
    (14 rows, bin i from row 4 + 2i), a window is 32 // 7 + 2 = 6 rows,
    so row 8 lies in the windows of bin rows 0, 1 and 2, and their 21
    cotangents at channel 0 all land on the NaN's cell."""
    feat, rois, g = _case()
    feat[8, 25, 0] = np.nan
    got = _check(feat, rois, g, False)
    want = g[0, :3, :, 0].sum()
    np.testing.assert_allclose(got[8, 25, 0], want, rtol=1e-5)
    assert (got[:, :, 0] != 0).sum() == 1 + (got[:, :, 0] != 0)[
        np.arange(32) >= 10].sum()


@pytest.mark.parametrize("bf16", [False, True])
def test_infinities_and_huge_values(bf16):
    """In-bin -inf next to finite values; a column of in-bin -inf (an
    outside row of the window wins); +inf outside the bin; values beyond
    the -1e30 mask's reach."""
    feat, rois, g = _case(1)
    feat[5:7, 5, 1] = -np.inf
    feat[4:6, 4, 2] = -np.inf
    feat[4:8, 7, 3] = -np.inf
    feat[10, 20, 3] = np.inf
    feat[12, 2, 4] = 3e30
    feat[14, 8, 5] = -2e30
    _check(feat, rois, g, bf16)


def _blocks_case(seed=2):
    """C = 512: two channel blocks of the f32 kernel; three ROIs, one partly
    off the map (empty bins)."""
    rng = np.random.RandomState(seed)
    feat = np.maximum(rng.randn(10, 12, 512), 0).astype(np.float32)
    rois = np.array([[16, 16, 150, 130], [-200, -120, 60, 40],
                     [100, 60, 400, 300]], np.float32)
    g = rng.randn(3, 7, 7, 512).astype(np.float32)
    return feat, rois, g


@pytest.mark.parametrize("bf16", [False, True])
def test_nan_cotangent_in_some_rois(bf16):
    """A NaN in ROI 0's second channel block, and in ROI 2's first: the f32
    kernel skips those blocks of those ROIs; the bf16 kernel lists them and
    adds the NaN at its chosen cell."""
    feat, rois, g = _blocks_case()
    g[0, 3, 3, 300] = np.nan
    g[2, 1, 5, 7] = np.nan
    got = _check(feat, rois, g, bf16)
    assert np.isnan(got).any() == bf16


@pytest.mark.parametrize("bf16", [False, True])
def test_fully_nan_cotangent(bf16):
    """The diverged step: every cotangent entry NaN.  f32: every block is
    skipped, dfeat is zero; bf16: NaN at every chosen cell, empty bins'
    included."""
    feat, rois, g = _blocks_case(3)
    g[:] = np.nan
    got = _check(feat, rois, g, bf16)
    assert np.isnan(got).any() == bf16


@pytest.mark.parametrize("bf16", [False, True])
def test_nonfinite_cotangent_in_empty_bins(bf16):
    """inf and NaN cotangents in ROI 1's empty bins (off the map) and in a
    non-empty bin: times 0 they are NaN, placed over the bin row's whole
    window."""
    feat, rois, g = _blocks_case(4)
    g[1, 0, 0, 2] = np.inf
    g[1, 6, 6, 3] = np.inf
    g[2, 6, 6, 1] = -np.inf
    g[0, 3, 3, 2] = np.inf
    if bf16:
        g[1, 6, 0, 9] = np.nan
    _check(feat, rois, g, bf16)
