"""The bf16 output option of the port's ``roi_pool_fc``
(``ops/roi_pool_cuda.py``; on CPU tensors the plain versions of the CUDA
kernels' bf16 instances in ``csrc/roi_pool.cu``) against the JAX package.

* Forward: ``bf16(max(feat))`` equals the JAX package's
  ``roi_pool_fc(..., out_dtype=bfloat16)`` on the CPU (its fallback: the
  jit pool, reshaped, cast) exactly.
* Backward (the Pallas ``_fc_bwd_kernel``'s semantics): on tie-free,
  bf16-exact features it equals ``jax.grad`` of that fallback exactly; where
  rounding to bf16 creates ties it equals the Pallas ``_bwd_kernel`` (in
  interpret mode, as ``tests/test_torch_roi_pool_grad.py`` runs it) applied
  to ``bf16(feat)``: first column, then first row.  The Pallas bf16 kernels
  themselves are not run here: the JAX suite keeps them in its slow lane.
* The dtype contract: a bf16 output receives a bf16 cotangent, and an f32
  feat gets an f32 dfeat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_pool_fc import unique_bf16_feat
from tests.test_roi_pool_pallas import make_case
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_fc as jax_roi_pool_fc
from wssdl_bus_tpu.ops.roi_pool_pallas import roi_pool_image
from wssdl_bus_tpu_torch.ops.roi_pool import roi_pool_grad, roi_pool_grad_bf16
from wssdl_bus_tpu_torch.ops.roi_pool_cuda import (roi_pool_fc,
                                                   roi_pool_fc_backward_bf16,
                                                   roi_pool_fc_bf16,
                                                   roi_pool_fc_plain)

SCALE = 1.0 / 16.0
BF16 = torch.bfloat16


def _batched(rng, h=16, w=16, c=4, p=6, feat=None):
    feats, rois = [], []
    for _ in range(2):
        f, r = make_case(rng, h=h, w=w, c=c, p=p)
        feats.append(f if feat is None else feat())
        rois.append(r)
    return np.stack(feats), np.stack(rois)


@pytest.mark.parametrize("flavor", ["gpu", "cpu"])
def test_forward_equals_jax_bf16_option(rng, flavor):
    feat, rois = _batched(rng, h=24, w=30, c=8, p=13)
    want = jax_roi_pool_fc(jnp.asarray(feat), jnp.asarray(rois), 7, 7, SCALE,
                           flavor=flavor, out_dtype=jnp.bfloat16)
    got = roi_pool_fc(torch.from_numpy(feat), torch.from_numpy(rois), 7, 7,
                      SCALE, flavor, out_dtype=BF16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # == the f32 output rounded (rounding commutes with max)
    f32 = roi_pool_fc(torch.from_numpy(feat), torch.from_numpy(rois), 7, 7,
                      SCALE, flavor)
    assert torch.equal(got, f32.to(BF16))
    assert torch.equal(roi_pool_fc_bf16(torch.from_numpy(feat),
                                        torch.from_numpy(rois), 7, 7, SCALE,
                                        flavor), got)


def _port_grad(feat, rois, wts, out_dtype=BF16):
    f = torch.from_numpy(feat).requires_grad_(True)
    out = roi_pool_fc(f, torch.from_numpy(rois), 7, 7, SCALE,
                      out_dtype=out_dtype)
    (out.float() * torch.from_numpy(wts).reshape(out.shape)).sum().backward()
    return f.grad


def _jax_fallback_grad(feat, rois, wts):
    def loss(f):
        out = jax_roi_pool_fc(f, jnp.asarray(rois), 7, 7, SCALE,
                              out_dtype=jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * wts.reshape(out.shape))

    return np.asarray(jax.grad(loss)(jnp.asarray(feat)))


def test_backward_equals_jax_on_bf16_exact_feat(rng):
    """Tie-free bf16-exact features, bf16-exact cotangent weights: no
    rounding anywhere and unique maxima, so the routing is forced."""
    h, w, c, p = 16, 16, 4, 5
    feat, rois = _batched(rng, h, w, c, p,
                          feat=lambda: unique_bf16_feat(rng, h, w, c))
    wts = (1.0 + (np.arange(2 * p * 49 * c) % 3)).astype(np.float32)
    got = _port_grad(feat, rois, wts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_fallback_grad(feat, rois, wts))
    assert (got != 0).sum() > 100


def test_backward_skips_zero_cotangent_rows(rng):
    """A MIL-like cotangent, two active rows of 24: still the fallback's
    gradient exactly (the active-row guard drops only zero rows)."""
    h, w, c, p = 16, 16, 4, 24
    feat, rois = _batched(rng, h, w, c, p,
                          feat=lambda: unique_bf16_feat(rng, h, w, c))
    wts = np.zeros((2, p, 49 * c), np.float32)
    wts[0, 5] = 1.0
    wts[1, 20] = 2.0
    got = _port_grad(feat, rois, wts)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_fallback_grad(feat, rois, wts))
    assert (got != 0).sum() > 0


def _pallas_dfeat(feat, rois, g):
    """VJP of the Pallas roi_pool_image (interpret mode) per image."""
    out = []
    for f, r, gi in zip(feat, rois, g):
        _, vjp = jax.vjp(lambda x: roi_pool_image(x, jnp.asarray(r), 7, 7,
                                                  SCALE, True, "gpu"),
                         jnp.asarray(f))
        out.append(np.asarray(vjp(jnp.asarray(gi))[0]))
    return np.stack(out)


def test_backward_ties_from_rounding_follow_the_pallas_rule(rng):
    """Values 1 + k/2^12 all round to one of a few bf16 values: ties that
    the f32 map does not have.  The bf16 backward routes them as the Pallas
    backward kernel routes ``bf16(feat)``, and not as the f32 map would."""
    h, w, c, p = 16, 16, 4, 8
    feat, rois = _batched(rng, h, w, c, p, feat=lambda: (
        1.0 + rng.randint(0, 64, (h, w, c)) / 4096.0).astype(np.float32))
    feat_b = torch.from_numpy(feat).to(BF16).float().numpy()
    assert len(np.unique(feat)) > 40 and len(np.unique(feat_b)) <= 9
    g = rng.randn(2, p, 49 * c).astype(np.float32)
    g_bf = torch.from_numpy(g).to(BF16)
    got = roi_pool_fc_backward_bf16(torch.from_numpy(feat),
                                    torch.from_numpy(rois), g_bf)
    want = _pallas_dfeat(feat_b, rois, g_bf.float().numpy().reshape(
        2, p, 7, 7, c))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same through autograd and the plain rule
    f = torch.from_numpy(feat).requires_grad_(True)
    roi_pool_fc(f, torch.from_numpy(rois), out_dtype=BF16).backward(g_bf)
    assert torch.equal(f.grad, got)
    assert torch.equal(got, roi_pool_grad_bf16(
        torch.from_numpy(feat), torch.from_numpy(rois), g_bf))
    # routing on the f32 map would put the cotangent elsewhere
    f32_route = roi_pool_grad(torch.from_numpy(feat), torch.from_numpy(rois),
                              g_bf.float())
    assert not torch.equal(got, f32_route)


def test_dtype_contract(rng):
    feat, rois = _batched(rng, c=8)
    f = torch.from_numpy(feat).requires_grad_(True)
    seen = []
    out = roi_pool_fc(f, torch.from_numpy(rois), out_dtype=BF16)
    out.register_hook(lambda g: seen.append(g.dtype))
    (out.float() * 2.0).sum().backward()
    assert out.dtype == BF16 and seen == [BF16]
    assert f.grad.dtype == torch.float32
    # the plain version under autograd is the same function
    f2 = torch.from_numpy(feat).requires_grad_(True)
    (roi_pool_fc_plain(f2, torch.from_numpy(rois), out_dtype=BF16).float()
     * 2.0).sum().backward()
    assert torch.equal(f.grad, f2.grad)
    # a bf16 feat gets a bf16 dfeat, as in the JAX package
    fb = torch.from_numpy(feat).to(BF16).requires_grad_(True)
    roi_pool_fc(fb, torch.from_numpy(rois), out_dtype=BF16).float().sum() \
        .backward()
    assert fb.grad.dtype == BF16
    with pytest.raises(TypeError, match="out_dtype"):
        roi_pool_fc(f, torch.from_numpy(rois), out_dtype=torch.float16)
