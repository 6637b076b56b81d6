"""The port's anchor targets (``ops/anchor_target.py``, all three dataset
modes) and proposal targets (``ops/proposal_target.py``) against the JAX
package's, on the same inputs and the same random draws: the JAX uniforms
are reproduced here from the key splits of ``ops/anchor_target.py:145,220``
and ``ops/proposal_target.py:87,170`` and handed to the port.

Labels, sampled ROIs, masks and weights must be identical; regression
targets agree to an ulp of ``log`` (XLA and PyTorch round it apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.ops.anchor_target import \
    anchor_target_layer_joint as jax_anchor_targets
from wssdl_bus_tpu.ops.boxes import iou_ui_matrix as jax_iou_ui
from wssdl_bus_tpu.ops.proposal_target import \
    proposal_target_layer as jax_proposal_targets
from wssdl_bus_tpu_torch.ops.anchor_target import anchor_target_layer_joint
from wssdl_bus_tpu_torch.ops.anchors import shifted_anchors
from wssdl_bus_tpu_torch.ops.boxes import iou_ui_matrix
from wssdl_bus_tpu_torch.ops.proposal_target import (num_candidates,
                                                     proposal_target_layer)

T_TOL = dict(rtol=2e-6, atol=2e-6)   # an ulp of log, relative and absolute


def anchor_uniforms(key, b, num_supervised, k):
    """The fg/bg uniforms anchor_target_layer_joint draws for each
    supervised image: split(key, B)[i] -> split -> uniform((K,)) each."""
    keys = jax.random.split(key, b)
    out = []
    for i in range(num_supervised):
        kf, kb = jax.random.split(keys[i])
        out.append([np.asarray(jax.random.uniform(kf, (k,))),
                    np.asarray(jax.random.uniform(kb, (k,)))])
    return np.asarray(out, np.float32).reshape(num_supervised, 2, k)


def roi_uniforms(key, b, n):
    """proposal_target_layer's draws: split(key, B)[i] -> split ->
    uniform((n,)) each, n = num_candidates(...)."""
    keys = jax.random.split(key, b)
    out = []
    for i in range(b):
        kf, kb = jax.random.split(keys[i])
        out.append([np.asarray(jax.random.uniform(kf, (n,))),
                    np.asarray(jax.random.uniform(kb, (n,)))])
    return np.asarray(out, np.float32).reshape(b, 2, n)


def _gt_batch(rng, b, h, w):
    """Per image: two fg masses (benign, malignant), one large annotated
    background box, then zero padding; the last image has no GT (weak)."""
    gt = np.zeros((b, 20, 5), np.float32)
    num = np.zeros((b,), np.int32)
    for i in range(b - 1):
        for j, cls in enumerate((1, 2)):
            x1, y1 = rng.uniform(0, w * 8), rng.uniform(0, h * 8)
            gt[i, j] = [x1, y1, x1 + rng.uniform(60, w * 8),
                        y1 + rng.uniform(60, h * 8), cls]
        gt[i, 2] = [rng.uniform(0, 20), rng.uniform(0, 20),
                    w * 16 - rng.uniform(1, 30), h * 16 - rng.uniform(1, 30),
                    0]
        num[i] = 3
    return gt, num


@pytest.mark.parametrize("dataset", ["SNUBH", "SNUBH_FG", "UDIAT"])
def test_anchor_targets_match_jax(rng, dataset):
    h, w, b, n_s = 20, 28, 3, 2
    anchors = shifted_anchors(h, w, 16, scales=(4, 8, 16))
    gt, num = _gt_batch(rng, b, h, w)
    im_info = np.array([[h * 16 - 5.0, w * 16 - 9.0, 1.0, 1.0]] * b,
                       np.float32)
    key = jax.random.PRNGKey(dataset == "UDIAT")
    # a small batch so that both subsamplings bite
    kw = dict(dataset=dataset, rpn_batchsize=64, rpn_fg_fraction=0.5)
    want = jax_anchor_targets(key, jnp.asarray(gt), jnp.asarray(num),
                              jnp.asarray(im_info), jnp.asarray(anchors),
                              num_supervised=n_s, **kw)
    u = anchor_uniforms(key, b, n_s, len(anchors))
    got = anchor_target_layer_joint(
        torch.from_numpy(gt), torch.from_numpy(num), torch.from_numpy(im_info),
        torch.from_numpy(anchors), n_s, uniforms=torch.from_numpy(u), **kw)
    lab = np.asarray(want.labels)
    np.testing.assert_array_equal(got.labels.numpy(), lab)
    assert ((lab[:n_s] == 1).sum(1) > 0).all() and (lab[n_s:] == -1).all()
    assert ((lab[:n_s] == 0).sum(1) > 0).all()
    assert ((lab[:n_s] >= 0).sum(1) == 64).all()   # the caps were reached
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), **T_TOL)
    np.testing.assert_array_equal(got.inside_weights.numpy(),
                                  np.asarray(want.inside_weights))
    np.testing.assert_array_equal(got.outside_weights.numpy(),
                                  np.asarray(want.outside_weights))


def test_anchor_targets_positive_weight_matches_jax(rng):
    h, w = 16, 20
    anchors = shifted_anchors(h, w, 16, scales=(4, 8, 16))
    gt, num = _gt_batch(rng, 2, h, w)
    im_info = np.array([[h * 16.0, w * 16.0, 1.0, 1.0]] * 2, np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(dataset="SNUBH", positive_weight=0.3,
              bbox_inside_weights=(1.0, 1.0, 0.5, 0.5))
    want = jax_anchor_targets(key, jnp.asarray(gt), jnp.asarray(num),
                              jnp.asarray(im_info), jnp.asarray(anchors),
                              num_supervised=1, **kw)
    got = anchor_target_layer_joint(
        torch.from_numpy(gt), torch.from_numpy(num), torch.from_numpy(im_info),
        torch.from_numpy(anchors), 1, uniforms=torch.from_numpy(
            anchor_uniforms(key, 2, 1, len(anchors))), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.inside_weights.numpy(),
                                  np.asarray(want.inside_weights))
    np.testing.assert_allclose(got.outside_weights.numpy(),
                               np.asarray(want.outside_weights), rtol=1e-7)


def test_iou_ui_matrix_matches_jax(rng):
    xy = rng.uniform(-50, 400, (40, 2))
    a = np.hstack([xy, xy + rng.uniform(0, 200, (40, 2))]).astype(np.float32)
    q = a[rng.permutation(40)[:9]] + rng.uniform(-40, 40, (9, 4))
    q = q.astype(np.float32)
    np.testing.assert_allclose(
        iou_ui_matrix(torch.from_numpy(a), torch.from_numpy(q)).numpy(),
        np.asarray(jax_iou_ui(a, q)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("normalize", [False, True])
def test_proposal_targets_match_jax(rng, normalize):
    b, p, h, w = 2, 300, 24, 32
    gt, num = _gt_batch(rng, b + 1, h, w)
    gt, num = gt[:b], num[:b]
    # proposals: jittered copies of the GT boxes (foreground candidates)
    # and random boxes (background), some invalid
    props = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        base = gt[i, rng.randint(0, 3, p), :4]
        jit = rng.uniform(-40, 40, (p, 4)) * (rng.uniform(size=(p, 1)) < 0.3)
        rand_xy = rng.uniform(0, w * 12, (p, 2))
        rand = np.hstack([rand_xy, rand_xy + rng.uniform(16, 200, (p, 2))])
        props[i] = np.where(rng.uniform(size=(p, 1)) < 0.5, base + jit, rand)
    valid = rng.uniform(size=(b, p)) > 0.1
    key = jax.random.PRNGKey(7)
    kw = dict(num_classes=3, rois_per_image=128, normalize_targets=normalize)
    want = jax_proposal_targets(key, jnp.asarray(props), jnp.asarray(valid),
                                jnp.asarray(gt), jnp.asarray(num),
                                include_gt=True, **kw)
    n = num_candidates(p, gt.shape[1], 128)
    got = proposal_target_layer(
        torch.from_numpy(props), torch.from_numpy(valid),
        torch.from_numpy(gt), torch.from_numpy(num),
        uniforms=torch.from_numpy(roi_uniforms(key, b, n)), include_gt=True,
        **kw)
    labels = np.asarray(want.labels)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    assert ((labels > 0).sum(1) == 32).all()        # the fg cap bit
    assert ((labels == 0).sum(1) > 0).all()
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), **T_TOL)
    np.testing.assert_array_equal(got.inside_weights.numpy(),
                                  np.asarray(want.inside_weights))
    np.testing.assert_array_equal(got.outside_weights.numpy(),
                                  np.asarray(want.outside_weights))


def test_proposal_targets_scarce_candidates_pad_with_minus_one():
    """Fewer candidates than slots: the rest are -1 padding, in both."""
    props = np.array([[[10, 10, 60, 60], [200, 200, 220, 230]]], np.float32)
    valid = np.array([[True, True]])
    gt = np.zeros((1, 4, 5), np.float32)
    gt[0, 0] = [12, 8, 58, 63, 2]
    num = np.array([1], np.int32)
    key = jax.random.PRNGKey(0)
    want = jax_proposal_targets(key, jnp.asarray(props), jnp.asarray(valid),
                                jnp.asarray(gt), jnp.asarray(num),
                                num_classes=3, rois_per_image=16)
    n = num_candidates(2, 4, 16)
    got = proposal_target_layer(
        torch.from_numpy(props), torch.from_numpy(valid),
        torch.from_numpy(gt), torch.from_numpy(num), num_classes=3,
        rois_per_image=16,
        uniforms=torch.from_numpy(roi_uniforms(key, 1, n)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels[0, 3:] == -1).all()
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
