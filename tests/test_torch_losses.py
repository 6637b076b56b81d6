"""The port's losses (``train/losses.py``) and MIL selectors (``mil/``)
against the JAX package's, values and gradients, on the same inputs.

Reductions run in a different order in the two frameworks, so sums agree
to a few f32 ulps (rtol 1e-6); the MIL selectors pick the same row
(first index among equals) and must be exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.mil import get_bag_logits as jax_bag_logits
from wssdl_bus_tpu.train import losses as JL
from wssdl_bus_tpu_torch.mil import SELECTORS, get_bag_logits
from wssdl_bus_tpu_torch.train import losses as L

A = 9
TOL = dict(rtol=1e-6, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _grad_both(jfn, tfn, *arrays):
    """(value, grads) of a scalar function of ``arrays`` in both."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [_t(a).clone().requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    return (float(jv), [np.asarray(g) for g in jg],
            float(tv.detach()), [t.grad.numpy() for t in ts])


def test_rpn_losses_match_jax(rng):
    b, h, w = 2, 6, 8
    k = h * w * A
    score = rng.randn(b, h, w, 2 * A).astype(np.float32)
    bbox = (rng.randn(b, h, w, 4 * A) * 1.5).astype(np.float32)
    labels = rng.randint(-1, 2, (b, k)).astype(np.int32)
    labels[1] = -1                                   # a weak image
    targets = rng.randn(b, k, 4).astype(np.float32)
    in_w = (labels == 1)[..., None].repeat(4, -1).astype(np.float32)
    out_w = ((labels >= 0)[..., None] / 100.0).repeat(4, -1)
    out_w = out_w.astype(np.float32)

    jv, jg, tv, tg = _grad_both(
        lambda s: JL.rpn_class_loss(s, jnp.asarray(labels), A),
        lambda s: L.rpn_class_loss(s, _t(labels), A), score)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)

    jv, jg, tv, tg = _grad_both(
        lambda p: JL.rpn_box_loss(p, targets, in_w, out_w, 1, A),
        lambda p: L.rpn_box_loss(p, _t(targets), _t(in_w), _t(out_w), 1, A),
        bbox)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)
    # the reference quirk: negatives with |delta| >= 1 contribute
    assert jv > 0 and np.abs(tg[0][0]).sum() > 0


def test_rcnn_losses_match_jax(rng):
    n, c = 40, 3
    score = rng.randn(n, c).astype(np.float32)
    bbox = rng.randn(n, 4 * c).astype(np.float32)
    labels = rng.randint(-1, 3, n).astype(np.int32)
    targets = rng.randn(n, 4 * c).astype(np.float32)
    in_w = (rng.uniform(size=(n, 4 * c)) < 0.3).astype(np.float32)
    out_w = in_w.copy()

    jv, jg, tv, tg = _grad_both(
        lambda s: JL.rcnn_class_loss(s, jnp.asarray(labels)),
        lambda s: L.rcnn_class_loss(s, _t(labels)), score)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)
    jv, jg, tv, tg = _grad_both(
        lambda p: JL.rcnn_box_loss(p, targets, in_w, out_w,
                                   jnp.asarray(labels)),
        lambda p: L.rcnn_box_loss(p, _t(targets), _t(in_w), _t(out_w),
                                  _t(labels)), bbox)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)


@pytest.mark.parametrize("step", [0, 1999, 2000, 40000])
def test_mil_loss_and_adaptive_scale_match_jax(rng, step):
    logits = rng.randn(4, 3).astype(np.float32) * 3
    labels = np.array([1, 2, 2, 1], np.int32)
    js = JL.mil_adaptive_scale(jnp.int32(step))
    ts = L.mil_adaptive_scale(step)
    np.testing.assert_allclose(float(ts), float(js), rtol=2e-7)
    jv, jg, tv, tg = _grad_both(
        lambda x: JL.mil_class_loss(x, jnp.asarray(labels), 0.2209, js),
        lambda x: L.mil_class_loss(x, _t(labels), 0.2209, ts), logits)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **TOL)


def test_weight_decay_counts_weights_only():
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.arange(6.0).reshape(2, 3))
        lin.bias.fill_(100.0)
    assert float(L.weight_decay_loss(lin, 0.1).detach()) == pytest.approx(
        0.1 * 0.5 * 55.0)
    want = JL.weight_decay_loss({"dense": {"kernel": jnp.arange(6.0),
                                           "bias": jnp.full(2, 100.0)}}, 0.1)
    assert float(want) == pytest.approx(0.1 * 0.5 * 55.0)


@pytest.mark.parametrize("name", sorted(SELECTORS))
def test_mil_selectors_match_jax(rng, name):
    """Each selector alone (as both halves of the pair) and mixed with
    mal_max by bag label; values, and the gradient reaching one row."""
    b, p, c = 3, 50, 3
    logits = rng.randn(b, p, c).astype(np.float32)
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1.0   # an exact tie
    valid = rng.uniform(size=(b, p)) > 0.3
    valid[0, 7] = valid[0, 9] = True
    labels = np.array([1, 2, 1], np.int32)
    for pair in ((name, name), (name, "mal_max")):
        jv, jg, tv, tg = _grad_both(
            lambda x: jnp.sum(jax_bag_logits(x, jnp.asarray(valid),
                                             jnp.asarray(labels), pair)
                              * jnp.arange(1.0, 4.0)),
            lambda x: torch.sum(get_bag_logits(x, _t(valid), _t(labels),
                                               pair)
                                * torch.arange(1.0, 4.0)), logits)
        got = get_bag_logits(_t(logits), _t(valid), _t(labels), pair)
        want = jax_bag_logits(jnp.asarray(logits), jnp.asarray(valid),
                              jnp.asarray(labels), pair)
        if name == "mean_ben":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(tg[0], jg[0], **TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(tg[0], jg[0])
            # the gradient reaches exactly one instance per bag
            assert ((np.abs(tg[0]).sum(-1) > 0).sum(-1) == 1).all()


@pytest.mark.parametrize("opt_name", ["adam", "amsgrad", "sgd"])
def test_optimizer_matches_optax(rng, opt_name):
    """``train/engine.py:Optimizer`` against the JAX package's
    ``make_optimizer`` (optax, injected learning rate) over four steps with
    changing learning rates; in step 3 one parameter gets no gradient,
    which optax sees as zeros (amsgrad's max over the bias-corrected second
    moment and Adam's decaying moments still move it)."""
    from wssdl_bus_tpu.config import Config as JaxConfig
    from wssdl_bus_tpu.train.engine import make_optimizer as jax_make
    from wssdl_bus_tpu_torch.train.engine import Optimizer

    init = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in init.items()} for _ in range(4)]
    grads[2]["b"] = np.zeros(4, np.float32)
    lrs = [5e-4, 1e-3, 2e-4, 5e-4]
    tx = jax_make(opt_name, JaxConfig())
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = Optimizer(opt_name, [("a", tp["a"]), ("b", tp["b"])], momentum=0.9)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.zero_grad()
        tp["a"].grad = torch.from_numpy(g["a"])
        if g["b"].any():
            tp["b"].grad = torch.from_numpy(g["b"])
        opt.step(lr)
        for k in jp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert not np.array_equal(tp["b"].detach().numpy(), init["b"])
