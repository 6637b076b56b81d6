"""The stem paths of the slice: the port's trunk and combined training step
with a stem kernel dispatched (``WSSDL_FUSED_STEM=1`` / ``WSSDL_STEM_TAIL=1``)
against the JAX package doing the same, at full VGG16 width on the 192x256
canvas of ``tests/test_torch_train_step.py``.

On the CPU neither package dispatches its stem by itself (the JAX gates want
a TPU, the port's a CUDA device), so both gates are forced open: the port's
device checks are patched, and the JAX package's gates are patched to its
own shape predicates with the Pallas kernels in interpret mode (weights
behind ``stop_gradient``, see ``_interpret``).  The port
then runs the kernels' plain versions, which the CUDA kernels equal bit for
bit on the card (``chip_smoke.py``).

Inputs.  Where a conv1_1 value straddles a bf16 rounding boundary, f32
reassociation can round it to neighbouring bf16 values in the two packages,
which moves the stem output by a bf16 ulp of that value: far above the
trunk's f32 drift.  So the data is integer-valued and conv1_1's kernel is
a multiple of 2^-12 below 1/16: every partial sum of conv1_1 is then exact
in f32 and both packages round the same values.  Past that the stems
differ by f32 reassociation only, and the tolerances are those of the
whole trunk (``tests/test_torch_model.py``: rtol 1e-4 plus 1e-5 of the
max) and of the training step (``tests/test_torch_train_step.py``: keep
sets, labels and selections identical, losses to 1e-4 relative, updates
within 5e-2 * lr everywhere and 5e-3 * lr in 99.9% of the elements)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wssdl_bus_tpu.ops.conv1_pallas as jax_conv1
import wssdl_bus_tpu.ops.conv2_pool_pallas as jax_conv2
from tests.test_torch_train_step import (LOSS_RTOL, LR, STEP, _check_params,
                                         _combined_draws, setup)  # noqa: F401
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.train.engine import make_optimizer, vgg_frozen_mask
from wssdl_bus_tpu_torch.models import detector
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.ops import conv1, conv2_pool

VARS = {"fused": "WSSDL_FUSED_STEM", "tail": "WSSDL_STEM_TAIL"}


def _exact_conv1_1(he):
    """conv1_1's kernel rounded to multiples of 2^-12 in [-255, 255] * 2^-12
    (bf16-exact, and exact partial sums on integer data up to 255)."""
    k = he["trunk"]["params"]["backbone"]["conv1_1"]["conv"]
    k["kernel"] = np.clip(np.round(k["kernel"] * 4096), -255, 255) \
        .astype(np.float32) / 4096


def _interpret(kernel):
    """The Pallas kernel in interpret mode, its weights behind
    ``stop_gradient``: the JAX package drops the stem's gradient with a
    ``stop_gradient`` on the kernel's output, but under ``jax.grad`` on
    the CPU the interpreted ``pallas_call`` still gets weight tangents and
    its JVP rule fails (an AssertionError in ``ad.jvp_jaxpr``).  Stopping
    them at the inputs instead computes the same values and gradients."""
    def call(x, *weights):
        return kernel(x, *map(jax.lax.stop_gradient, weights),
                      interpret=True)
    return call


@pytest.fixture
def forced(monkeypatch):
    """-> open(mode): force both packages' gates for ``mode``, and the
    list of stem functions the port dispatched."""
    seen = []
    monkeypatch.setattr(conv1, "_device_ok", lambda device: True)
    monkeypatch.setattr(conv2_pool, "_device_ok", lambda device: True)
    monkeypatch.setattr(jax_conv1, "vgg_stem_fused", _interpret(
        jax_conv1.vgg_stem_fused))
    monkeypatch.setattr(jax_conv2, "vgg_conv2_pool", _interpret(
        jax_conv2.vgg_conv2_pool))
    for name in ("vgg_stem_fused", "vgg_conv2_pool"):
        fn = getattr(detector, name)
        monkeypatch.setattr(detector, name, functools.partial(
            lambda fn, name, *a: seen.append(name) or fn(*a), fn, name))

    def open_(mode):
        monkeypatch.setenv(VARS[mode], "1")
        gate = {"fused": (jax_conv1, "fused_stem_ok",
                          jax_conv1.stem_shape_ok),
                "tail": (jax_conv2, "conv2_pool_ok",
                         jax_conv2.conv2_pool_shape_ok)}[mode]
        monkeypatch.setattr(*gate)
        return seen
    return open_


@pytest.mark.parametrize("mode", ["fused", "tail"])
def test_trunk_with_stem_matches_jax(mode, forced):
    torch.set_num_threads(2)
    jm = JaxFasterRCNN(backbone="VGGnet")
    port = build_detector("VGGnet_test", device="cpu")
    he = he_tree(params_to_jax(port.state_dict()), 4, input_scale=64.0)
    _exact_conv1_1(he)
    port.load_state_dict(params_from_jax(he))
    data = np.random.RandomState(4).randint(-128, 128, (1, 192, 256, 3)) \
        .astype(np.float32)
    seen = forced(mode)
    want = jm.apply_trunk(jax.tree.map(jnp.asarray, he), jnp.asarray(data),
                          train=False)[:3]
    with torch.no_grad():
        got = port.apply_trunk(torch.from_numpy(data))
    assert seen == [{"fused": "vgg_stem_fused", "tail": "vgg_conv2_pool"}[mode]]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_combined_step_with_fused_stem_matches_jax(setup, forced):  # noqa
    """One combined step with the JAX package's draws injected, both sides
    through the fused stem: the checks of tests/test_torch_train_step.py."""
    s = setup
    jeng, eng, batch = s["jeng"], s["eng"], s["batch"]
    # integer data and an exact conv1_1 (module docstring), on both sides
    batch["data"] = np.round(batch["data"])
    _exact_conv1_1(s["he"])
    s["jvars"] = jax.tree.map(jnp.asarray, s["he"])
    params = {"trunk": s["jvars"]["trunk"]["params"],
              "head": s["jvars"]["head"]["params"]}
    jeng._tx = make_optimizer("adam", jeng.cfg, vgg_frozen_mask(params))
    s["opt_state"] = jeng.tx.init(params)
    s["port"].load_state_dict(params_from_jax(s["he"]))
    seen = forced("fused")

    key = jax.random.PRNGKey(7)
    draws, jfwd = _combined_draws(s, key)
    (_, _, _, _, jprops, jsamples, _, jcls, _, _) = jfwd
    with torch.no_grad():
        _, _, details = eng.forward_train(batch, STEP, draws)
    props, samples = details["props"], details["samples"]
    np.testing.assert_array_equal(props.valid.numpy(),
                                  np.asarray(jprops.valid))
    np.testing.assert_array_equal(samples.labels.numpy(),
                                  np.asarray(jsamples.labels))
    np.testing.assert_allclose(samples.rois.numpy(),
                               np.asarray(jsamples.rois), rtol=0, atol=2e-2)

    before = jax.tree.map(np.asarray, s["he"])
    jvars, _, jls = jeng._train_step_impl(
        s["jvars"], s["opt_state"], {k: jnp.asarray(v) for k, v in
                                     batch.items()},
        key, jnp.float32(LR), jnp.int32(STEP))
    ls = eng.train_step(batch, LR, STEP, draws)
    assert seen == ["vgg_stem_fused"] * 2
    for name, got, want in zip(ls._fields, ls, jls):
        assert np.isfinite(float(got)), name
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    assert float(ls.mil_cls) > 0 and float(ls.rcnn_box) > 0
    assert _check_params(s["port"], jvars, before) == 32
