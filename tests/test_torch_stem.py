"""The port's fused VGG stem (``ops/conv1.py``, ``ops/conv1_cuda.py``: on
CPU tensors ``vgg_stem_fused`` is the plain version of the CUDA kernel
``csrc/conv1.cu``) against the JAX package's Pallas ``vgg_stem_fused`` in
interpret mode, its gates against the JAX gates, and the stem dispatch of
``FasterRCNN.apply_trunk``.

Tolerances.  Both sides round x, the kernels and conv1_1's output to bf16
and form the same exact products; the Pallas kernel sums them in its
matrix-unit order, the port in the fixed (dy, dx, c) order.  They agree
to f32 reassociation: within 1e-5 of the output's largest magnitude
(measured at most 1.7e-7 at these four shapes with conv1_1 exact, 5.4e-7
on random data away from bf16 rounding boundaries).  On a dyadic grid
(x integers in [-4, 4], kernels and biases multiples of 1/8 in [-1, 1])
every partial sum is exact, both bf16 roundings of conv1_1's output see the
same value, and the outputs are equal bit for bit.  On random data a conv1_1
value can straddle a bf16 rounding boundary (see
``test_stem_matches_pallas_random``); with conv1_1 made exact and a random
conv1_2, every element agrees to f32 reassociation.  Trunk wiring: the
trunk after the stem agrees with the JAX trunk to ``tests/test_torch_model.py``'s
tolerance (rtol 1e-4 plus 1e-5 of the max)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wssdl_bus_tpu.models.detector import TrunkRPN as JaxTrunkRPN
from wssdl_bus_tpu.ops.conv1_pallas import stem_shape_ok as jax_shape_ok
from wssdl_bus_tpu.ops.conv1_pallas import vgg_stem_fused as jax_stem
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models import detector
from wssdl_bus_tpu_torch.models.convert import he_init_, params_to_jax
from wssdl_bus_tpu_torch.models.detector import (build_detector,
                                                 freeze_vgg_stem,
                                                 stem_is_frozen)
from wssdl_bus_tpu_torch.ops import conv1, conv2_pool
from wssdl_bus_tpu_torch.ops.conv1 import (BH, fused_stem_ok, stem_shape_ok,
                                           vgg_stem_plain, vgg_stem_reference)
from wssdl_bus_tpu_torch.ops.conv1_cuda import vgg_stem_fused
from wssdl_bus_tpu_torch.train.engine import Engine

SHAPES = [
    (1, 16, 16, 3),   # minimum eligible H and W
    (3, 16, 24, 3),   # odd batch, minimal rows
    (2, 48, 64, 3),   # several JAX row chunks per image
    (1, 32, 20, 3),   # W % 4 == 0 but W/2 not a multiple of 8
]
REL_TOL = 1e-5      # of the output's largest magnitude, see the docstring


def _weights(rng):
    w1 = (rng.randn(3, 3, 3, 64) * 0.1).astype(np.float32)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _dyadic(rng, *shape):
    """Multiples of 1/8 in [-1, 1]."""
    return (rng.randint(-8, 9, shape) / 8.0).astype(np.float32)


def _both(x, w1, b1, w2, b2):
    want = np.asarray(jax_stem(x, w1, b1, w2, b2, interpret=True))
    got = vgg_stem_fused(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    return got.numpy(), want


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_matches_pallas_random(shape, rng):
    """Random x and kernels.  Where a conv1_1 value straddles a bf16
    rounding boundary the two sums can round it to neighbouring bf16
    values; the outputs that read it then move by about a bf16 ulp of it
    times a conv1_2 weight (one such value reaches up to 9 x 64 conv1_2
    outputs), so the bound is per element: 99% within REL_TOL, all within
    1e-3 of the max (measured: one rounding apart at the third shape, 110
    of 98304 elements beyond REL_TOL, at most 4.5e-4 of the max; none at
    the others, at most 5.4e-7)."""
    x = rng.randn(*shape).astype(np.float32)
    got, want = _both(x, *_weights(rng))
    assert got.shape == want.shape == (shape[0], shape[1] // 2,
                                       shape[2] // 2, 64)
    scale = np.abs(want).max()
    assert scale > 0.5
    err = np.abs(got - want)
    assert (err > REL_TOL * scale).mean() <= 1e-2
    assert err.max() <= 1e-3 * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_conv1_2_matches_pallas_to_reassociation(shape, rng):
    """conv1_1 made exact (integer x, kernel and bias multiples of 1/8), a
    random conv1_2: both sides round the same conv1_1 values, and the
    outputs agree to f32 reassociation, every element within REL_TOL."""
    x = rng.randint(-4, 5, shape).astype(np.float32)
    _, _, w2, b2 = _weights(rng)
    got, want = _both(x, _dyadic(rng, 3, 3, 3, 64), _dyadic(rng, 64), w2, b2)
    scale = np.abs(want).max()
    assert scale > 0.5
    assert np.abs(got - want).max() <= REL_TOL * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_bit_for_bit_on_dyadic_grid(shape, rng):
    x = rng.randint(-4, 5, shape).astype(np.float32)
    w1, b1 = _dyadic(rng, 3, 3, 3, 64), _dyadic(rng, 64)
    w2, b2 = _dyadic(rng, 3, 3, 64, 64), _dyadic(rng, 64)
    got, want = _both(x, w1, b1, w2, b2)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).mean() > 0.3


def test_stem_plain_rounds_like_the_library_stem_in_bf16(rng):
    """Against the f32 library stem (``vgg_stem_reference``) the plain
    version differs by its bf16 roundings only: ~1e-2 rms-relative, the
    JAX package's own contract for its kernel
    (``tests/test_conv1_pallas.py``)."""
    x = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    ws = [torch.from_numpy(a) for a in _weights(rng)]
    got = vgg_stem_plain(x, *ws).numpy()
    ref = vgg_stem_reference(x, *ws).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 64)
    rms = np.sqrt(((got - ref) ** 2).mean() / (ref ** 2).mean())
    assert 0 < rms < 0.01, rms


def test_stem_shape_gate():
    assert stem_shape_ok((4, 608, 800, 3))
    assert stem_shape_ok((1, 2 * BH, 16, 3))
    assert not stem_shape_ok((1, 2 * BH - 2, 16, 3))   # H too small
    assert not stem_shape_ok((1, 24, 16, 3))           # H % 16 != 0
    assert not stem_shape_ok((1, 32, 18, 3))           # W % 4 != 0
    assert not stem_shape_ok((1, 32, 12, 3))           # W too small
    assert not stem_shape_ok((1, 32, 32, 1))           # not 3-channel
    assert not stem_shape_ok((32, 32, 3))              # not 4-D
    # the same decision as the JAX predicate, letter for letter
    for h in range(0, 70, 2):
        for w in range(0, 40, 2):
            for shape in ((1, h, w, 3), (2, h, w, 1)):
                assert stem_shape_ok(shape) == jax_shape_ok(shape), shape


def test_fused_stem_rejects_bad_shape(rng):
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _weights(rng))
    x = torch.from_numpy(rng.randn(1, 24, 18, 3).astype(np.float32))
    with pytest.raises(ValueError, match="chunking preconditions"):
        vgg_stem_fused(x, w1, b1, w2, b2)


def test_fused_stem_gate_is_opt_in_and_cuda_only(monkeypatch):
    shape = (4, 608, 800, 3)
    monkeypatch.delenv("WSSDL_FUSED_STEM", raising=False)
    assert not fused_stem_ok(shape, "cuda")
    monkeypatch.setenv("WSSDL_FUSED_STEM", "0")
    assert not fused_stem_ok(shape, "cuda")
    monkeypatch.setenv("WSSDL_FUSED_STEM", "1")
    assert fused_stem_ok(shape, torch.device("cuda"))
    assert fused_stem_ok(shape, "cuda:0")
    assert not fused_stem_ok(shape, "cpu")              # CUDA only
    assert not fused_stem_ok((4, 600, 800, 3), "cuda")  # H % 16 != 0


@pytest.fixture(scope="module")
def port():
    """A seeded VGG16 detector on the CPU (He weights, eval mode)."""
    torch.set_num_threads(2)
    return he_init_(build_detector("VGGnet_test", device="cpu"), 3)


def _stem_args(model):
    return detector._hwio(model.trunk.backbone.conv1_1) \
        + detector._hwio(model.trunk.backbone.conv1_2)


def test_trunk_stem_done_matches_jax(port, rng):
    """The port's trunk applied with ``stem_done`` to a stem output equals
    the JAX trunk applied with ``stem_done=True`` to the same output."""
    x = torch.from_numpy(rng.randn(1, 32, 48, 3).astype(np.float32))
    with torch.no_grad():
        stem = vgg_stem_plain(x, *_stem_args(port))
        got = port.trunk(stem, stem_done=True)
    tree = params_to_jax(port.state_dict())["trunk"]
    want = JaxTrunkRPN(backbone="VGGnet", train=False).apply(
        {"params": tree["params"]}, jnp.asarray(stem.numpy()),
        stem_done=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_apply_trunk_cpu_falls_back(port, rng, monkeypatch):
    """On the CPU the gates are closed whatever the variables say: the
    library stem, bit for bit the trunk applied directly."""
    monkeypatch.setenv("WSSDL_FUSED_STEM", "1")
    monkeypatch.setenv("WSSDL_STEM_TAIL", "1")
    x = torch.from_numpy(rng.randn(1, 32, 48, 3).astype(np.float32))
    with torch.no_grad():
        got = port.apply_trunk(x)
        want = port.trunk(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def calls(monkeypatch):
    """The CUDA gates forced open on the CPU, and the four stem functions
    the dispatch may call, counted."""
    monkeypatch.setattr(conv1, "_device_ok", lambda device: True)
    monkeypatch.setattr(conv2_pool, "_device_ok", lambda device: True)
    monkeypatch.delenv("WSSDL_FUSED_STEM", raising=False)
    monkeypatch.delenv("WSSDL_STEM_TAIL", raising=False)
    seen = []

    def spy(name):
        fn = getattr(detector, name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            seen.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(detector, name, wrapped)

    for name in ("vgg_stem_fused", "vgg_stem_plain", "vgg_conv2_pool",
                 "vgg_conv2_pool_plain"):
        spy(name)
    return seen


def test_apply_trunk_dispatch_order(port, rng, monkeypatch, calls):
    """The JAX package's order: the fused stem first, then the tail; only
    with a variable set and an eligible shape; ``plain_ops`` takes the
    plain versions; the stem's output feeds the trunk with ``stem_done``."""
    x = torch.from_numpy(rng.randn(1, 32, 48, 3).astype(np.float32))
    with torch.no_grad():
        port.apply_trunk(x)
        assert calls == []
        monkeypatch.setenv("WSSDL_STEM_TAIL", "1")
        port.apply_trunk(x)
        assert calls == ["vgg_conv2_pool"]
        monkeypatch.setenv("WSSDL_FUSED_STEM", "1")
        got = port.apply_trunk(x)
        assert calls[1:] == ["vgg_stem_fused"]
        port.apply_trunk(x, plain_ops=True)
        assert calls[2:] == ["vgg_stem_plain"]
        monkeypatch.setenv("WSSDL_FUSED_STEM", "0")
        port.apply_trunk(x, plain_ops=True)
        assert calls[3:] == ["vgg_conv2_pool_plain"]
        # W % 16 != 0 fails the tail's gate (the fused stem is off)
        port.apply_trunk(x[:, :, :40].contiguous())
        assert len(calls) == 4
        want = port.trunk(vgg_stem_plain(x, *_stem_args(port)),
                          stem_done=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_training_dispatches_only_with_a_frozen_stem(rng, monkeypatch,
                                                     calls):
    monkeypatch.setenv("WSSDL_FUSED_STEM", "1")
    model = he_init_(build_detector("VGGnet_train", device="cpu"), 3)
    assert model.training and stem_is_frozen(model)
    x = torch.from_numpy(rng.randn(1, 32, 48, 3).astype(np.float32))
    model.apply_trunk(x, stem_frozen=stem_is_frozen(model))
    assert calls == ["vgg_stem_fused"]
    model.apply_trunk(x, stem_frozen=False)
    assert len(calls) == 1
    # an unfrozen conv1: the Engine's training trunk runs the library stem
    # with real gradients
    model.trunk.backbone.conv1_1.requires_grad_(True)
    assert not stem_is_frozen(model)
    eng = Engine(model, Config(), (32, 48), device="cpu")
    model.train()
    feat = eng._train_trunk(x)[0]
    assert len(calls) == 1
    feat.sum().backward()
    assert model.trunk.backbone.conv1_1.conv.weight.grad is not None
    # in eval mode the stem dispatches whatever the freezing
    model.eval()
    with torch.no_grad():
        model.apply_trunk(x, stem_frozen=False)
    assert calls == ["vgg_stem_fused"] * 2
    assert stem_is_frozen(freeze_vgg_stem(model))
