"""The bf16 compute dtype (``models/layers.py``: ``ConvBlock`` / ``Fc``
``compute_dtype``; ``build_detector(compute_dtype=)``, ``--bf16``) against
the JAX package's ``compute_dtype_scope`` (``wssdl_bus_tpu/models/
layers.py:31-57``) on the CPU, from the same weights.

Tolerances, each set from its readings (this file's seeds, the same at 1,
2 and 4 threads), each with an f32 control that must fail it.
  * Single layers (a ConvBlock, an Fc): within ``LAYER_REL`` = 1e-5 of the
    output's max (measured: 0 to 2.09e-7; both sides round the same f32
    sums to bf16, so the gap is the norms' f32 arithmetic).  The same layer
    in f32 misses the JAX bf16 output by 2.9e-3 to 3.8e-3 of its max.
  * Chains (the trunk and head, the serving step's logits): bf16 rounding
    flips one ulp where the two frameworks' f32 sums straddle a rounding
    boundary, and the flips compound, so the bf16 outputs are about as far
    from each other's (measured: at most 0.913% of the max) as the f32
    model is from either (0.40% to 0.99%).  They are held to
    ``CHAIN_REL`` = 2e-2 of the max, and by what only bf16 compute gives:
    at least ``EQ_MIN`` = 0.05 of the JAX output's nonzero elements are
    met exactly (measured: 0.149 to 1.0), where the f32 model meets none
    (measured: 0.000 for every output).
  * The serving step's class probabilities: equal to the JAX package's
    bf16 step (measured: 0; this initialisation gives near-zero logits) and
    within ``tests/test_mixed_precision.py``'s 0.05 of the port's f32
    step; its logits are held as a chain."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_engine import CANVAS, synth_batch, tiny_cfg
from tests.test_torch_resnet_model import _perturbed
from wssdl_bus_tpu.models import layers as JL
from wssdl_bus_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from wssdl_bus_tpu.models.detector import build_detector as jax_build
from wssdl_bus_tpu.train.engine import Engine as JaxEngine
from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.models import detector
from wssdl_bus_tpu_torch.models.convert import (he_tree, params_from_jax,
                                                params_to_jax)
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.models.layers import ConvBlock, Fc, set_compute_dtype
from wssdl_bus_tpu_torch.ops import conv2_pool
from wssdl_bus_tpu_torch.train.engine import Engine

BF16 = torch.bfloat16
LAYER_REL = 1e-5
CHAIN_REL = 2e-2
EQ_MIN = 0.05


def _gaps(got, want):
    """-> (max |got - want| over max |want|, the share of ``want``'s nonzero
    elements that ``got`` equals exactly)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().detach().numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    nz = want != 0
    return (np.abs(got - want).max() / np.abs(want).max(),
            (got[nz] == want[nz]).mean())


def _layer_close(got, want):
    return _gaps(got, want)[0] <= LAYER_REL


def _chain_close(got, want):
    gap, eq = _gaps(got, want)
    return gap <= CHAIN_REL and eq >= EQ_MIN


@pytest.mark.parametrize("kernel,stride,norm,relu", [
    (3, 1, None, True),        # a VGG16 conv
    (7, 2, "BN", True),        # conv0, asymmetric pads at stride 2
    (3, 2, "GN", False),
    (1, 1, "BN", False),
])
def test_conv_block_bf16_matches_jax(kernel, stride, norm, relu):
    """Eval mode (BatchRenorm's running statistics, positive variances)."""
    rng = np.random.RandomState(kernel + stride)
    x = rng.randn(2, 16, 20, 8).astype(np.float32)
    jblock = JL.ConvBlock(16, kernel, stride, norm=norm, relu=relu,
                          train=False)
    v = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.abs(rng.randn(*a.shape)) + 0.5
                         if path[-1].key in ("var", "gamma") else
                         rng.randn(*a.shape) * 0.2).astype(np.float32), v)
    with JL.compute_dtype_scope("bfloat16"):
        want = jblock.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    port = ConvBlock(8, 16, kernel, stride=stride, norm=norm, relu=relu,
                     gn_params=(8, 4))
    sd = {"conv.weight": torch.tensor(
        tree["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))}
    if norm is None:
        sd["conv.bias"] = torch.tensor(tree["params"]["conv"]["bias"])
    else:
        name = {"BN": "bn", "GN": "gn"}[norm]
        for coll in ("params", "batch_stats"):
            for k, a in tree.get(coll, {}).get(name, {}).items():
                sd[f"{name}.{k}"] = torch.tensor(a)
    port.load_state_dict(sd)
    port.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    set_compute_dtype(port, BF16)
    with torch.no_grad():
        got = port(xt)
    # the chain's dtype: bf16 out of a bare conv, f32 out of a norm
    assert got.dtype == (BF16 if norm is None else torch.float32)
    assert want.dtype == (jnp.bfloat16 if norm is None else jnp.float32)
    assert _layer_close(got.permute(0, 2, 3, 1), want), _gaps(
        got.permute(0, 2, 3, 1), want)
    set_compute_dtype(port, None)           # the control: f32 compute
    with torch.no_grad():
        ctl = port(xt)
    assert not _layer_close(ctl.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("relu", [True, False])
def test_fc_bf16_matches_jax(relu):
    rng = np.random.RandomState(3)
    x = rng.randn(5, 7, 7, 4).astype(np.float32)
    jfc = JL.Fc(12, relu=relu, train=False)
    with JL.compute_dtype_scope("bfloat16"):
        v = jfc.init(jax.random.PRNGKey(1), jnp.asarray(x))
        v = jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32) * 0.1), v)
        want = jfc.apply(v, jnp.asarray(x))
    d = jax.tree.map(np.asarray, v)["params"]["dense"]
    port = Fc(196, 12, relu=relu)
    port.load_state_dict({"dense.weight": torch.tensor(d["kernel"].T),
                          "dense.bias": torch.tensor(d["bias"])})
    set_compute_dtype(port, BF16)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _layer_close(got, want), _gaps(got, want)
    set_compute_dtype(port, None)           # the control: f32 compute
    with torch.no_grad():
        ctl = port(torch.from_numpy(x))
    assert not _layer_close(ctl, want)


@pytest.mark.parametrize("backbone", ["VGGnet", "Resnet"])
def test_trunk_and_head_bf16_match_jax(backbone):
    """The whole trunk and head in bf16 against the JAX package's, with
    f32 at both boundaries on both sides."""
    torch.set_num_threads(2)
    kw = dict(depth=18, norm="BN") if backbone == "Resnet" else {}
    jm = JaxFasterRCNN(backbone=backbone, compute_dtype="bfloat16",
                       remat=False, **kw)
    tree = jax.tree.map(np.asarray, jm.init_variables(jax.random.PRNGKey(0),
                                                      (64, 64)))
    he = he_tree(tree, 2, input_scale=64.0 if backbone == "VGGnet" else 1.0)
    if backbone == "Resnet":
        he = _perturbed(he, 2)
    jv = jax.tree.map(jnp.asarray, he)
    port = build_detector(f"{backbone}_test", device="cpu",
                          compute_dtype=BF16, **kw)
    port.load_state_dict(params_from_jax(he))
    rng = np.random.RandomState(2)
    data = rng.randn(2, 64, 64, 3).astype(np.float32) * (
        64.0 if backbone == "VGGnet" else 1.0)
    want = jm.apply_trunk(jv, jnp.asarray(data), train=False)[:3]
    c = np.asarray(want[0]).shape[-1]
    pooled = np.abs(rng.randn(6, 7, 7, c)).astype(np.float32)
    if backbone == "VGGnet":
        pooled = pooled.reshape(6, -1)
    want += tuple(jm.apply_head(jv, jnp.asarray(pooled), train=False)[:2])
    for dt in (BF16, None):                 # None: the f32 control
        set_compute_dtype(port, dt)
        with torch.no_grad():
            got = port.apply_trunk(torch.from_numpy(data)) \
                + port.apply_head(torch.from_numpy(pooled))
        for g, w in zip(got, want, strict=True):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            assert _chain_close(g, w) == (dt == BF16), (dt, _gaps(g, w))


def test_bf16_serving_and_train_step():
    """tests/test_mixed_precision.py's checks on the port: the bf16 serving
    step's boundary outputs are f32, its ROIs and class probabilities equal
    the JAX package's bf16 step and its probabilities are within 0.05 of the
    port's f32 step; its logits and box deltas meet the JAX bf16 step's as a
    chain does, and the f32 step's do not; a bf16 training step gives
    finite losses and keeps f32 parameters."""
    torch.set_num_threads(2)
    cfg = tiny_cfg()
    e32 = JaxEngine(jax_build("VGGnet_train"), cfg, CANVAS, num_ws=0)
    e16 = JaxEngine(jax_build("VGGnet_train", compute_dtype="bfloat16"),
                    cfg, CANVAS, num_ws=0)
    variables, _ = e32.init(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, variables))
    pcfg = Config().with_overrides([
        "TRAIN.RPN_PRE_NMS_TOP_N", "300", "TRAIN.RPN_POST_NMS_TOP_N", "64",
        "TRAIN.BATCH_SIZE", "32", "TRAIN.RPN_BATCHSIZE", "64",
        "TEST.RPN_PRE_NMS_TOP_N", "200", "TEST.RPN_POST_NMS_TOP_N", "32"])
    engs = {}
    for dt in (None, BF16):
        m = build_detector("VGGnet_train", device="cpu", compute_dtype=dt)
        m.load_state_dict(sd)
        engs[dt] = Engine(m, pcfg, CANVAS, device="cpu", num_ws=0)
    batch = synth_batch(np.random.RandomState(3), 1, 0)
    r16 = engs[BF16].inference_step(batch["data"], batch["im_info"])
    r32 = engs[None].inference_step(batch["data"], batch["im_info"])
    j16 = e16.inference_step(variables, batch["data"], batch["im_info"])
    assert all(r16[i].dtype == torch.float32 for i in (0, 2, 3, 4))
    np.testing.assert_array_equal(r16[1].numpy(), np.asarray(j16[1]))
    np.testing.assert_array_equal(r16[0].numpy(), np.asarray(j16[0]))
    np.testing.assert_array_equal(r16[3].numpy(), np.asarray(j16[3]))
    np.testing.assert_allclose(r16[3].numpy(), r32[3].numpy(), atol=0.05)
    for i in (2, 4):                        # cls_score, bbox_pred
        assert _chain_close(r16[i], j16[i]), _gaps(r16[i], j16[i])
        assert not _chain_close(r32[i], j16[i])

    eng = engs[BF16]
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    ls = eng.train_step(batch, 1e-3, 0)
    for name, v in zip(ls._fields, ls):
        assert torch.isfinite(v).all(), name
    after = eng.model.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert "trunk.backbone.conv3_1.conv.weight" in moved
    assert "trunk.backbone.conv1_1.conv.weight" not in moved   # frozen


def test_tail_gate_closed_under_bf16(monkeypatch):
    """The stem tail (#7) dispatches only on the f32 compute dtype
    (``wssdl_bus_tpu/models/detector.py:198``); the fused stem (#6) is not
    gated by the dtype.  The CUDA gates are forced open on the CPU."""
    monkeypatch.setattr(conv2_pool, "_device_ok", lambda device: True)
    from wssdl_bus_tpu_torch.ops import conv1
    monkeypatch.setattr(conv1, "_device_ok", lambda device: True)
    seen = []
    for name in ("vgg_conv2_pool", "vgg_stem_fused"):
        fn = getattr(detector, name)

        @functools.wraps(fn)
        def spy(*a, _fn=fn, _name=name, **k):
            seen.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(detector, name, spy)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 32, 48, 3)
                         .astype(np.float32))
    m32 = build_detector("VGGnet_test", device="cpu")
    m16 = build_detector("VGGnet_test", device="cpu", compute_dtype=BF16)
    m16.load_state_dict(m32.state_dict())
    monkeypatch.setenv("WSSDL_STEM_TAIL", "1")
    with torch.no_grad():
        m32.apply_trunk(x)
        assert seen == ["vgg_conv2_pool"]
        out = m16.apply_trunk(x)
        assert seen == ["vgg_conv2_pool"]          # gated off under bf16
        assert all(t.dtype == torch.float32 for t in out)
        monkeypatch.setenv("WSSDL_FUSED_STEM", "1")
        m16.apply_trunk(x)
        assert seen == ["vgg_conv2_pool", "vgg_stem_fused"]


def test_compute_dtype_round_trips_through_state_dict():
    """The dtype is an attribute, not a parameter: a bf16 model's state
    dict is the f32 one's (snapshots and converted weights load into
    either)."""
    m16 = build_detector("Resnet_test", device="cpu", depth=18, norm="BN",
                         compute_dtype=BF16)
    m32 = build_detector("Resnet_test", device="cpu", depth=18, norm="BN")
    assert m16.compute_dtype == BF16 and m32.compute_dtype is None
    sd16, sd32 = m16.state_dict(), m32.state_dict()
    assert sd16.keys() == sd32.keys()
    assert all(v.dtype == torch.float32 for v in sd16.values())
    m32.load_state_dict(sd16)
    tree = params_to_jax(sd16)
    assert set(tree) == {"trunk", "head"}
    convs = [m for m in m16.modules() if isinstance(m, (ConvBlock, Fc))]
    assert convs and all(m.compute_dtype == BF16 for m in convs)
