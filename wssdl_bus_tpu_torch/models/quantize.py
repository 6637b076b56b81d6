"""Post-training int8 quantization for serving (counterpart of
``wssdl_bus_tpu/models/quantize.py``): the VGG16 trunk, and the ResNet
trunk + per-ROI group3 head.

Scheme, as in the JAX package: symmetric linear quantization, weights per
output channel (``s_w[o] = absmax(K[..., o]) / 127``, quantized once,
offline), activations per tensor from a calibration pass (``s_x = absmax /
127`` over a calibration set; a 2x2 max-pool of ReLU outputs keeps the
tensor's absmax, so the recorded output absmax of VGG16's conv ``i`` is the
input absmax of conv ``i+1``).  Each quantized layer computes ``[relu](
acc * (s_x * s_w) + b)`` with the int32 accumulator of an s8 x s8 conv;
everything after it is f32, and the chain requantizes into the next
layer's scale.  The RPN convs, the VGG16 fc head and the ResNet head's
dense layers are not quantized: the int8 path runs the model's own modules
for them (``TrunkRPN.heads``, ``cls_score`` / ``bbox_pred``), so the
quantized tree holds only the int8 layers and the unfolded norms.  As in
the JAX package, the RPN convs and the ResNet dense layers run in f32 from
the f32 weights whatever the model's compute dtype; the VGG16 fc head
follows it.  All detection geometry stays f32.  ResNet folds the
serving-mode BatchRenorm of each conv into its dequant scale and bias;
the standalone preact norms stay f32 affines; GroupNorm (data-dependent
at serving time) is rejected.

The int8 conv is the CUDA kernel ``csrc/int8_conv.cu``
(``ops/int8_conv_cuda.py:int8_conv``; its plain version
``ops/int8_conv.py:int8_conv_plain`` on CPU tensors, or everywhere for a
``plain_ops`` engine).  Where a conv's output reaches the next int8 conv
only, through nothing but max-pools, the kernel runs that conv's quantize
step in its epilogue (``out_scale``: the next layer's ``in_scale``) and
hands it int8; a max-pool commutes with ``clamp(round(. / s))``, which is
monotone, so the step's result is the JAX package's bit for bit (it pools
in f32, then quantizes).  Those int8 hand-offs:

  * VGG16: conv1_1 ... conv5_2, 12 of 13 (the 2x2 pools after conv1_2,
    conv2_2, conv3_3 and conv4_3 run on the int8 codes); conv5_3 stays f32
    (it feeds the RPN and the ROI pool).
  * ResNet: the conv1 of each basic block (-> conv2), conv1 and conv2 of
    each bottleneck (-> conv2, -> conv3): 8 of 20 convs in ResNet-18, 32 of
    53 in ResNet-50 (:func:`_walk_block`'s ``feeds``).  Every other conv
    stays f32: conv0 (its pooled output feeds a residual add), the last
    conv of each block and the shortcuts (residual adds), and whatever
    goes through a preact norm.

The other quantize steps (the network input, and after a preact norm or a
residual add) and the f32 max-pool after conv0 are PyTorch elementwise
ops, as they are XLA's in the JAX package.  Activations are
NHWC throughout, the JAX package's layout; the quantized tree
(``quantize_vgg_trunk`` / ``quantize_resnet``) holds tensors on the
device the serving engine runs on, each int8 kernel packed once into the
layout the kernel reads (``ops/int8_conv.py:pack_weight``) beside its
square kernel size ``k``.

The ResNet structure is walked by one set of functions (``_walk_*``)
shared by the f32 walk (calibration, and the reference the tests hold
against ``models/resnet.py``) and the int8 walk, with the reference's
pre-activation shortcut quirk, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wssdl_bus_tpu_torch.models.resnet import RESNET_DEFS
from wssdl_bus_tpu_torch.ops.int8_conv import (conv_pads, int8_conv_plain,
                                               pack_weight, quantize)

# (conv name, 2x2 VALID max-pool after it): the VGG16Backbone chain
VGG_LAYERS = (
    ("conv1_1", False), ("conv1_2", True),
    ("conv2_1", False), ("conv2_2", True),
    ("conv3_1", False), ("conv3_2", False), ("conv3_3", True),
    ("conv4_1", False), ("conv4_2", False), ("conv4_3", True),
    ("conv5_1", False), ("conv5_2", False), ("conv5_3", False),
)


def _int8_conv_fn(plain: bool):
    """The int8 conv a walk runs: the kernel wrapper (which takes the plain
    version itself for CPU tensors) or, for ``plain_ops``, the plain
    version on any device."""
    if plain:
        return int8_conv_plain
    from wssdl_bus_tpu_torch.ops.int8_conv_cuda import int8_conv
    return int8_conv


def _conv_f32(x, weight, stride: int = 1):
    """f32 conv of NHWC ``x`` with an OIHW ``weight``, TF "SAME" padding,
    no bias -> NHWC."""
    xc = x.permute(0, 3, 1, 2)
    k = weight.shape[2]
    (t, b), (lf, rt), _ = conv_pads(x.shape[1], x.shape[2], k, k, stride)
    pad = (t, lf)
    if (t, lf) != (b, rt):
        xc, pad = F.pad(xc, (lf, rt, t, b)), 0
    return F.conv2d(xc, weight, None, stride, pad).permute(0, 2, 3, 1)


def _max_pool(x, k: int, s: int):
    """k x k VALID max-pool at stride s of NHWC ``x``; int8 ``x`` (2x2 at
    stride 2 only; PyTorch's CUDA max-pool takes no int8) as the maximum
    of the row pairs, then of the column pairs, the odd last row and
    column cropped."""
    if x.dtype != torch.int8:
        return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)
    if (k, s) != (2, 2):
        raise ValueError(f"int8 max-pool: 2x2 at stride 2 only, not {k}/{s}")
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    rows = torch.maximum(x[:, 0::2], x[:, 1::2])
    return torch.maximum(rows[:, :, 0::2], rows[:, :, 1::2])


def _absmax(x) -> float:
    return float(x.abs().max())


def _check_absmaxes(scales: dict) -> dict:
    for k, v in scales.items():
        if v <= 0.0:
            raise ValueError(f"calibration absmax for {k!r} is {v}; the "
                             "calibration set never activated this layer")
    return scales


def _quantize_kernel(weight, in_scale):
    """An OIHW f32 conv weight -> (int8 HWIO, f32 w_scale [Cout]), the JAX
    package's numpy arithmetic: ``w_scale = max(absmax, tiny) / 127``,
    ``clip(round(k / w_scale))``."""
    kernel = weight.detach().permute(2, 3, 1, 0).to("cpu", torch.float32) \
        .numpy()
    w_absmax = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)),
                          np.finfo(np.float32).tiny)
    w_scale = (w_absmax / 127.0).astype(np.float32)
    qkernel = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
    return qkernel, w_scale


def qlayer(qkernel: np.ndarray, scale, bias, in_scale, device) -> dict:
    """One quantized conv on ``device`` from its int8 HWIO kernel: the
    packed kernel, its size ``k``, the fused dequant ``scale`` and ``bias``
    [Cout] and the input scale (a 0-d tensor, so the quantize step divides
    on the device)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"qkernel": pack_weight(torch.from_numpy(np.ascontiguousarray(
                qkernel))).to(device),
            "k": int(qkernel.shape[0]),
            "scale": torch.as_tensor(np.array(scale, np.float32), **f32),
            "bias": torch.as_tensor(np.array(bias, np.float32), **f32),
            "in_scale": torch.as_tensor(np.float32(in_scale), **f32)}


def _int8_layer(conv, x, layer: dict, stride: int, relu: bool,
                feeds: dict | None = None):
    """[quantize ->] int8 conv (+ the epilogue) of NHWC ``x``: f32 ``x`` is
    quantized into the layer's ``in_scale`` (an int8 ``x`` already is, by
    the conv before it); with ``feeds`` (the next layer) the output is that
    layer's int8 input."""
    xq = x if x.dtype == torch.int8 else quantize(x, layer["in_scale"])
    return conv(xq.contiguous(), layer["qkernel"], layer["k"], layer["k"],
                layer["scale"], layer["bias"], stride, relu,
                None if feeds is None else feeds["in_scale"])


# --------------------------------------------------------------------- #
# VGG16: the trunk
# --------------------------------------------------------------------- #
@torch.no_grad()
def calibrate_vgg_trunk(model, batches) -> dict:
    """Per-conv-input absmaxes over ``batches`` (an iterable of [B, H, W, 3]
    serving blobs, numpy or tensors), from the model's own backbone convs
    in eval mode (in its compute dtype, as the JAX package captures its
    trunk's ConvBlock outputs): ``{"data": m, "conv1_1": m, ...}``, each the
    recorded ABSMAX of the network input or of a conv's (ReLU) output, the
    input of the next conv in the chain."""
    backbone = model.trunk.backbone
    dev = next(model.parameters()).device
    scales: dict = {}
    for data in batches:
        x = torch.as_tensor(data, dtype=torch.float32, device=dev)
        m = {"data": _absmax(x)}
        x = x.permute(0, 3, 1, 2)   # the channels_last view the convs take
        for name, pool in VGG_LAYERS:
            x = getattr(backbone, name)(x)
            m[name] = _absmax(x)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        for k, v in m.items():
            scales[k] = max(scales.get(k, 0.0), v)
    return _check_absmaxes(scales)


@torch.no_grad()
def quantize_vgg_trunk(model, act_scales: dict, device=None) -> dict:
    """Quantize the VGG16 trunk offline -> the serving tree
    ``{"layers": [per conv: qkernel, k, scale, bias, in_scale]}`` on
    ``device`` (the model's by default)."""
    trunk = model.trunk
    device = device or next(model.parameters()).device
    layers = []
    prev = "data"
    for name, _ in VGG_LAYERS:
        conv = getattr(trunk.backbone, name).conv
        in_scale = np.float32(act_scales[prev] / 127.0)
        qkernel, w_scale = _quantize_kernel(conv.weight, in_scale)
        bias = conv.bias.detach().to("cpu", torch.float32).numpy()
        layers.append(qlayer(qkernel, in_scale * w_scale, bias, in_scale,
                              device))
        prev = name
    return {"layers": layers}


def _rpn(model, feat):
    """The model's RPN convs (``TrunkRPN.heads``, eval mode) in f32 over the
    NHWC int8 trunk's ``feat`` -> (feat, rpn_cls_score, rpn_bbox_pred),
    NHWC f32."""
    return model.trunk.heads(feat.contiguous().permute(0, 3, 1, 2), f32=True)


@torch.no_grad()
def quant_trunk_apply(model, qtrunk: dict, data, plain: bool = False):
    """The int8 VGG16 trunk + the model's RPN convs over the [B, H, W, 3]
    blob -> (feat, rpn_cls_score, rpn_bbox_pred), NHWC f32: the drop-in for
    ``FasterRCNN.apply_trunk`` in eval mode.  ``plain``: the int8 conv's
    plain version instead of the kernel."""
    conv = _int8_conv_fn(plain)
    layers = qtrunk["layers"]
    x = data
    for (_, pool), layer, feeds in zip(VGG_LAYERS, layers,
                                       layers[1:] + [None]):
        x = _int8_layer(conv, x, layer, 1, True, feeds)
        if pool:
            x = _max_pool(x, 2, 2)
    return _rpn(model, x)


class QuantServingEngine:
    """The serving surface of ``train/engine.py:Engine`` (``cfg``,
    ``canvas_hw``, ``device``, ``inference_step``) with the int8 model
    swapped in, so ``evaluate/detect.py:test_net`` / ``im_detect_batch``
    evaluate the quantized model unchanged (``main/test.py --int8``)."""

    def __init__(self, eng, qtrunk: dict):
        self._eng = eng
        self._qtrunk = qtrunk
        self.cfg = eng.cfg
        self.canvas_hw = eng.canvas_hw
        self.device = eng.device

    def inference_step(self, data, im_info):
        return self._eng.inference_step_quant(self._qtrunk, data, im_info)


# --------------------------------------------------------------------- #
# ResNet: trunk AND the per-ROI group3 head
# --------------------------------------------------------------------- #
def _bn_affine(bn, device=None):
    """Serving-mode BatchRenorm -> per-channel (g, c), ``y = x * g + c``,
    on ``device`` (the norm's own by default): ``g = gamma * rsqrt(var +
    eps)``, ``c = beta - mean * gamma * rsqrt(var + eps)``, the JAX
    package's operation order."""
    gamma, beta, mean, var = (
        getattr(bn, k).detach().to(device or bn.gamma.device, torch.float32)
        for k in ("gamma", "beta", "mean", "var"))
    inv = torch.rsqrt(var + bn.epsilon)
    return gamma * inv, beta - mean * gamma * inv


def _module(root, path: str):
    return root.get_submodule(path.replace("/", "."))


class _ResnetF32:
    """The f32 walk's ops over one part's modules (the backbone for the
    trunk, the head module for the head); ``record`` (optional dict)
    collects each conv input's absmax by conv path."""

    def __init__(self, root, norm, record=None):
        self.root, self.norm, self.rec = root, norm, record

    def conv(self, path, x, stride, relu, feeds=None):
        if self.rec is not None:
            self.rec[path] = x.abs().max()
        blk = _module(self.root, path)
        y = _conv_f32(x, blk.conv.weight, stride)
        if self.norm == "BN":
            g, c = _bn_affine(blk.bn)
            y = y * g + c
        else:
            y = y + blk.conv.bias
        return torch.relu(y) if relu else y

    def prenorm(self, path, x):
        """Standalone norm + ReLU (block preact, group2_norm / group3_norm);
        no norm when norm is None."""
        if self.norm == "BN":
            g, c = _bn_affine(_module(self.root, path))
            x = x * g + c
        return torch.relu(x)


class _ResnetInt8:
    """The int8 walk's ops over a quantized part from
    :func:`quantize_resnet_part`."""

    def __init__(self, qpart, norm, plain: bool = False):
        self.q, self.norm = qpart, norm
        self._conv = _int8_conv_fn(plain)

    def conv(self, path, x, stride, relu, feeds=None):
        """``feeds``: the path of the conv that alone takes this output,
        which is then written as its int8 input."""
        layers = self.q["layers"]
        return _int8_layer(self._conv, x, layers[path], stride, relu,
                           None if feeds is None else layers[feeds])

    def prenorm(self, path, x):
        if self.norm == "BN":
            a = self.q["norms"][path]
            x = x * a["g"] + a["c"]
        return torch.relu(x)


def _walk_block(ops, x, bpath, features, stride, preact, kind):
    """``models/resnet.py:_Block`` (network.py:424-457), the shortcut
    quirk included: in "both_preact" blocks the shortcut takes the
    normalised input, in "default" blocks the input before the preact.
    Each conv whose output only the next conv takes names it (``feeds``):
    the int8 walk hands that conv int8."""
    c_in = x.shape[-1]
    if preact == "both_preact":
        x = ops.prenorm(f"{bpath}/preact_prev", x)
        x_ori = x
    elif preact != "no_preact":
        x_ori = x
        x = ops.prenorm(f"{bpath}/preact_prev", x)
    else:
        x_ori = x
    if kind == "basic":
        y = ops.conv(f"{bpath}/conv1", x, stride, relu=True,
                     feeds=f"{bpath}/conv2")
        y = ops.conv(f"{bpath}/conv2", y, 1, relu=False)
        c_out = features
    else:
        y = ops.conv(f"{bpath}/conv1", x, 1, relu=True,
                     feeds=f"{bpath}/conv2")
        y = ops.conv(f"{bpath}/conv2", y, stride, relu=True,
                     feeds=f"{bpath}/conv3")
        y = ops.conv(f"{bpath}/conv3", y, 1, relu=False)
        c_out = features * 4
    if c_in != c_out:
        sc = ops.conv(f"{bpath}/convshortcut", x_ori, stride, relu=False)
    else:
        sc = x_ori
    return y + sc


def _walk_group(ops, x, gpath, features, count, stride, first, kind):
    x = _walk_block(ops, x, f"{gpath}/block0", features, stride,
                    "no_preact" if first else "both_preact", kind)
    for i in range(1, count):
        x = _walk_block(ops, x, f"{gpath}/block{i}", features, 1,
                        "default", kind)
    return x


def _walk_resnet_trunk(ops, data, depth):
    defs, kind = RESNET_DEFS[depth]
    x = ops.conv("conv0", data, 2, relu=True)
    x = _max_pool(x, 3, 2)
    x = _walk_group(ops, x, "group0", 64, defs[0], 1, True, kind)
    x = _walk_group(ops, x, "group1", 128, defs[1], 2, False, kind)
    x = _walk_group(ops, x, "group2", 256, defs[2], 2, False, kind)
    return ops.prenorm("group2_norm", x)


def _walk_resnet_head_group(ops, roi_feats, depth):
    defs, kind = RESNET_DEFS[depth]
    x = _walk_group(ops, roi_feats, "group3", 512, defs[3], 2, False, kind)
    return ops.prenorm("group3_norm", x)


def _resnet_conv_paths(depth, part):
    """One part's conv paths in execution order.  A block0 has a
    convshortcut only where its channel count changes (basic
    group0/block0, 64 -> 64, has none)."""
    defs, kind = RESNET_DEFS[depth]
    mult = 1 if kind == "basic" else 4
    names = ("conv1", "conv2") if kind == "basic" else \
        ("conv1", "conv2", "conv3")
    paths = []
    if part == "trunk":
        paths.append("conv0")
        c_in = 64
        groups = [("group0", defs[0], 64), ("group1", defs[1], 128),
                  ("group2", defs[2], 256)]
    else:
        c_in = 256 * mult  # group2's output feeds the ROI head
        groups = [("group3", defs[3], 512)]
    for gpath, count, features in groups:
        c_out = features * mult
        for i in range(count):
            paths += [f"{gpath}/block{i}/{n}" for n in names]
            if i == 0 and c_in != c_out:
                paths.append(f"{gpath}/block0/convshortcut")
        c_in = c_out
    return paths


def _resnet_norm_paths(depth, part):
    """One part's standalone (unfolded) norm paths."""
    defs, _ = RESNET_DEFS[depth]
    if part == "trunk":
        groups = [("group0", defs[0], True), ("group1", defs[1], False),
                  ("group2", defs[2], False)]
        extra = ["group2_norm"]
    else:
        groups = [("group3", defs[3], False)]
        extra = ["group3_norm"]
    paths = []
    for gpath, count, first in groups:
        for i in range(count):
            if i == 0 and first:
                continue  # group0/block0 is no_preact
            paths.append(f"{gpath}/block{i}/preact_prev")
    return paths + extra


def check_int8_norm(norm):
    if norm not in (None, "BN"):
        raise NotImplementedError(
            f"int8 ResNet serving supports norm None/'BN', not {norm!r} "
            "(GroupNorm is data-dependent at serving time and cannot be "
            "folded)")


@torch.no_grad()
def calibrate_resnet(model, batches, spatial_scale: float = 1.0 / 16.0,
                     pool=None) -> dict:
    """Per-conv-input absmaxes of the trunk AND the head, from the f32
    walk.  ``batches`` iterates [B, H, W, 3] serving blobs; the head sees
    the ROI-pooled features of one full-image box per image, pooled by
    ``pool`` (default ``ops/roi_pool_cuda.py:roi_pool_grouped``, kernel #3)
    at ``spatial_scale``, the serving head's geometry."""
    check_int8_norm(model.norm)
    if pool is None:
        from wssdl_bus_tpu_torch.ops.roi_pool_cuda import roi_pool_grouped
        pool = roi_pool_grouped
    depth = model.depth
    dev = next(model.parameters()).device
    scales: dict = {}
    for data in batches:
        data = torch.as_tensor(data, dtype=torch.float32, device=dev)
        b, h, w, _ = data.shape
        rois = torch.tensor([[0.0, 0.0, w - 1.0, h - 1.0]],
                            device=dev).repeat(b, 1, 1)
        rec: dict = {}
        feat = _walk_resnet_trunk(
            _ResnetF32(model.trunk.backbone, model.norm, rec), data, depth)
        pooled = pool(feat.contiguous(), rois, 7, 7, spatial_scale)
        pooled = pooled.reshape(-1, 7, 7, feat.shape[-1])
        _walk_resnet_head_group(_ResnetF32(model.head, model.norm, rec),
                                pooled, depth)
        for k, v in rec.items():
            scales[k] = max(scales.get(k, 0.0), float(v))
    return _check_absmaxes(scales)


def _affine_np(bn):
    """``_bn_affine`` on the CPU, as numpy f32: quantization is offline and
    must not depend on the serving device's rsqrt."""
    return tuple(t.numpy() for t in _bn_affine(bn, "cpu"))


@torch.no_grad()
def quantize_resnet_part(root, norm, depth, part, act_scales: dict,
                         device) -> dict:
    """Quantize one part's convs offline, folding each conv's serving-mode
    BatchRenorm into its dequant scale and bias -> {"layers": {path:
    layer}, "norms": {path: {"g", "c"}}}."""
    layers = {}
    for path in _resnet_conv_paths(depth, part):
        blk = _module(root, path)
        in_scale = np.float32(act_scales[path] / 127.0)
        qkernel, w_scale = _quantize_kernel(blk.conv.weight, in_scale)
        scale = in_scale * w_scale
        if norm == "BN":
            g, c = _affine_np(blk.bn)
            scale = scale * g
            bias = c
        else:
            bias = blk.conv.bias.detach().to("cpu", torch.float32).numpy()
        layers[path] = qlayer(qkernel, scale, bias, in_scale, device)
    norms = {}
    if norm == "BN":
        for path in _resnet_norm_paths(depth, part):
            g, c = _affine_np(_module(root, path))
            norms[path] = {"g": torch.from_numpy(g).to(device),
                           "c": torch.from_numpy(c).to(device)}
    return {"layers": layers, "norms": norms}


@torch.no_grad()
def quantize_resnet(model, act_scales: dict, device=None) -> dict:
    """Quantize trunk + head -> the serving tree of
    :func:`quant_resnet_trunk_apply` / :func:`quant_resnet_head_apply`,
    ``{"trunk": part, "head": part}``; the RPN convs and the dense layers
    stay the model's own."""
    norm, depth = model.norm, model.depth
    check_int8_norm(norm)
    device = device or next(model.parameters()).device
    return {
        "trunk": quantize_resnet_part(model.trunk.backbone, norm, depth,
                                      "trunk", act_scales, device),
        "head": quantize_resnet_part(model.head, norm, depth, "head",
                                     act_scales, device),
    }


@torch.no_grad()
def quant_resnet_trunk_apply(model, q: dict, data, plain: bool = False):
    """int8 trunk + the model's RPN convs -> (feat, rpn_cls_score,
    rpn_bbox_pred), NHWC f32: the drop-in for the ResNet
    ``FasterRCNN.apply_trunk`` in eval mode."""
    feat = _walk_resnet_trunk(_ResnetInt8(q["trunk"], model.norm, plain),
                              data, model.depth)
    return _rpn(model, feat)


@torch.no_grad()
def quant_resnet_head_apply(model, q: dict, pooled, plain: bool = False):
    """int8 group3 head on [N, 7, 7, C], the mean, then the model's dense
    layers in f32 -> (cls_score, bbox_pred), f32: the drop-in for
    ``ResNetRCNNHead`` in eval mode."""
    x = _walk_resnet_head_group(_ResnetInt8(q["head"], model.norm, plain),
                                pooled, model.depth)
    x = x.mean(dim=(1, 2))
    head = model.head
    return head.cls_score(x, f32=True), head.bbox_pred(x, f32=True)
