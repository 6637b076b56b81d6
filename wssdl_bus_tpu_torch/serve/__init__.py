"""Deployment: the serving artifact, and the report shared by the predict
CLI and the HTTP server (counterpart of ``wssdl_bus_tpu/serve/__init__.py``).

The artifact's format departs from the JAX package's.  That package
exports one StableHLO program per batch size and restores it without the
model-building code.  The port's kernels load through ctypes
(``ops/_build.py``), which ``torch.export`` cannot trace, so a port
artifact holds no program: it holds the weights and the config, and
:func:`load_serving` rebuilds the detector with
``models/detector.py:build_detector`` and serves it through
``train/engine.py:Engine`` (f32 or bf16 compute) or
``models/quantize.py:QuantServingEngine`` (int8).  Layout (a directory)::

    meta.json     the JAX package's keys (format, net_name, backbone,
                  num_classes, canvas_hw, batch_sizes, platform, quantized,
                  config), torch_version in place of jax_version, and the
                  port's net_depth, norm_type and compute_dtype
    variables.pt  torch.save of {"state_dict": ..., "qtrunk": ... or None}

``platform`` is the device type the artifact was exported on (``cuda`` /
``cpu``); with no compiled program in it, an artifact loads on either.  The
exported batch sizes keep their meaning: :meth:`ServingModel.
inference_step` refuses any other, and :meth:`ServingModel.detect` pads a
request to the smallest one that fits.

An int8 artifact (``export_serving(calib_batches=...)``) ships the int8
tree of ``Engine.quantize_for_serving`` and the part of the state dict
that tree does not replace (``models/quantize.py:replaced_state_keys``
names the rest): the RPN convs and the dense layers (VGG16's fc
head, ResNet's ``cls_score`` / ``bbox_pred``), which the int8 path runs
from the model's own modules.  It ships no float copy of a quantized conv
or of a folded norm.  Loaded, the parameters the int8 tree replaces are
filled with NaN, so a path that wrongly read them would show in every
output.

A JAX artifact (``variables.msgpack`` + ``infer_b*.shlo``) is not readable
by the port, as a JAX snapshot is not: carry JAX weights across with
``models/convert.py:params_from_jax`` / ``qtrunk_from_jax``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from wssdl_bus_tpu_torch.config import Config, _flatten
from wssdl_bus_tpu_torch.evaluate.detect import (_decode_packed,
                                                 apply_nms_per_class,
                                                 pack_image_batch)
from wssdl_bus_tpu_torch.models.quantize import replaced_state_keys

_META = "meta.json"
_VARS = "variables.pt"
_FORMAT = 1
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# copy of wssdl_bus_tpu/data/dataset.py CLASSES
CLASS_NAMES = ("__background__", "benign", "malignant")


def _flat_config(cfg: Config) -> dict:
    """Config -> {dotted key: plain value} covering every field."""
    flat = []
    _flatten(dataclasses.asdict(cfg), "", flat)
    return dict(flat)


def _config_from_flat(flat: dict) -> Config:
    """The inverse of :func:`_flat_config`, also after a JSON round trip
    (a list comes back as the tuple the Config holds)."""
    cfg = Config()
    for k, v in flat.items():
        cfg = cfg._set_dotted(k, v)
    return cfg


def export_serving(eng, out_dir: str, net_name: str, batch_sizes=(1,),
                   calib_batches=None) -> dict:
    """Write ``eng``'s model and config as a serving artifact into
    ``out_dir`` for the batch sizes ``batch_sizes``; -> the metadata dict
    (also written to ``meta.json``).

    ``eng`` is a :class:`~wssdl_bus_tpu_torch.train.engine.Engine`; it
    holds its model, so no variables are passed.  With ``calib_batches``
    (an iterable of [B, H, W, 3] serving blobs) the artifact is int8: the
    model is quantized against those activation ranges
    (``eng.quantize_for_serving``) and the int8 tree ships in place of the
    layers it replaces (module docstring)."""
    from wssdl_bus_tpu_torch.train.checkpoint import _to_cpu
    from wssdl_bus_tpu_torch.train.engine import Engine

    if not isinstance(eng, Engine):
        raise TypeError(f"export_serving takes an Engine, not "
                        f"{type(eng).__name__}")
    sizes = sorted({int(b) for b in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch sizes must be >= 1, got {batch_sizes}")
    model = eng.model
    state = _to_cpu(model.state_dict())
    qtrunk = None
    if calib_batches is not None:
        qtrunk = _to_cpu(eng.quantize_for_serving(calib_batches))
        replaced = replaced_state_keys(model)
        state = {k: v for k, v in state.items() if k not in replaced}
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"state_dict": state, "qtrunk": qtrunk},
               os.path.join(out_dir, _VARS))
    h, w = eng.canvas_hw
    resnet = model.backbone == "Resnet"
    meta = {
        "format": _FORMAT,
        "net_name": net_name,
        "backbone": model.backbone,
        "num_classes": model.num_classes,
        "canvas_hw": [int(h), int(w)],
        "batch_sizes": sizes,
        "platform": eng.device.type,
        "torch_version": torch.__version__,
        "quantized": calib_batches is not None,
        "config": _flat_config(eng.cfg),
        "net_depth": model.depth if resnet else None,
        "norm_type": model.norm if resnet else None,
        "compute_dtype": ("bfloat16" if model.compute_dtype == torch.bfloat16
                          else "float32"),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


class ServingModel:
    """A restored serving artifact.

    The Engine serving surface that ``evaluate/detect.py`` reads
    (``cfg``, ``canvas_hw``, ``device``, ``inference_step(data,
    im_info)``), held to the exported batch sizes, and :meth:`detect`.
    ``engine`` is the ``Engine`` or ``QuantServingEngine`` that runs the
    step."""

    def __init__(self, path: str, meta: dict, engine):
        self.path = path
        self.meta = meta
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.canvas_hw = tuple(meta["canvas_hw"])
        self.net_name = meta["net_name"]
        self.batch_sizes = list(meta["batch_sizes"])

    @torch.inference_mode()
    def inference_step(self, data, im_info):
        """The device step at an exported batch size -> (rois5, valid,
        cls_score, cls_prob, bbox_pred) on the device."""
        b = int(np.shape(data)[0])
        if b not in self.batch_sizes:
            raise ValueError(
                f"no exported program for batch size {b}; artifact has "
                f"{self.batch_sizes} (use detect(), which pads, or "
                f"re-export with this batch size)")
        return self.engine.inference_step(data, im_info)

    @torch.inference_mode()
    def detect(self, images):
        """Serve a list of raw numpy images -> list of ``(scores [N, C],
        pred_boxes [N, 4C])`` in original image coordinates (the
        ``im_detect_batch`` contract).  Packs into the smallest exported
        batch size >= len(images), padding with blank canvas slots whose
        ``im_info`` rows are [H, W, 1, 0]; only the real images' rows are
        copied back.  Runs under ``torch.inference_mode`` on the calling
        thread (the HTTP server's batcher calls it from its worker)."""
        n = len(images)
        fits = [b for b in self.batch_sizes if b >= n]
        if not fits:
            raise ValueError(
                f"{n} images exceed the largest exported batch size "
                f"{max(self.batch_sizes)}; split the request or re-export")
        b = min(fits)
        blob, infos, scales = pack_image_batch(self, images, self.net_name,
                                               self.canvas_hw)
        if b > n:
            pad_blob = np.zeros((b, *self.canvas_hw, 3), np.float32)
            pad_blob[:n] = blob
            pad_infos = np.tile(
                np.array([[self.canvas_hw[0], self.canvas_hw[1], 1.0, 0.0]],
                         np.float32), (b, 1))
            pad_infos[:n] = infos
            blob, infos = pad_blob, pad_infos
        outs = self.inference_step(blob, infos)
        p = self.cfg.TEST.RPN_POST_NMS_TOP_N
        # the real images' rows, sliced on the device: _decode_packed
        # copies every row it is given
        outs = [o.reshape(b, p, -1)[:n].reshape(n * p, -1) for o in outs]
        outs[1] = outs[1].reshape(-1)  # valid mask is flat [n*p]
        return _decode_packed(self, images, scales, outs)


def load_gray(src) -> np.ndarray:
    """A request image (a path or a binary file object) -> the 8-bit
    grayscale array the detector takes (RGB, paletted, 16-bit, ...
    converted).  Shared by the predict CLI and the HTTP server."""
    from PIL import Image
    im = Image.open(src)
    if im.mode != "L":
        im = im.convert("L")
    return np.asarray(im)


def report_detections(scores, boxes, cfg, thresh: float = 0.5,
                      class_names=CLASS_NAMES) -> "tuple[list, dict]":
    """(scores [N, C], pred_boxes [N, 4C]) -> ``(entries, kept)``: report
    entries ``{"class", "score", "box"}`` sorted by score, plus the
    per-class ``{class_index: [n, 5]}`` arrays behind them.  Applies the
    reference post-processing (0.05 score floor, per-class NMS, optional
    class-agnostic second pass, test_bus.py:359-386), then the caller's
    report threshold.  Shared by the predict CLI and the HTTP server so
    their outputs cannot drift."""
    dets = apply_nms_per_class(scores, boxes, len(class_names), 0.05,
                               cfg.TEST.NMS,
                               cls_agnostic=cfg.TEST.CLS_AGNOSTIC_NMS)
    kept = {j: dets[j][dets[j][:, 4] >= thresh]
            for j in range(1, len(class_names))}
    out = []
    for j in range(1, len(class_names)):
        for x1, y1, x2, y2, s in kept[j]:
            out.append({"class": class_names[j], "score": float(s),
                        "box": [float(x1), float(y1), float(x2),
                                float(y2)]})
    out.sort(key=lambda d: -d["score"])
    return out, kept


def load_serving(path: str, device=None) -> ServingModel:
    """Restore an :func:`export_serving` artifact directory on ``device``
    (CUDA unless named; raises without a card): the detector rebuilt from
    ``meta.json`` (a GroupNorm ResNet with the config's GN_MIN_NUM_G /
    GN_MIN_CHS_PER_G, as the CLIs build it), its weights loaded, served
    through an ``Engine`` or, for an int8 artifact, a
    ``QuantServingEngine``."""
    from wssdl_bus_tpu_torch.models.detector import build_detector
    from wssdl_bus_tpu_torch.models.quantize import QuantServingEngine
    from wssdl_bus_tpu_torch.train.engine import Engine
    from wssdl_bus_tpu_torch.utils import resolve_device

    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT:
        raise ValueError(f"unknown serving artifact format: "
                         f"{meta.get('format')}")
    dev = resolve_device(device)
    cfg = _config_from_flat(meta["config"])
    backbone = meta["backbone"]
    model = build_detector(
        f"{backbone}_test", num_classes=meta["num_classes"], device=dev,
        depth=meta["net_depth"] or 50, norm=meta["norm_type"],
        gn_params=(cfg.TRAIN.GN_MIN_NUM_G, cfg.TRAIN.GN_MIN_CHS_PER_G),
        compute_dtype=_DTYPES[meta["compute_dtype"]])
    saved = torch.load(os.path.join(path, _VARS), map_location=dev,
                       weights_only=True)
    qtrunk = saved["qtrunk"]
    if qtrunk is None:
        model.load_state_dict(saved["state_dict"])
    else:
        missing, unexpected = model.load_state_dict(saved["state_dict"],
                                                    strict=False)
        replaced = replaced_state_keys(model)
        if unexpected or set(missing) != replaced:
            raise ValueError(
                f"int8 artifact {path}: state dict does not complement the "
                f"int8 tree (unexpected {sorted(unexpected)[:3]}, missing "
                f"outside it {sorted(set(missing) - replaced)[:3]}, "
                f"shipped inside it {sorted(replaced - set(missing))[:3]})")
        state = model.state_dict()
        with torch.no_grad():
            for k in replaced:
                state[k].fill_(float("nan"))
    eng = Engine(model, cfg, meta["canvas_hw"], device=dev)
    return ServingModel(path, meta, eng if qtrunk is None
                        else QuantServingEngine(eng, qtrunk))
