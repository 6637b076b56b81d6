"""ImageNet weight import (counterpart of ``wssdl_bus_tpu/models/
pretrained.py``).

The reference loads a numpy dict-of-dicts ``{scope: {var_name: value}}``
and assigns variable by variable, skipping whatever does not exist or fit
(``network.py:52-66``, ignore_missing=True): the BUS VGG head is 512 wide
where ImageNet's fc6/fc7 are 4096 wide, so those are skipped and trained
from scratch, as in the reference.

The matching works on the flax-layout numpy tree that ``models/convert.py:
params_to_jax`` makes of the port's state dict, with the JAX package's
rules, and the result goes back through ``params_from_jax``:
:func:`load_pretrained_model` does both, running statistics included (the
tree's ``batch_stats`` collection, BatchRenorm's buffers).  Each checkpoint
scope (flat for VGG: ``conv1_1`` ... ``fc7``; slash-nested for ResNet:
``group0/block0/conv1``, ``group2/norm``) is matched by SUFFIX against a
variable's
"semantic path" (its module path without the containers ``conv`` /
``dense`` / ``bn`` / ``gn``, the collection roots and ``backbone``), with
the aliases ``<name>_norm`` == ``<name>/norm`` and ``rpn_conv/3x3`` ==
``rpn_conv``; an ambiguous or missing scope is skipped, never guessed, and
an array whose shape does not fit (after a squeeze: the reference's group
norm stores gamma / beta as [1, 1, 1, C]) is skipped.  ``weights`` /
``biases`` / ``gamma`` / ``beta`` land in ``params``, ``moving_mean`` /
``moving_variance`` (or ``mean`` / ``variance``) in ``batch_stats``; the
``batch_normalization`` segment ``tf.layers.batch_normalization`` inserts
is dropped wherever the scope / variable split puts it.  TF conv kernels
are [kh, kw, cin, cout], flax's layout; dense kernels [cin, cout].

``.pth`` / ``.pt`` files are torchvision ``vgg16`` state dicts, converted by
:func:`torchvision_vgg16_to_reference` with the input normalisation folded
into conv1_1 exactly.  They are VGG16 only, as in the JAX package:
torchvision's resnets are post-activation, the reference's pre-activation.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

# checkpoint var name -> (collection, flax leaf name)
_VAR_MAP = {
    "weights": ("params", "kernel"),
    "biases": ("params", "bias"),
    "gamma": ("params", "gamma"),
    "beta": ("params", "beta"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
    "mean": ("batch_stats", "mean"),
    "variance": ("batch_stats", "var"),
}

_CONTAINERS = {"conv", "dense", "bn", "gn"}
_COLLECTION_ROOTS = {"trunk", "head", "params", "batch_stats"}


def _flatten(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _semantic(path):
    """Module path without collection roots and containers, '_norm' keys
    as '/norm' segments, joined by '/'."""
    parts = []
    for seg in path[:-1]:  # the last element is the leaf name
        if seg in _COLLECTION_ROOTS or seg in _CONTAINERS \
                or seg == "backbone":
            continue
        if seg.endswith("_norm"):
            parts.extend([seg[:-len("_norm")], "norm"])
        else:
            parts.append(seg)
    return "/".join(parts)


def _split_entry(scope: str, var_name: str):
    """(scope, var) -> (normalised scope, collection, flax leaf): re-joins
    the full TF variable path and re-splits it at the last '/', so any
    scope / sub-key split the reference loader accepts resolves alike."""
    segs = (str(scope) + "/" + str(var_name)).split("/")
    coll, leaf = _VAR_MAP.get(segs[-1], ("params", segs[-1]))
    scope_segs = [s for s in segs[:-1]
                  if s not in ("batch_normalization", "3x3")]
    return "/".join(scope_segs), coll, leaf


def load_pretrained_npy(path: str, variables: dict, backbone: str,
                        verbose: bool = False, min_loaded: int = 0) -> dict:
    """A copy of ``variables`` (the flax-layout numpy tree) with the
    matching arrays of the ``.npy`` dict at ``path`` assigned.
    ``min_loaded``: raise if fewer arrays matched (a checkpoint whose
    scopes match nothing would otherwise "load" 0)."""
    data = np.load(path, allow_pickle=True, encoding="latin1")
    if hasattr(data, "item"):
        data = data.item()
    assert isinstance(data, dict), f"unexpected npy payload in {path}"
    return load_pretrained_dict(data, variables, backbone, verbose=verbose,
                                min_loaded=min_loaded, source=path)


def load_pretrained_dict(data: dict, variables: dict, backbone: str,
                         verbose: bool = False, min_loaded: int = 0,
                         source: str = "<dict>") -> dict:
    """Assign a ``{scope: {var_name: value}}`` dict into a copy of
    ``variables`` (the matching rules are in the module docstring)."""
    variables = copy.deepcopy(variables)
    flat = _flatten(variables)
    # (collection, semantic scope, leaf) -> [full paths]
    index = {}
    for p in flat:
        coll = "batch_stats" if "batch_stats" in p else "params"
        index.setdefault((coll, _semantic(p), p[-1]), []).append(p)

    n_loaded = 0
    for scope, vars_dict in data.items():
        for var_name, value in dict(vars_dict).items():
            value = np.asarray(value)
            scope_n, coll, leaf = _split_entry(scope, var_name)
            # exact semantic-suffix match: the semantic path equals the
            # scope or ends with '/<scope>'
            cands = []
            for (c, sem, lf), paths in index.items():
                if c != coll or lf != leaf:
                    continue
                if sem == scope_n or sem.endswith("/" + scope_n):
                    cands.extend(paths)
            if not cands:
                if verbose:
                    print(f"  skip {scope}/{var_name}: no matching variable")
                continue
            if len(cands) > 1:
                if verbose:
                    print(f"  skip {scope}/{var_name}: ambiguous "
                          f"({len(cands)} matches)")
                continue
            p = cands[0]
            want = tuple(np.shape(flat[p]))
            if want != tuple(value.shape):
                # the reference's group_norm affine is [1,1,1,C], ours [C]
                if tuple(np.squeeze(value).shape) == want:
                    value = value.reshape(want)
                else:
                    if verbose:
                        print(f"  skip {scope}/{var_name}: shape "
                              f"{value.shape} != {want}")
                    continue
            node = variables
            for seg in p[:-1]:
                node = node[seg]
            node[p[-1]] = value.astype(np.float32)
            n_loaded += 1
    if verbose:
        print(f"loaded {n_loaded} pretrained arrays from {source}")
    if n_loaded < min_loaded:
        raise ValueError(
            f"pretrained import matched only {n_loaded} arrays from "
            f"{source} (expected >= {min_loaded}); checkpoint scope names "
            f"likely do not correspond to the {backbone} graph")
    return variables


# --------------------------------------------------------------------- #
# torchvision VGG16 import
# --------------------------------------------------------------------- #
# (flat reference scope, torchvision features index) for the 13 convs
_TV_VGG16_LAYERS = (
    ("conv1_1", 0), ("conv1_2", 2), ("conv2_1", 5), ("conv2_2", 7),
    ("conv3_1", 10), ("conv3_2", 12), ("conv3_3", 14),
    ("conv4_1", 17), ("conv4_2", 19), ("conv4_3", 21),
    ("conv5_1", 24), ("conv5_2", 26), ("conv5_3", 28),
)
# torchvision's ImageNet input normalisation (vgg16 weight card)
_TV_MEAN = (0.485, 0.456, 0.406)
_TV_STD = (0.229, 0.224, 0.225)


def torchvision_vgg16_to_reference(state_dict, pixel_mean: float = None,
                                   fold_normalization: bool = True) -> dict:
    """torchvision ``vgg16`` state dict -> the reference's ``.npy`` layout
    ``{scope: {'weights': HWIO, 'biases': [C]}}``.

    torchvision's weights expect ``(x - mean) / std`` on 0-1 RGB input;
    this pipeline feeds VGG ``gray - PIXEL_MEAN`` replicated over 3
    channels.  With ``fold_normalization`` the difference goes into
    conv1_1 exactly (y our input channel, m = PIXEL_MEAN / 255):

        z_c = (y/255 + m - mu_c) / sigma_c
        => W'_c = W_c / (255 sigma_c)
           b'   = b + sum_c ((m - mu_c) / sigma_c) * sum_hw W_c

    so the converted trunk computes torchvision's wherever a 3x3 window
    lies inside the image (at zero-padded borders each convention pads
    zeros in its own input space).  The 4096-wide classifier is not
    emitted: the BUS head is 512 wide and trains from scratch."""
    if pixel_mean is None:
        from wssdl_bus_tpu_torch.config import Config
        pixel_mean = Config().PIXEL_MEAN
    missing = [f"features.{i}.weight" for _, i in _TV_VGG16_LAYERS
               if f"features.{i}.weight" not in state_dict]
    if missing:
        raise ValueError(
            "state_dict does not match torchvision's plain vgg16 'features' "
            f"layout (missing {missing[:3]}{'...' if len(missing) > 3 else ''}"
            "); only torchvision.models.vgg16 (no _bn variant) is supported")
    out = {}
    for scope, idx in _TV_VGG16_LAYERS:
        w = np.asarray(state_dict[f"features.{idx}.weight"], np.float32)
        b = np.asarray(state_dict[f"features.{idx}.bias"], np.float32)
        w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO (flax / TF layout)
        if scope == "conv1_1" and fold_normalization:
            m = pixel_mean / 255.0
            scale = np.asarray([1.0 / (255.0 * s) for s in _TV_STD],
                               np.float32)
            shift = np.asarray([(m - mu) / s
                                for mu, s in zip(_TV_MEAN, _TV_STD)],
                               np.float32)
            b = b + np.einsum("hwio,i->o", w, shift)
            w = w * scale[None, None, :, None]
        out[scope] = {"weights": w, "biases": b}
    return out


def load_pretrained_torchvision(path_or_state_dict, variables: dict,
                                backbone: str, verbose: bool = False,
                                min_loaded: int = 0,
                                pixel_mean: float = None) -> dict:
    """torchvision ``vgg16`` weights (a ``.pth`` / ``.pt`` file or a state
    dict) into a copy of ``variables`` (see
    :func:`torchvision_vgg16_to_reference`)."""
    if backbone != "VGGnet":
        raise ValueError(
            "torchvision import supports VGG16 only: torchvision resnets "
            "are post-activation, the reference's are pre-activation")
    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: np.asarray(v) for k, v in dict(sd).items()
          if k.startswith("features.")}
    data = torchvision_vgg16_to_reference(sd, pixel_mean=pixel_mean)
    return load_pretrained_dict(data, variables, backbone, verbose=verbose,
                                min_loaded=min_loaded,
                                source="torchvision vgg16")


def load_pretrained_auto(path: str, variables: dict, backbone: str,
                         verbose: bool = False, min_loaded: int = 0,
                         pixel_mean: float = None) -> dict:
    """By extension: ``.pth`` / ``.pt`` is a torchvision vgg16 state dict,
    anything else the reference's ``.npy`` dict."""
    if path.endswith((".pth", ".pt")):
        return load_pretrained_torchvision(path, variables, backbone,
                                           verbose=verbose,
                                           min_loaded=min_loaded,
                                           pixel_mean=pixel_mean)
    return load_pretrained_npy(path, variables, backbone, verbose=verbose,
                               min_loaded=min_loaded)


def load_pretrained_model(path: str, model: torch.nn.Module,
                          verbose: bool = False, min_loaded: int = 0,
                          pixel_mean: float = None) -> None:
    """Load ``path`` (:func:`load_pretrained_auto`) into ``model`` in place,
    matched on ``params_to_jax(model.state_dict())``.  The Solver's
    ``--pretrained_model`` path."""
    from wssdl_bus_tpu_torch.models.convert import (params_from_jax,
                                                    params_to_jax)

    tree = load_pretrained_auto(path, params_to_jax(model.state_dict()),
                                model.backbone, verbose=verbose,
                                min_loaded=min_loaded, pixel_mean=pixel_mean)
    model.load_state_dict(params_from_jax(tree))
