"""Weights carried across from the JAX package, and the port's seeded init.

The JAX detector's variables (``FasterRCNN.init_variables`` in
``wssdl_bus_tpu/models/detector.py:131-143``) are a tree
``{"trunk": {"params": {...}}, "head": {"params": {...}}}`` whose leaves are
``kernel``/``bias`` under module paths like ``backbone/conv1_1/conv``.  Given
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``),
:func:`params_from_jax` maps them onto this package's state dict, whose keys
follow the same path (``trunk.backbone.conv1_1.conv.weight``):

  * conv kernels HWIO -> OIHW;
  * dense kernels [in, out] -> [out, in].

fc6's rows are in NHWC (h, w, c) flatten order on both sides (the port's
ROI pool writes the same order), so no row permutation is needed.
"""

from __future__ import annotations

import numpy as np
import torch

_PARTS = ("trunk", "head")


def _leaves(tree: dict, prefix: tuple = ()):
    """Yield (path tuple, array) over a nested dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(dict(v), prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(variables) -> dict:
    """Flax variable tree (nested dicts of numpy arrays) -> state dict."""
    sd = {}
    for part in _PARTS:
        for path, arr in _leaves(variables[part]["params"]):
            a = np.asarray(arr, dtype=np.float32)
            *mod, leaf = path
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            sd[".".join((part, *mod, name))] = torch.tensor(a)
    return sd


def params_to_jax(state_dict) -> dict:
    """State dict -> the flax variable tree of numpy arrays (inverse of
    :func:`params_from_jax`)."""
    tree = {part: {"params": {}} for part in _PARTS}
    for key, t in state_dict.items():
        part, *mod, name = key.split(".")
        a = t.detach().cpu().numpy()
        if name == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        else:
            leaf = name
        node = tree[part]["params"]
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.array(a, order="C")   # a copy, never a view
    return tree


def he_tree(variables, seed: int, input_scale: float = 1.0) -> dict:
    """The same tree with every kernel drawn He-normal (std sqrt(2/fan_in),
    fan_in = all kernel dims but the last) and every bias zero, from
    ``np.random.RandomState(seed)`` in sorted path order.

    He scaling keeps activations alive through VGG16's 13 convs; the JAX
    package's truncated-normal std 0.01 leaves conv5_3 nearly featureless
    and the RPN scores in near-ties, where tie order would pick the
    proposals.  He assumes unit-scale inputs: the serving blob is in pixel
    units (mean-subtracted, x255), so ``input_scale`` (its rough std)
    divides conv1_1's kernel.  With zero biases the ReLU trunk is positively
    homogeneous, and unscaled weights would push every softmax to exact 0/1
    ties."""
    rng = np.random.RandomState(seed)
    out = {}
    for part in _PARTS:
        tree = {}
        for path, arr in _leaves(variables[part]["params"]):
            shape = np.shape(arr)
            if path[-1] == "kernel":
                std = np.sqrt(2.0 / np.prod(shape[:-1]))
                if "conv1_1" in path:
                    std /= input_scale
                val = (rng.standard_normal(shape) * std).astype(np.float32)
            else:
                val = np.zeros(shape, np.float32)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = val
        out[part] = {"params": tree}
    return out


def he_init_(model: torch.nn.Module, seed: int,
             input_scale: float = 1.0) -> torch.nn.Module:
    """Load :func:`he_tree` weights of ``seed`` into ``model`` in place."""
    tree = he_tree(params_to_jax(model.state_dict()), seed, input_scale)
    model.load_state_dict(params_from_jax(tree))
    return model
