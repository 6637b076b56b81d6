"""Weights carried across from the JAX package, and the port's seeded init.

The JAX detector's variables (``FasterRCNN.init_variables`` in
``wssdl_bus_tpu/models/detector.py:131-143``) are a tree
``{"trunk": {"params": {...}}, "head": {"params": {...}}}`` whose leaves are
``kernel``/``bias`` under module paths like ``backbone/conv1_1/conv``, and for
ResNet the norms' ``gamma``/``beta`` and a ``batch_stats`` collection of
BatchRenorm's running ``mean``/``var``.  Given as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, variables)``), :func:`params_from_jax`
maps them onto this package's state dict, whose keys follow the same path
(``trunk.backbone.conv1_1.conv.weight``, ``trunk.backbone.conv0.bn.mean``):

  * conv kernels HWIO -> OIHW;
  * dense kernels [in, out] -> [out, in];
  * gamma, beta, mean, var as they are (the running statistics are
    buffers).

fc6's rows are in NHWC (h, w, c) flatten order on both sides (the port's
ROI pool writes the same order), so no row permutation is needed.

:func:`opt_state_from_jax` carries an optax optimizer state across the
same way, into ``train/engine.py:Optimizer.load_state_dict``'s format, and
:func:`qtrunk_from_jax` an int8 serving tree of the JAX package's
``models/quantize.py`` into the port's (``models/quantize.py``).
:func:`reference_init_` draws the JAX package's initialisation (truncated
normal, std 0.01; 0.001 for ``bbox_pred``; zero biases; the norms at their
identity) from a seeded ``torch.Generator``.
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


_PARAM_LEAVES = ("bias", "gamma", "beta")     # same name on both sides
_STAT_LEAVES = ("mean", "var")                 # BatchRenorm's batch_stats


def params_from_jax(variables) -> dict:
    """Flax variable tree (nested dicts of numpy arrays) -> state dict: the
    ``params`` collection (kernels, biases, the norms' gamma / beta) and,
    where a part has one, the ``batch_stats`` collection (BatchRenorm's
    running ``mean`` / ``var``, buffers of the same names)."""
    sd = {}
    for part in _PARTS:
        tree = variables[part]
        for coll in ("params", "batch_stats"):
            if coll not in tree:
                continue
            for path, arr in _leaves(tree[coll]):
                a = np.asarray(arr, dtype=np.float32)
                *mod, leaf = path
                if coll == "params" and leaf == "kernel":
                    a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                    name = "weight"
                elif leaf in (_PARAM_LEAVES if coll == "params"
                              else _STAT_LEAVES):
                    name = leaf
                else:
                    raise KeyError(f"unexpected leaf {coll}/"
                                   f"{'/'.join(path)}")
                sd[".".join((part, *mod, name))] = torch.tensor(a)
    return sd


def params_to_jax(state_dict) -> dict:
    """State dict -> the flax variable tree of numpy arrays (inverse of
    :func:`params_from_jax`); a part gets a ``batch_stats`` collection only
    where it holds running statistics, as flax's tree does."""
    tree = {part: {"params": {}} for part in _PARTS}
    for key, t in state_dict.items():
        part, *mod, name = key.split(".")
        a = t.detach().cpu().numpy()
        coll = "batch_stats" if name in _STAT_LEAVES else "params"
        if name == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        else:
            leaf = name
        node = tree[part].setdefault(coll, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.array(a, order="C")   # a copy, never a view
    return tree


# the leaves that are not drawn: their init value
_CONSTANT_INIT = {"bias": 0.0, "beta": 0.0, "gamma": 1.0, "mean": 0.0,
                  "var": 1.0}


def he_tree(variables, seed: int, input_scale: float = 1.0) -> dict:
    """The same tree with every kernel drawn He-normal (std sqrt(2/fan_in),
    fan_in = all kernel dims but the last) from
    ``np.random.RandomState(seed)`` in sorted path order, every bias and
    beta zero, every gamma one, and BatchRenorm's running statistics at
    their init (mean 0, var 1).

    He scaling keeps activations alive through VGG16's 13 convs; the JAX
    package's truncated-normal std 0.01 leaves conv5_3 nearly featureless
    and the RPN scores in near-ties, where tie order would pick the
    proposals.  He assumes unit-scale inputs: the serving blob is in pixel
    units (mean-subtracted, x255 for VGG16), so ``input_scale`` (its rough
    std) divides the first conv's kernel (VGG16's conv1_1, ResNet's conv0).
    With zero biases the ReLU trunk is positively homogeneous, and unscaled
    weights would push every softmax to exact 0/1 ties."""
    rng = np.random.RandomState(seed)
    out = {}
    for part in _PARTS:
        out[part] = {}
        for coll in ("params", "batch_stats"):
            if coll not in variables[part]:
                continue
            tree = {}
            for path, arr in _leaves(variables[part][coll]):
                shape = np.shape(arr)
                if path[-1] == "kernel":
                    std = np.sqrt(2.0 / np.prod(shape[:-1]))
                    if "conv1_1" in path or "conv0" in path:
                        std /= input_scale
                    val = (rng.standard_normal(shape) * std).astype(
                        np.float32)
                else:
                    val = np.full(shape, _CONSTANT_INIT[path[-1]],
                                  np.float32)
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = val
            out[part][coll] = tree
    return out


def he_init_(model: torch.nn.Module, seed: int,
             input_scale: float = 1.0) -> torch.nn.Module:
    """Load :func:`he_tree` weights of ``seed`` into ``model`` in place."""
    tree = he_tree(params_to_jax(model.state_dict()), seed, input_scale)
    model.load_state_dict(params_from_jax(tree))
    return model


def _find(tree, attr: str):
    """The first NamedTuple in a nested optax state (NamedTuples, tuples,
    lists, dicts) with the field ``attr``, or None."""
    if attr in getattr(tree, "_fields", ()):
        return tree
    if isinstance(tree, dict):
        kids = list(tree.values())
    elif isinstance(tree, (tuple, list)):
        kids = list(tree)
    else:
        return None
    for kid in kids:
        hit = _find(kid, attr)
        if hit is not None:
            return hit
    return None


def opt_state_from_jax(opt_state) -> dict:
    """An optax state of the JAX package's ``make_optimizer`` (adam,
    amsgrad or Nesterov SGD under ``inject_hyperparams``, its moments trees
    ``{"trunk": ..., "head": ...}`` of numpy arrays) -> the port's
    ``Optimizer.state_dict()`` format: {"name", "count", "mu", "nu",
    "nu_max"} with each moment keyed by state-dict name (frozen parameters'
    moments included; an optimizer takes the names it holds)."""
    def named(tree):
        return params_from_jax({part: {"params": tree[part]}
                                for part in _PARTS})

    for name, attr in (("amsgrad", "nu_max"), ("adam", "nu"),
                       ("sgd", "trace")):
        node = _find(opt_state, attr)
        if node is not None:
            break
    else:
        raise ValueError("no adam / amsgrad / sgd state found")
    if name == "sgd":
        top = _find(opt_state, "hyperparams")
        count = int(np.asarray(top.count)) if top is not None else 0
        return {"name": name, "count": count, "mu": named(node.trace),
                "nu": None, "nu_max": None}
    return {"name": name, "count": int(np.asarray(node.count)),
            "mu": named(node.mu), "nu": named(node.nu),
            "nu_max": named(node.nu_max) if name == "amsgrad" else None}


@torch.no_grad()
def reference_init_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The JAX package's initialisation in place: every kernel truncated
    normal (std 0.01, cut at 2 std; std 0.001 for ``bbox_pred``, its
    ``models/vgg.py:83`` / ``models/resnet.py:157``), every bias and beta
    zero, every gamma one, BatchRenorm's running mean 0 and var 1; the
    kernels drawn from a CPU ``torch.Generator`` seeded with ``seed`` in
    sorted state-dict order."""
    gen = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for key in sorted(sd):
        t = sd[key]
        if key.endswith(".weight"):
            std = 0.001 if ".bbox_pred." in key else 0.01
            val = torch.nn.init.trunc_normal_(
                torch.empty(t.shape), std=std, a=-2 * std, b=2 * std,
                generator=gen)
        else:
            val = torch.full(t.shape, _CONSTANT_INIT[key.rsplit(".", 1)[-1]])
        t.copy_(val)
    return model


def _qlayer_from_jax(layer, device) -> dict:
    from wssdl_bus_tpu_torch.models.quantize import qlayer

    return qlayer(np.array(layer["qkernel"], np.int8), layer["scale"],
                  layer["bias"], layer["in_scale"], device)


def qtrunk_from_jax(tree, device="cpu") -> dict:
    """The JAX package's int8 serving tree (``quantize_vgg_trunk`` /
    ``quantize_resnet`` output, as numpy) -> the port's
    (``models/quantize.py``) on ``device``: each int8 HWIO kernel packed for
    the kernel (``ops/int8_conv.py:pack_weight``) beside its size ``k``;
    scales, biases and norm affines as they are.  The JAX tree's f32 RPN
    and dense copies are left out: the port runs the model's own."""
    if "layers" in tree:                                  # VGG16
        return {"layers": [_qlayer_from_jax(l, device)
                           for l in tree["layers"]]}

    def part(p):
        return {"layers": {path: _qlayer_from_jax(l, device)
                           for path, l in p["layers"].items()},
                "norms": {path: {k: torch.as_tensor(
                    np.array(a[k], np.float32), device=device)
                    for k in ("g", "c")} for path, a in p["norms"].items()}}

    return {"trunk": part(tree["trunk"]), "head": part(tree["head"])}
