"""Layered configuration system (the port's own copy of
``wssdl_bus_tpu/config.py``: the port imports nothing of the JAX package).

Mirrors the reference's global ``easydict`` config key-for-key
(the reference's ``lib/fast_rcnn/config.py:28-321``) but as typed,
immutable dataclasses.  Three override layers, like the reference:

  1. dataclass defaults (== the reference defaults),
  2. YAML file override (``Config.from_yaml``; reference ``cfg_from_file``,
     config.py:384),
  3. dotted KEY VALUE pair list, e.g. from the CLI
     (``Config.with_overrides(["TRAIN.SNAPSHOT_ITERS", "100"])``; reference
     ``cfg_from_list``, config.py:392).

Unknown keys raise, and value types must match the default's type — the same
strict-merge behaviour as the reference (config.py:352-412).
"""

from __future__ import annotations

import dataclasses
from ast import literal_eval
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class TrainConfig:
    # Optimization (reference config.py:40-46)
    LEARNING_RATE: float = 0.0005
    MOMENTUM: float = 0.9
    GAMMA: float = 0.1
    STEPSIZE: int = 30000
    DISPLAY: int = 10
    WEIGHT_DECAY: float = 0.0005

    # Weak supervision (reference config.py:49-60)
    WS_IMS_PER_BATCH: int = 2
    WS_TRAIN_INTERVAL: int = 1
    WS_LOSS_USE_ADAPTIVE_SCALE_FACTOR: bool = True
    WS_LOSS_SCALE_FACTOR: float = 0.5
    S_MAL_PCT: float = 0.5
    WS_MAL_PCT: float = 0.2209  # 933/4224 for 'bus_ws_train'

    # Feature normalisation (reference config.py:54-56)
    USE_BRN: bool = True  # batch renorm inside BN layers
    GN_MIN_NUM_G: int = 8
    GN_MIN_CHS_PER_G: int = 4

    # Ground truth padding (reference config.py:92)
    MAX_GT_PER_IMAGE: int = 20

    # Image scales (reference config.py:109-112)
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000

    # Batch structure (reference config.py:115-130)
    IMS_PER_BATCH: int = 1
    BATCH_SIZE: int = 128          # ROIs per supervised image
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.0

    # Augmentation (reference config.py:133-150)
    USE_FLIPPED: bool = True
    USE_ROTATION: bool = True
    ROTATION_MAX_ANGLE: float = 5.0
    USE_CROPPING: bool = True
    CROPPING_MAX_MARGIN: float = 0.05
    USE_BRIGHTNESS_ADJUSTMENT: bool = True
    BRIGHTNESS_ADJUSTMENT_MAX_DELTA: float = 0.2
    USE_CONTRAST_ADJUSTMENT: bool = True
    CONTRAST_ADJUSTMENT_LOWER_FACTOR: float = 0.2
    CONTRAST_ADJUSTMENT_UPPER_FACTOR: float = 1.8

    # BBox regression (reference config.py:153-183)
    BBOX_REG: bool = True
    BBOX_THRESH: float = 0.5
    BBOX_NORMALIZE_TARGETS: bool = False
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = False
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    # Snapshot / eval cadence (reference config.py:160-172)
    SNAPSHOT_ITERS: int = 10
    TEST_ITERS: int = 10
    SNAPSHOT_PREFIX: str = "VGGnet_fast_rcnn"
    SNAPSHOT_INFIX: str = ""
    # honored: the Solver's default prefetch behavior when the CLI passes
    # neither --prefetch nor --no_prefetch (reference config.py:172)
    USE_PREFETCH: bool = False
    # Additive (no reference key): stage raw uint8 images and finish
    # photometric/resize preparation ON DEVICE inside the train step
    # (ops/device_prep.py of the JAX package).  Train-feed only; eval/test
    # keep host prep.
    DEVICE_PREP: bool = True

    PROPOSAL_METHOD: str = "gt"
    ASPECT_GROUPING: bool = True

    # RPN (reference config.py:194-218)
    HAS_RPN: bool = True
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_MIN_SIZE: int = 16
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0

    DEBUG_TIMELINE: bool = False


@dataclass(frozen=True)
class TestConfig:
    # (reference config.py:227-268)
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    CLS_AGNOSTIC_NMS: bool = False
    SVM: bool = False
    BBOX_REG: bool = True
    HAS_RPN: bool = True
    PROPOSAL_METHOD: str = "gt"
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    DEBUG_TIMELINE: bool = False


@dataclass(frozen=True)
class Config:
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    # MISC (reference config.py:274-321)
    DEDUP_BOXES: float = 1.0 / 16.0
    PIXEL_MEAN: float = 68.274   # grayscale BUS pixel mean (config.py:284)
    PIXEL_STD: float = 52.802    # grayscale BUS pixel std (config.py:287)
    RNG_SEED: int = 3
    EPS: float = 1e-14
    DATA_DIR: str = "SNUBH_BUS"   # dataset root, relative to the working dir
    EXP_DIR: str = ""
    # Surface-parity keys (reference config.py:277,292,306): the multiscale
    # path raises NotImplementedError in the reference too, and MATLAB eval
    # is never invoked; kept so override lists/YAMLs written for the
    # reference parse unchanged.
    IS_MULTISCALE: bool = False
    MATLAB: str = "matlab"
    MODELS_DIR: str = "models"
    # Base for get_output_dir.  Deliberate deviation: the reference anchors
    # this at its checkout root (config.py:296); an installed package has no
    # checkout, so artifacts default to the invoking directory, like most
    # CLI tools.  Set ROOT_DIR (or pass explicit --output_dir) for a fixed
    # location.
    ROOT_DIR: str = "."
    USE_GPU_NMS: bool = False    # kept for config-surface parity; unread

    # Additions (not in the reference):
    # number of anchor types = len(ratios) * len(scales); fixed by the model.
    FEAT_STRIDE: int = 16
    ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)

    # ------------------------------------------------------------------ #
    # Override machinery                                                 #
    # ------------------------------------------------------------------ #
    def with_overrides(self, kv_list) -> "Config":
        """Apply a flat ['TRAIN.SNAPSHOT_ITERS', '100', ...] override list.

        Mirrors ``cfg_from_list`` (reference config.py:392-412): dotted keys,
        values parsed with ``literal_eval`` falling back to raw strings, and a
        strict type check against the current value.
        """
        if len(kv_list) % 2 != 0:
            raise ValueError("override list must be KEY VALUE pairs")
        cfg = self
        for key, raw in zip(kv_list[0::2], kv_list[1::2]):
            try:
                value = literal_eval(raw) if isinstance(raw, str) else raw
            except (ValueError, SyntaxError):
                value = raw
            cfg = cfg._set_dotted(key, value)
        return cfg

    def _set_dotted(self, dotted_key: str, value) -> "Config":
        parts = dotted_key.split(".")
        return _replace_path(self, parts, value)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """Build a config from defaults merged with a YAML override file
        (reference ``cfg_from_file``, config.py:384-390)."""
        import yaml

        with open(path) as f:
            tree = yaml.safe_load(f) or {}
        cfg = cls()
        flat = []
        _flatten(tree, "", flat)
        for k, v in flat:
            cfg = cfg._set_dotted(k, v)
        return cfg


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, key + ".", out)
        else:
            out.append((key, v))


def _replace_path(obj, parts, value):
    name = parts[0]
    if not hasattr(obj, name):
        raise KeyError(f"{name} is not a valid config key")
    if len(parts) == 1:
        old = getattr(obj, name)
        if isinstance(old, tuple) and isinstance(value, (list, tuple)):
            value = tuple(value)
        if type(old) is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, type(old)) and old is not None:
            raise TypeError(
                f"type {type(value).__name__} does not match original type "
                f"{type(old).__name__} for config key {name}"
            )
        return dataclasses.replace(obj, **{name: value})
    child = getattr(obj, name)
    return dataclasses.replace(obj, **{name: _replace_path(child, parts[1:], value)})


# A module-level default instance, handy for tests and simple scripts.
# Unlike the reference's mutable global ``cfg``, this is immutable; code paths
# thread an explicit Config through instead.
DEFAULT = Config()


def get_output_dir(imdb, weights_filename=None, cfg: Config = DEFAULT) -> str:
    """Canonical experiment-artifact directory, created on first use:
    ``<ROOT_DIR>/output/<EXP_DIR>/<imdb.name>[/<weights_filename>]``
    (reference ``get_output_dir``, config.py:324-337)."""
    import os

    name = imdb if isinstance(imdb, str) else imdb.name
    outdir = os.path.abspath(
        os.path.join(cfg.ROOT_DIR, "output", cfg.EXP_DIR, name))
    if weights_filename is not None:
        outdir = os.path.join(outdir, weights_filename)
    os.makedirs(outdir, exist_ok=True)
    return outdir


def get_direct_output_dir(name, cfg: Config = DEFAULT) -> str:
    """``<ROOT_DIR>/output/<EXP_DIR>[/<name>]`` (reference
    ``get_direct_output_dir``, config.py:339-350)."""
    import os

    outdir = os.path.abspath(os.path.join(cfg.ROOT_DIR, "output", cfg.EXP_DIR))
    if name is not None:
        outdir = os.path.join(outdir, name)
    os.makedirs(outdir, exist_ok=True)
    return outdir
