"""Experiment config: the ``fhpe_tpu`` schema, loaded without JAX.

A copy of ``fhpe_tpu/config/node.py`` and ``fhpe_tpu/config/defaults.py``
(pure Python + pyyaml): importing ``fhpe_tpu`` runs its package
``__init__``, which imports JAX whenever ``FHPE_PLATFORM`` is set, so the
port cannot lean on it.  ``tests/test_torch_port_hygiene.py`` pins this
copy equal to ``fhpe_tpu.config`` on every ``experiments/**/*.yaml``.

Same semantics as the original: attribute access, defaults < YAML file <
dotted ``KEY VALUE`` overrides, yacs-style literal decoding of strings,
freezing after the merge.  ``TPU.*`` keys keep their names; the port
reads ``TPU.COMPUTE_DTYPE``, ``TPU.DEAD_BIAS_SKIP`` and
``TPU.NUM_DEVICES``, and accepts the rest for YAML compatibility.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml


class FrozenError(AttributeError):
    pass


def _decode(value: Any) -> Any:
    """Decode a YAML/CLI scalar the way yacs does: strings that parse as
    Python literals are converted, everything else passes through."""
    if isinstance(value, dict):
        return CfgNode(value)
    if not isinstance(value, str):
        return value
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _check_type_match(old: Any, new: Any, key: str) -> Any:
    """Allow value replacement when types are compatible (yacs semantics)."""
    if old is None or new is None:
        return new
    if isinstance(old, type(new)) or isinstance(new, type(old)):
        return new
    casts = [(tuple, list), (list, tuple), (int, float), (float, int)]
    for src, dst in casts:
        if isinstance(new, src) and isinstance(old, dst):
            return dst(new)
    raise TypeError(
        f"type mismatch for key '{key}': {type(old).__name__} vs {type(new).__name__}"
    )


class CfgNode(dict):
    """dict with attribute access, recursive merge, and freeze support."""

    _FROZEN = "_is_frozen"
    _NEW_ALLOWED = "_new_allowed"

    def __init__(self, init: Dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        object.__setattr__(self, CfgNode._NEW_ALLOWED, new_allowed)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v, new_allowed=new_allowed) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise FrozenError(f"config is frozen; cannot set '{name}'")
        self[name] = value

    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def _set_frozen(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode._FROZEN, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(flag)

    def _merge(self, other: Dict, path: List[str]) -> None:
        for k, v in other.items():
            full = ".".join(path + [str(k)])
            v = _decode(v)
            if k in self:
                old = self[k]
                if isinstance(old, CfgNode) and isinstance(v, dict):
                    old._merge(v, path + [str(k)])
                else:
                    dict.__setitem__(self, k, _check_type_match(old, v, full))
            elif object.__getattribute__(self, CfgNode._NEW_ALLOWED):
                dict.__setitem__(
                    self, k, CfgNode(v, new_allowed=True) if isinstance(v, dict) else v
                )
            else:
                raise KeyError(f"non-existent config key: {full}")

    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            self._merge(loaded, [])

    def merge_from_list(self, opts: List[str]) -> None:
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not object.__getattribute__(node, CfgNode._NEW_ALLOWED):
                raise KeyError(f"non-existent config key: {key}")
            old = node.get(leaf)
            dict.__setitem__(node, leaf, _check_type_match(old, _decode(value), key))

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def dump_yaml(self) -> str:
        def _plain(v):
            if isinstance(v, CfgNode):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return list(v)
            return v

        return yaml.safe_dump(_plain(self), sort_keys=False)

    def __deepcopy__(self, memo):
        node = CfgNode(new_allowed=object.__getattribute__(self, CfgNode._NEW_ALLOWED))
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        return node

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _base() -> CfgNode:
    """The reference schema (``lib/config/default.py``) plus ``TPU.*``;
    the values are ``fhpe_tpu/config/defaults.py``'s."""
    c = CfgNode()

    c.OUTPUT_DIR = ""
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.GPUS = (0,)
    c.WORKERS = 4
    c.PRINT_FREQ = 20
    c.AUTO_RESUME = False
    c.PIN_MEMORY = True
    c.RANK = 0

    c.CUDNN = CfgNode()
    c.CUDNN.BENCHMARK = True
    c.CUDNN.DETERMINISTIC = False
    c.CUDNN.ENABLED = True

    c.TPU = CfgNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"  # params stay float32
    c.TPU.MESH_AXIS = "data"
    c.TPU.NUM_DEVICES = -1            # -1 = all visible devices
    c.TPU.DONATE = True
    c.TPU.DEVICE_PREPROCESS = True
    c.TPU.DEVICE_WARP = False
    c.TPU.CANVAS_SIZE = [512, 512]
    c.TPU.BN_STATS = "device0"
    c.TPU.DECODE_CACHE_MB = 0
    # hourglass: drop the conv biases a downstream BatchNorm absorbs
    c.TPU.DEAD_BIAS_SKIP = False
    c.TPU.NATIVE_DECODE = False
    c.TPU.NATIVE_WARP = False
    c.TPU.FUSED_EVAL = False
    c.TPU.STALL_TIMEOUT_S = 0

    c.MODEL = CfgNode()
    c.MODEL.NAME = "pose_hrnet"
    c.MODEL.INIT_WEIGHTS = True
    c.MODEL.PRETRAINED = ""
    c.MODEL.NUM_JOINTS = 17
    c.MODEL.TAG_PER_JOINT = True
    c.MODEL.TARGET_TYPE = "gaussian"
    c.MODEL.IMAGE_SIZE = [256, 256]  # width, height
    c.MODEL.HEATMAP_SIZE = [64, 64]  # width, height
    c.MODEL.SIGMA = 2
    c.MODEL.EXTRA = CfgNode(new_allowed=True)

    c.LOSS = CfgNode()
    c.LOSS.USE_OHKM = False
    c.LOSS.TOPK = 8
    c.LOSS.USE_TARGET_WEIGHT = True
    c.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = False

    c.DATASET = CfgNode()
    c.DATASET.ROOT = ""
    c.DATASET.DATASET = "mpii"
    c.DATASET.TRAIN_SET = "train"
    c.DATASET.TEST_SET = "valid"
    c.DATASET.DATA_FORMAT = "jpg"
    c.DATASET.HYBRID_JOINTS_TYPE = ""
    c.DATASET.SELECT_DATA = False
    c.DATASET.FLIP = True
    c.DATASET.SCALE_FACTOR = 0.25
    c.DATASET.ROT_FACTOR = 30
    c.DATASET.PROB_HALF_BODY = 0.0
    c.DATASET.NUM_JOINTS_HALF_BODY = 8
    c.DATASET.COLOR_RGB = False
    c.DATASET.CACHE_ROOT = "data/cache"
    c.DATASET.SYNTH_SIZE = 64
    c.DATASET.SYNTH_OVERFIT = False

    c.TRAIN = CfgNode()
    c.TRAIN.LR_FACTOR = 0.1
    c.TRAIN.LR_STEP = [90, 110]
    c.TRAIN.LR = 0.001
    c.TRAIN.OPTIMIZER = "adam"
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.WD = 0.0001
    c.TRAIN.NESTEROV = False
    c.TRAIN.GAMMA1 = 0.99
    c.TRAIN.GAMMA2 = 0.0
    c.TRAIN.BEGIN_EPOCH = 0
    c.TRAIN.END_EPOCH = 140
    c.TRAIN.RESUME = False
    c.TRAIN.CHECKPOINT = ""
    c.TRAIN.BATCH_SIZE_PER_GPU = 32
    c.TRAIN.SHUFFLE = True
    c.TRAIN.SEED = 0
    c.TRAIN.EVAL_FREQ = 1
    c.TRAIN.CKPT_FREQ = 1

    c.TEST = CfgNode()
    c.TEST.BATCH_SIZE_PER_GPU = 32
    c.TEST.FLIP_TEST = False
    c.TEST.POST_PROCESS = False
    c.TEST.SHIFT_HEATMAP = False
    c.TEST.USE_GT_BBOX = False
    c.TEST.IMAGE_THRE = 0.1
    c.TEST.NMS_THRE = 0.6
    c.TEST.SOFT_NMS = False
    c.TEST.OKS_THRE = 0.5
    c.TEST.IN_VIS_THRE = 0.0
    c.TEST.COCO_BBOX_FILE = ""
    c.TEST.BBOX_THRE = 1.0
    c.TEST.MODEL_FILE = ""

    c.KD = CfgNode()
    c.KD.TRAIN_TYPE = "NORMAL"  # 'FPD' enables teacher->student distillation
    c.KD.TEACHER = ""
    c.KD.ALPHA = 0.5

    c.DEBUG = CfgNode()
    c.DEBUG.DEBUG = False
    c.DEBUG.SAVE_BATCH_IMAGES_GT = False
    c.DEBUG.SAVE_BATCH_IMAGES_PRED = False
    c.DEBUG.SAVE_HEATMAPS_GT = False
    c.DEBUG.SAVE_HEATMAPS_PRED = False

    return c


def _pose_resnet_extra() -> CfgNode:
    e = CfgNode(new_allowed=True)
    e.NUM_LAYERS = 50
    e.DECONV_WITH_BIAS = False
    e.NUM_DECONV_LAYERS = 3
    e.NUM_DECONV_FILTERS = [256, 256, 256]
    e.NUM_DECONV_KERNELS = [4, 4, 4]
    e.FINAL_CONV_KERNEL = 1
    e.PRETRAINED_LAYERS = ["*"]
    return e


def _pose_hrnet_extra() -> CfgNode:
    e = CfgNode(new_allowed=True)
    e.PRETRAINED_LAYERS = ["*"]
    e.STEM_INPLANES = 64
    e.FINAL_CONV_KERNEL = 1
    for name, (branches, channels) in {
        "STAGE2": (2, [32, 64]),
        "STAGE3": (3, [32, 64, 128]),
        "STAGE4": (4, [32, 64, 128, 256]),
    }.items():
        s = CfgNode()
        s.NUM_MODULES = 1
        s.NUM_BRANCHES = branches
        s.NUM_BLOCKS = [4] * branches
        s.NUM_CHANNELS = channels
        s.BLOCK = "BASIC"
        s.FUSE_METHOD = "SUM"
        e[name] = s
    return e


def _hourglass_extra() -> CfgNode:
    e = CfgNode(new_allowed=True)
    e.NUM_FEATURES = 256
    e.NUM_STACKS = 8
    e.NUM_BLOCKS = 1
    return e


# Per-architecture EXTRA defaults (reference lib/config/models.py).
MODEL_EXTRAS = {
    "pose_resnet": _pose_resnet_extra,
    "pose_hrnet": _pose_hrnet_extra,
    "pose_high_resolution_net": _pose_hrnet_extra,
    "hourglass": _hourglass_extra,
}


def get_default_config() -> CfgNode:
    return _base()


def load_config(cfg_file: str, opts: list | None = None,
                model_dir: str = "", log_dir: str = "", data_dir: str = "") -> CfgNode:
    """defaults < YAML file < overrides, then the path joins, then freeze."""
    cfg = get_default_config()
    cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))

    if model_dir:
        cfg.OUTPUT_DIR = model_dir
    if log_dir:
        cfg.LOG_DIR = log_dir
    if data_dir:
        cfg.DATA_DIR = data_dir

    cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    cfg.MODEL.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.MODEL.PRETRAINED)
    if cfg.TEST.MODEL_FILE:
        cfg.TEST.MODEL_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.MODEL_FILE)

    cfg.freeze()
    return cfg


__all__ = ["CfgNode", "FrozenError", "MODEL_EXTRAS", "get_default_config",
           "load_config"]
