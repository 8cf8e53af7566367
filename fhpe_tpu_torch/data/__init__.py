"""Dataset registry: per-dataset constants and the db builders.

A copy of ``fhpe_tpu/data/__init__.py`` (``dataset_meta``, ``build_db``,
``_build_db_raw``; the reference's eval() dispatch, tools/train.py:153),
pinned to it by ``tests/test_torch_port_hygiene.py``.  ``fhpe_tpu.data``
itself cannot be imported here: its loader imports JAX.
"""

from __future__ import annotations

import os

from . import coco, mpii
from .coco import FLIP_PAIRS as COCO_FLIP_PAIRS
from .coco import NUM_JOINTS as COCO_NUM_JOINTS
from .filters import select_data
from .loader import BatchLoader, PoseDataSource, collate
from .mpii import FLIP_PAIRS as MPII_FLIP_PAIRS
from .mpii import NUM_JOINTS as MPII_NUM_JOINTS
from .synthetic import (make_synthetic_coco, make_synthetic_db,
                        make_synthetic_mpii)


def dataset_meta(name: str) -> dict:
    """Per-dataset constants: joints, flip pairs, body split, weights."""
    if name == "synthetic":  # hermetic smoke dataset (MPII-shaped)
        return dataset_meta("mpii")
    if name == "mpii":
        return {
            "num_joints": mpii.NUM_JOINTS,
            "flip_pairs": mpii.FLIP_PAIRS,
            "upper_body_ids": mpii.UPPER_BODY_IDS,
            "lower_body_ids": mpii.LOWER_BODY_IDS,
            "joints_weight": None,
        }
    if name == "coco":
        return {
            "num_joints": coco.NUM_JOINTS,
            "flip_pairs": coco.FLIP_PAIRS,
            "upper_body_ids": coco.UPPER_BODY_IDS,
            "lower_body_ids": coco.LOWER_BODY_IDS,
            "joints_weight": coco.JOINTS_WEIGHT,
        }
    raise KeyError(f"unknown DATASET.DATASET '{name}'")


def build_db(cfg, image_set: str, is_train: bool):
    """Build the sample db for cfg's dataset/split (gt or detector boxes).

    Applies the ks-metric ``select_data`` filter for training when
    ``DATASET.SELECT_DATA`` (JointsDataset.py:51-52 semantics)."""
    db = _build_db_raw(cfg, image_set, is_train)
    if is_train and cfg.DATASET.SELECT_DATA:
        db = select_data(db)
    return db


def _build_db_raw(cfg, image_set: str, is_train: bool):
    name = cfg.DATASET.DATASET
    root = cfg.DATASET.ROOT
    cache = cfg.DATASET.CACHE_ROOT or None
    if name == "synthetic":
        size = int(cfg.DATASET.get("SYNTH_SIZE", 64))
        if not is_train and cfg.DATASET.get("SYNTH_OVERFIT", False):
            # memorization-ceiling runs: validate on the EXACT train db
            is_train, image_set = True, cfg.DATASET.TRAIN_SET
        out = os.path.join(root or "/tmp/fhpe_synth", image_set)
        n = size if is_train else max(size // 2, 1)
        return make_synthetic_db(
            out, n, cfg.MODEL.NUM_JOINTS,
            (cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]),
            seed=0 if is_train else 1)
    if name == "mpii":
        return mpii.build_db(root, image_set, cfg.DATASET.DATA_FORMAT, cache)
    if name == "coco":
        aspect = cfg.MODEL.IMAGE_SIZE[0] / cfg.MODEL.IMAGE_SIZE[1]
        if is_train or cfg.TEST.USE_GT_BBOX:
            return coco.build_gt_db(root, image_set, aspect,
                                    cfg.DATASET.DATA_FORMAT, cache)
        return coco.build_detection_db(root, image_set,
                                       cfg.TEST.COCO_BBOX_FILE, aspect,
                                       cfg.TEST.IMAGE_THRE,
                                       cfg.DATASET.DATA_FORMAT)
    raise KeyError(f"unknown DATASET.DATASET '{name}'")


__all__ = ["BatchLoader", "PoseDataSource", "collate", "build_db",
           "dataset_meta", "make_synthetic_db", "make_synthetic_coco",
           "make_synthetic_mpii", "mpii", "coco", "COCO_FLIP_PAIRS",
           "COCO_NUM_JOINTS", "MPII_FLIP_PAIRS", "MPII_NUM_JOINTS"]
