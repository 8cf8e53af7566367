"""Shared CLI wiring: datasets and loaders, batches on the device, and
the dataset-metric dispatch.

Counterpart of ``fhpe_tpu/cli/common.py``, on one device with no process
sharding (``BatchLoader``'s ``process_index`` 0 of 1):

* :func:`build_loaders`: db -> ``PoseDataSource`` -> ``BatchLoader``,
  train and validation;
* :func:`train_batch_keys` and :func:`eval_batch_transform` (copies,
  pinned by ``tests/test_torch_port_hygiene.py``): what a train or eval
  step takes from a host batch;
* :func:`device_batch`: a host batch as tensors on an explicit device;
* :func:`make_evaluate_fn`: the COCO branch (rescore + OKS-NMS on the card
  -> results JSON -> COCO AP), the MPII branch (PCKh against
  ``gt_<TEST_SET>.mat``, host) and the ``synthetic`` branch.

``validate``, ``parse_args`` and the train CLIs come with the port's CLI
slice (``ROADMAP.md`` queue A, checkpoints, logger and the CLIs).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ..data import BatchLoader, PoseDataSource, build_db, dataset_meta
from ..ops.decode import make_inverse_transforms


def build_loaders(cfg, synthetic_dir: str | None = None, train: bool = True):
    """(train_loader, val_loader, meta) for one device: batches of
    ``TRAIN.BATCH_SIZE_PER_GPU`` / ``TEST.BATCH_SIZE_PER_GPU``.
    synthetic_dir swaps in the hermetic synthetic db (for smoke runs
    without real data)."""
    meta = dataset_meta(cfg.DATASET.DATASET)

    if synthetic_dir is not None:
        from ..data import make_synthetic_db
        db_train = make_synthetic_db(
            synthetic_dir, 64, meta["num_joints"],
            (cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]))
        db_val = db_train[:32]
    else:
        db_train = build_db(cfg, cfg.DATASET.TRAIN_SET, True) if train else []
        db_val = build_db(cfg, cfg.DATASET.TEST_SET, False)

    train_loader = None
    if train:
        seed = int(cfg.TRAIN.get("SEED", 0))
        src = PoseDataSource(cfg, db_train, is_train=True,
                             flip_pairs=meta["flip_pairs"],
                             upper_body_ids=meta["upper_body_ids"],
                             joints_weight=meta["joints_weight"],
                             seed=seed)
        train_loader = BatchLoader(
            src, batch_size=cfg.TRAIN.BATCH_SIZE_PER_GPU,
            shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
            host_targets=not cfg.TPU.DEVICE_PREPROCESS,
            num_threads=max(2, cfg.WORKERS), seed=seed)

    val_src = PoseDataSource(cfg, db_val, is_train=False,
                             flip_pairs=meta["flip_pairs"],
                             upper_body_ids=meta["upper_body_ids"],
                             joints_weight=meta["joints_weight"])
    val_loader = BatchLoader(
        val_src, batch_size=cfg.TEST.BATCH_SIZE_PER_GPU,
        shuffle=False, drop_last=False,
        host_targets=not cfg.TPU.DEVICE_PREPROCESS,
        num_threads=max(2, cfg.WORKERS))
    return train_loader, val_loader, meta


def train_batch_keys(cfg):
    """Minimal host->device transfer set for a train step."""
    if cfg.TPU.get("DEVICE_WARP", False):
        return ["canvas", "warp_inv", "joints", "joints_vis"]
    keys = ["image"]
    if cfg.TPU.DEVICE_PREPROCESS:
        keys += ["joints", "joints_vis"]
    else:
        keys += ["target", "target_weight"]
    return keys


def eval_batch_transform(cfg):
    """Host batch -> device dict for the eval step (adds inverse affines).

    Eval always ships host-warped images (bit-parity with the reference),
    even when TPU.DEVICE_WARP accelerates training batches.
    """
    keys = ["image"]
    if cfg.TPU.DEVICE_PREPROCESS:
        keys += ["joints", "joints_vis"]
    else:
        keys += ["target", "target_weight"]
    hm_size = tuple(cfg.MODEL.HEATMAP_SIZE)

    def tf(batch):
        dev = {k: batch[k] for k in keys}
        dev["inv_trans"] = make_inverse_transforms(batch["center"],
                                                   batch["scale"], hm_size)
        dev["valid"] = batch["valid"].astype("float32")
        return dev

    return tf


def device_batch(cfg, batch, device, for_eval=False):
    """Host batch dict -> tensors on ``device``, the minimal transfer set
    of a train step (:func:`train_batch_keys`) or an eval step
    (:func:`eval_batch_transform`)."""
    if for_eval:
        host = eval_batch_transform(cfg)(batch)
    else:
        host = {k: batch[k] for k in train_batch_keys(cfg)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def make_evaluate_fn(cfg, device="cuda"):
    """``cfg.DATASET.DATASET`` -> ``fn(cfg, preds, output_dir, all_boxes,
    img_paths) -> (name_values, perf)``, or None for ``synthetic`` (whose
    metric is the in-training PCK proxy).

    preds: (N, J, 3) keypoints in image coordinates with their maxvals;
    all_boxes: (N, 6) [cx, cy, sx, sy, area, score]; img_paths end in the
    zero-padded image id (``.../val2017/000000000139.jpg``).  The OKS-NMS
    runs on ``device``.
    """
    name = cfg.DATASET.DATASET
    if name == "synthetic":
        return None
    if name == "mpii":
        from ..data import mpii

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            return mpii.evaluate(cfg, preds, output_dir or None)
        return fn
    if name == "coco":
        from ..data.coco import (NUM_JOINTS, CocoIndex, rescore_and_nms,
                                 write_results_json)
        from ..eval.coco_eval import CocoKeypointEval

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            nmsed = rescore_and_nms(
                preds, all_boxes, img_paths, num_joints=NUM_JOINTS,
                in_vis_thre=cfg.TEST.IN_VIS_THRE,
                oks_thre=cfg.TEST.OKS_THRE, soft=cfg.TEST.SOFT_NMS,
                device=device)
            res_file = os.path.join(
                output_dir or ".", "results",
                f"keypoints_{cfg.DATASET.TEST_SET}_results_{cfg.RANK}.json")
            results = write_results_json(nmsed, res_file)
            if "test" in cfg.DATASET.TEST_SET:
                return OrderedDict([("Null", 0.0)]), 0.0
            ann = os.path.join(cfg.DATASET.ROOT, "annotations",
                               f"person_keypoints_{cfg.DATASET.TEST_SET}.json")
            nv = OrderedDict(CocoKeypointEval(CocoIndex(ann)).evaluate(results))
            return nv, nv["AP"]
        return fn
    raise KeyError(name)
