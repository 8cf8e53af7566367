"""Synthetic COCO person-keypoints ground truth and planted detections,
for checking the evaluation path without the dataset (the CPU tests
against ``fhpe_tpu``, ``chip_smoke.py`` on the card).  numpy only, from a
seed.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from .coco import NUM_JOINTS, xywh2cs
from ..ops.nms import oks_iou

IMAGE_W, IMAGE_H = 640, 480


def synthetic_coco_gt(num_images: int, seed: int = 0) -> dict:
    """A COCO person-keypoints annotation dict: ``num_images`` images of
    640 x 480 with 1-4 people each, people 60-300 px tall (medium and
    large areas), about one joint in six unlabeled (v = 0)."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for k in range(num_images):
        img_id = 139 + 7 * k
        images.append({"id": img_id, "width": IMAGE_W, "height": IMAGE_H,
                       "file_name": "%012d.jpg" % img_id})
        for _ in range(rng.randint(1, 5)):
            h = rng.uniform(60, 300)
            w = h * rng.uniform(0.35, 0.6)
            x0 = rng.uniform(0, IMAGE_W - w)
            y0 = rng.uniform(0, IMAGE_H - h)
            kp = np.zeros((NUM_JOINTS, 3))
            kp[:, 0] = x0 + rng.uniform(0.1, 0.9, NUM_JOINTS) * w
            kp[:, 1] = y0 + np.sort(rng.uniform(0.05, 0.95, NUM_JOINTS)) * h
            kp[:, 2] = np.where(rng.uniform(size=NUM_JOINTS) < 0.17, 0, 2)
            kp[kp[:, 2] == 0, :2] = 0
            anns.append({
                "id": len(anns) + 1, "image_id": img_id, "category_id": 1,
                "iscrowd": 0, "bbox": [float(x0), float(y0), float(w),
                                       float(h)],
                "area": float(w * h * 0.7),
                "num_keypoints": int((kp[:, 2] > 0).sum()),
                "keypoints": [float(v) for v in kp.reshape(-1)]})
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}


def synthetic_train_batch(n: int, seed: int = 0, image_size=(192, 256),
                          num_joints: int = NUM_JOINTS) -> dict:
    """A COCO training batch as ``make_batch_preprocessor`` takes it
    (``TPU.DEVICE_PREPROCESS``): ``image`` (n, H, W, 3) uint8 crops,
    ``joints`` (n, J, 2) float32 in crop pixels and ``joints_vis`` (n, J)
    float32.  Per crop one person filling 60-95% of its height, joints
    ordered top to bottom as COCO's are roughly, about one in six
    unlabeled (v = 0, coordinates 0) and a few off the crop's edge, as
    half-body and rotation augmentation leave them.  ``image_size`` is
    (W, H), as ``MODEL.IMAGE_SIZE``."""
    rng = np.random.RandomState(seed)
    w, h = image_size
    image = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    tall = rng.uniform(0.6, 0.95, (n, 1)) * h
    top = rng.uniform(-0.05 * h, h - tall)
    cx = rng.uniform(0.3, 0.7, (n, 1)) * w
    xs = cx + rng.uniform(-0.3, 0.3, (n, num_joints)) * tall * 0.5
    ys = top + np.sort(rng.uniform(0.0, 1.0, (n, num_joints)), -1) * tall
    vis = (rng.uniform(size=(n, num_joints)) >= 0.17).astype(np.float32)
    joints = np.stack([xs, ys], -1) * vis[..., None]
    return {"image": image, "joints": joints.astype(np.float32),
            "joints_vis": vis}


def write_coco_gt(root: str, image_set: str, gt: dict) -> str:
    """Write ``gt`` where the evaluator looks for it:
    ``<root>/annotations/person_keypoints_<image_set>.json``."""
    path = os.path.join(root, "annotations",
                        f"person_keypoints_{image_set}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(gt, f)
    return path


def image_path(root: str, image_set: str, img_id: int) -> str:
    return os.path.join(root, "images", image_set, "%012d.jpg" % img_id)


def gt_boxes(gt: dict, root: str, image_set: str,
             aspect_ratio: float) -> Tuple[np.ndarray, List[str]]:
    """One box per ground-truth person, as the evaluation path gets it:
    ``all_boxes`` (N, 6) [cx, cy, sx, sy, area, score = 1] (center and
    scale from ``xywh2cs``) and the image paths."""
    boxes, paths = [], []
    for a in gt["annotations"]:
        c, s = xywh2cs(*a["bbox"], aspect_ratio)
        boxes.append([c[0], c[1], s[0], s[1], s[0] * s[1] * 200 * 200, 1.0])
        paths.append(image_path(root, image_set, a["image_id"]))
    return np.asarray(boxes, np.float64), paths


def planted_detections(gt: dict, root: str, image_set: str,
                       aspect_ratio: float, seed: int = 0):
    """Detections near the ground truth, for an evaluation whose answer is
    known: per person the keypoints plus ~1 px of noise and 2-3 jittered
    duplicates of it (mutual OKS > 0.9: the NMS must drop them), and per
    image one detection far from everyone at a low score.  Returns
    ``(preds (N, 17, 3), all_boxes (N, 6), img_paths)``, the inputs of
    ``rescore_and_nms``; the third column of ``preds`` holds maxvals."""
    rng = np.random.RandomState(seed)
    preds, boxes, paths = [], [], []

    def add(kp_xy, bbox, img_id, box_score):
        c, s = xywh2cs(*bbox, aspect_ratio)
        kp = np.zeros((NUM_JOINTS, 3))
        kp[:, :2] = kp_xy
        kp[:, 2] = rng.uniform(0.3, 1.0, NUM_JOINTS)
        preds.append(kp)
        boxes.append([c[0], c[1], s[0], s[1], s[0] * s[1] * 200 * 200,
                      box_score])
        paths.append(image_path(root, image_set, img_id))

    by_image = {}
    for a in gt["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)
    for img_id, anns in by_image.items():
        for a in anns:
            g = np.asarray(a["keypoints"]).reshape(NUM_JOINTS, 3)
            x0, y0, w, h = a["bbox"]
            # unlabeled joints get a guess inside the box
            xy = np.where(g[:, 2:3] > 0, g[:, :2],
                          [x0 + w / 2, y0 + h / 2])
            base = xy + rng.normal(scale=1.0, size=xy.shape)
            add(base, a["bbox"], img_id, rng.uniform(0.6, 1.0))
            for _ in range(rng.randint(2, 4)):
                add(base + rng.normal(scale=0.2, size=xy.shape), a["bbox"],
                    img_id, rng.uniform(0.3, 1.0))
        far = rng.uniform([0, 0], [IMAGE_W, IMAGE_H], size=(NUM_JOINTS, 2))
        add(far, [0.0, 0.0, 80.0, 160.0], img_id, rng.uniform(0.05, 0.2))
    return np.asarray(preds), np.asarray(boxes), paths


def oks_margin(kpts_db, thresh: float) -> float:
    """Smallest |OKS - thresh| over the pairs of one image's detections,
    in float64 (``ops/nms.py::oks_iou``): float32 OKS-NMS takes the same
    decisions as the host's wherever this exceeds float32 rounding."""
    kpts = [np.asarray(k["keypoints"]).reshape(-1) for k in kpts_db]
    areas = np.asarray([k["area"] for k in kpts_db], np.float64)
    margin = np.inf
    for i in range(len(kpts) - 1):
        ovr = oks_iou(kpts[i], np.asarray(kpts[i + 1:]), areas[i],
                      areas[i + 1:])
        margin = min(margin, float(np.abs(ovr - thresh).min()))
    return margin
