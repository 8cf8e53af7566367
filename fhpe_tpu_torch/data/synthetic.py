"""Synthetic pose datasets on disk, for hermetic tests and smoke runs.

A port of ``fhpe_tpu/data/synthetic.py``: deterministic images with bright
disks at joint locations plus db records in the exact format of the
MPII/COCO builders, so train/eval runs need no downloaded data.  The same
records, the same RNG draws in the same order and the same files as
``fhpe_tpu``'s; the disks and the JPEGs come from the port's image library
(``ops/native_image.py::fill_disk`` and ``imwrite`` in place of
``cv2.circle`` and ``cv2.imwrite``; ``tests/test_torch_image.py``).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..ops.native_image import fill_disk, imwrite


def make_synthetic_db(out_dir: str, num_samples: int = 16,
                      num_joints: int = 16, image_hw: Tuple[int, int] = (256, 256),
                      seed: int = 0) -> List[dict]:
    """Write jpg images with disk-marked joints; return db records."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    h, w = image_hw
    db = []
    for i in range(num_samples):
        img = rng.randint(0, 40, size=(h, w, 3), dtype=np.uint8)
        joints_3d = np.zeros((num_joints, 3))
        joints_3d_vis = np.zeros((num_joints, 3))
        margin = min(40, h // 4, w // 4)
        for j in range(num_joints):
            x = rng.randint(margin, w - margin)
            y = rng.randint(margin, h - margin)
            color = (int(80 + 10 * j), int(255 - 10 * j), 200)
            fill_disk(img, (x, y), color)
            joints_3d[j, :2] = (x, y)
            joints_3d_vis[j, :2] = 1
        path = os.path.join(out_dir, f"synt_{i:06d}.jpg")
        imwrite(path, img)

        center = np.array([w / 2, h / 2], dtype=np.float64)
        scale = np.array([w / 200.0, h / 200.0], dtype=np.float64)
        db.append({
            "image": path,
            "center": center,
            "scale": scale,
            "joints_3d": joints_3d,
            "joints_3d_vis": joints_3d_vis,
            "filename": "",
            "imgnum": 0,
        })
    return db


def make_synthetic_mpii(root: str, image_set: str = "synval",
                        num_images: int = 64,
                        image_hw: Tuple[int, int] = (256, 256),
                        seed: int = 0) -> str:
    """Write an MPII-FORMAT synthetic dataset (images + annot json + gt mat).

    Produces the on-disk layout the real MPII pipeline consumes —
    ``<root>/images/*.jpg``, ``<root>/annot/<set>.json`` (1-based coords,
    pre-compensated for the builder's ``center[1] += 15*scale`` shift,
    reference lib/dataset/mpii.py:60-66), and ``<root>/annot/
    gt_<set>.mat`` in the MPII-toolkit schema (dataset_joints /
    jnt_missing / pos_gt_src / headboxes_src, lib/dataset/mpii.py:125-137)
    — so training + evaluation run the full stack: ``build_db`` ->
    augment/warp -> train -> decode -> ``evaluate()`` PCKh against the
    .mat ground truth.  One disk-marked 16-joint person per image; the
    headbox is a fixed 60px box around the head joint (PCKh threshold
    0.6 * ||(60,60)|| * 0.5 ~ 25 px).  Returns the annot json path.
    ``image_set`` must not contain "test" (test sets skip evaluation).
    """
    import json
    from scipy.io import savemat

    from .mpii import JOINT_NAMES

    assert "test" not in image_set
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annot")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    h, w = image_hw
    num_joints = 16

    anno = []
    pos_gt = np.zeros((num_joints, 2, num_images))
    headboxes = np.zeros((2, 2, num_images))
    for i in range(num_images):
        img = rng.randint(0, 40, size=(h, w, 3), dtype=np.uint8)
        margin = min(40, h // 4, w // 4)
        # The MPII scale below is height-derived (s = h/200), so the square
        # 250*s crop window spans only +-0.625*h around the center in x; for
        # wide images (w > 1.25*h) joints near the left/right margins would
        # fall outside the crop, breaking the overfit/containment guarantees.
        half_w = 0.625 * h
        x_lo = max(margin, int(w / 2.0 - half_w) + 8)
        x_hi = min(w - margin, int(w / 2.0 + half_w) - 8)
        assert x_lo < x_hi, f"image_hw {image_hw} leaves no in-crop x range"
        joints = np.zeros((num_joints, 2))
        for j in range(num_joints):
            x = int(rng.randint(x_lo, x_hi))
            y = int(rng.randint(margin, h - margin))
            color = (int(80 + 10 * j), int(255 - 10 * j), 200)
            fill_disk(img, (x, y), color)
            joints[j] = (x, y)
        name = f"synt_{i:06d}.jpg"
        imwrite(os.path.join(img_dir, name), img)

        s_json = h / 200.0
        # 1-based json coords; center[1] pre-compensates the builder's
        # +15*scale head-room shift so the effective crop stays centered
        anno.append({
            "image": name,
            "center": [w / 2.0 + 1.0, h / 2.0 + 1.0 - 15.0 * s_json],
            "scale": s_json,
            "joints": (joints + 1.0).tolist(),
            "joints_vis": [1] * num_joints,
        })
        pos_gt[:, :, i] = joints + 1.0           # matlab 1-based
        head = joints[JOINT_NAMES.index("head")] + 1.0
        headboxes[0, :, i] = head - 30.0
        headboxes[1, :, i] = head + 30.0

    ann_file = os.path.join(ann_dir, f"{image_set}.json")
    with open(ann_file, "w") as f:
        json.dump(anno, f)

    joint_names = np.zeros((1, num_joints), dtype=object)
    for j, nm in enumerate(JOINT_NAMES):
        joint_names[0, j] = nm
    savemat(os.path.join(ann_dir, f"gt_{image_set}.mat"),
            {"dataset_joints": joint_names,
             "jnt_missing": np.zeros((num_joints, num_images)),
             "pos_gt_src": pos_gt,
             "headboxes_src": headboxes})
    return ann_file


def make_synthetic_coco(root: str, image_set: str = "synval2017",
                        num_images: int = 64,
                        image_hw: Tuple[int, int] = (256, 256),
                        seed: int = 0) -> str:
    """Write a COCO-FORMAT synthetic dataset (images + annotation JSON).

    Unlike :func:`make_synthetic_db` (which returns db records directly),
    this produces the on-disk layout the real COCO pipeline consumes —
    ``<root>/images/<set>/%012d.jpg`` + ``<root>/annotations/
    person_keypoints_<set>.json`` (reference path conventions,
    lib/dataset/coco.py:244-257,434-442) — so training + evaluation run
    the full stack: ``build_gt_db`` -> augment/warp -> train -> decode ->
    rescoring -> OKS-NMS -> results JSON -> ``CocoKeypointEval`` AP.
    One disk-marked 17-keypoint person per image.  Returns the annotation
    file path.  NOTE: ``image_set`` must not contain "test" ("test" sets
    switch the loaders to image_info annotations).
    """
    import json

    assert "test" not in image_set
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images", image_set)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    h, w = image_hw

    images, annotations = [], []
    for i in range(num_images):
        img_id = i + 1
        img = rng.randint(0, 40, size=(h, w, 3), dtype=np.uint8)
        # person region: a generous box away from the borders
        margin = min(40, h // 4, w // 4)
        kps = []
        xs, ys = [], []
        for j in range(17):
            x = int(rng.randint(margin, w - margin))
            y = int(rng.randint(margin, h - margin))
            color = (int(80 + 10 * j), int(255 - 10 * j), 200)
            fill_disk(img, (x, y), color)
            kps += [x, y, 2]           # v=2: labeled and visible
            xs.append(x)
            ys.append(y)
        imwrite(os.path.join(img_dir, "%012d.jpg" % img_id), img)
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": "%012d.jpg" % img_id})
        bx, by = max(0, min(xs) - 12), max(0, min(ys) - 12)
        bw = min(w - 1, max(xs) + 12) - bx
        bh = min(h - 1, max(ys) + 12) - by
        annotations.append({
            "id": img_id, "image_id": img_id, "category_id": 1,
            "bbox": [float(bx), float(by), float(bw), float(bh)],
            "area": float(bw * bh), "iscrowd": 0,
            "keypoints": kps, "num_keypoints": 17,
        })

    ann_file = os.path.join(ann_dir, f"person_keypoints_{image_set}.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return ann_file
