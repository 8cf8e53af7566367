"""COCO keypoints dataset on the host: annotation index, db builders (gt
and detector boxes), bbox -> center/scale, rescoring + OKS-NMS, results
JSON.

A copy of ``fhpe_tpu/data/coco.py`` (importing ``fhpe_tpu.data`` pulls in
JAX), pinned equal to it by ``tests/test_torch_port_hygiene.py``.  One
change: the hard OKS-NMS of :func:`rescore_and_nms` runs on ``device``
for all images at once through
``ops/nms_torch.py::oks_nms_device_batched`` (one launch of the segmented
OKS-NMS kernel), the batched form of the drop-in ``fhpe_tpu`` ships for
the host ``oks_nms``; its keep-lists equal the host's wherever no OKS lies
within float32 rounding of ``oks_thre``.  Soft OKS-NMS stays on the host.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import defaultdict

import numpy as np

logger = logging.getLogger(__name__)

NUM_JOINTS = 17
FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]
UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
LOWER_BODY_IDS = (11, 12, 13, 14, 15, 16)
JOINTS_WEIGHT = np.array(
    [1., 1., 1., 1., 1., 1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1., 1.2, 1.2,
     1.5, 1.5], dtype=np.float32).reshape((NUM_JOINTS, 1))


class CocoIndex:
    """Minimal COCO person-keypoints annotation index (no pycocotools)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data.get("images", [])}
        self.img_ids = sorted(self.images)
        self.anns = {a["id"]: a for a in data.get("annotations", [])}
        self.img_to_anns = defaultdict(list)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.person_cat_id = next(
            (cid for cid, c in self.cats.items() if c["name"] == "person"), 1)

    def annotations(self, img_id, iscrowd: bool | None = False):
        anns = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]


def xywh2cs(x, y, w, h, aspect_ratio, pixel_std: float = 200.0):
    """bbox -> (center, scale) with aspect fix and *1.25 (coco.py:227-242)."""
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    if center[0] != -1:
        scale = scale * 1.25
    return center, scale


def image_path_from_index(root, image_set, index, data_format="jpg"):
    """images/<set>/%012d.jpg path convention (coco.py:244-257)."""
    file_name = "%012d.jpg" % index
    if "2014" in image_set:
        file_name = "COCO_%s_" % image_set + file_name
    prefix = "test2017" if "test" in image_set else image_set
    data_name = prefix + ".zip@" if data_format == "zip" else prefix
    return os.path.join(root, "images", data_name, file_name)


def _ann_file(root, image_set):
    prefix = ("person_keypoints" if "test" not in image_set else "image_info")
    return os.path.join(root, "annotations", f"{prefix}_{image_set}.json")


def build_gt_db(root, image_set, aspect_ratio, data_format="jpg",
                cache_root=None, coco: CocoIndex | None = None):
    """Ground-truth-bbox db (coco.py:149-221)."""
    if cache_root:
        db_file = os.path.join(cache_root, f"coco_cached_{image_set}_db.pkl")
        if os.path.exists(db_file):
            with open(db_file, "rb") as fd:
                return pickle.load(fd)

    coco = coco or CocoIndex(_ann_file(root, image_set))
    gt_db = []
    for index in coco.img_ids:
        im = coco.images[index]
        width, height = im["width"], im["height"]
        for obj in coco.annotations(index, iscrowd=False):
            if obj.get("category_id") != coco.person_cat_id:
                continue
            x, y, w, h = obj["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if obj.get("area", 0) <= 0 or x2 < x1 or y2 < y1:
                continue
            if max(obj["keypoints"]) == 0:
                continue

            joints_3d = np.zeros((NUM_JOINTS, 3), dtype=np.float64)
            joints_3d_vis = np.zeros((NUM_JOINTS, 3), dtype=np.float64)
            kp = obj["keypoints"]
            for i in range(NUM_JOINTS):
                joints_3d[i, 0] = kp[i * 3 + 0]
                joints_3d[i, 1] = kp[i * 3 + 1]
                vis = min(kp[i * 3 + 2], 1)
                joints_3d_vis[i, 0] = vis
                joints_3d_vis[i, 1] = vis

            center, scale = xywh2cs(x1, y1, x2 - x1, y2 - y1, aspect_ratio)
            gt_db.append({
                "image": image_path_from_index(root, image_set, index,
                                               data_format),
                "center": center,
                "scale": scale,
                "joints_3d": joints_3d,
                "joints_3d_vis": joints_3d_vis,
                "filename": "",
                "imgnum": 0,
            })

    if cache_root:
        os.makedirs(cache_root, exist_ok=True)
        with open(db_file, "wb") as fd:
            pickle.dump(gt_db, fd)
    return gt_db


def build_detection_db(root, image_set, bbox_file, aspect_ratio,
                       image_thre=0.0, data_format="jpg"):
    """Detector-bbox db for top-down eval (coco.py:259-300)."""
    with open(bbox_file) as f:
        all_boxes = json.load(f)
    kpt_db = []
    for det in all_boxes:
        if det["category_id"] != 1:
            continue
        if det["score"] < image_thre:
            continue
        center, scale = xywh2cs(*det["bbox"][:4], aspect_ratio)
        kpt_db.append({
            "image": image_path_from_index(root, image_set, det["image_id"],
                                           data_format),
            "center": center,
            "scale": scale,
            "score": det["score"],
            "joints_3d": np.zeros((NUM_JOINTS, 3), dtype=np.float64),
            "joints_3d_vis": np.ones((NUM_JOINTS, 3), dtype=np.float64),
        })
    logger.info("=> total boxes after score filter @%s: %d", image_thre,
                len(kpt_db))
    return kpt_db


def rescore_and_nms(preds, all_boxes, img_paths, num_joints=NUM_JOINTS,
                    in_vis_thre=0.0, oks_thre=0.9, soft=False,
                    device="cuda"):
    """Group per image, rescore, OKS-NMS (coco.py:318-369).

    preds: (N, J, 3); all_boxes: (N, 6) [cx, cy, sx, sy, area, score];
    img_paths: list of image paths (image id parsed from the tail).
    The hard NMS runs on ``device`` (``oks_nms_device_batched``), one
    launch for all images.
    Returns list-of-images, each a list of kept kpt dicts.
    """
    from ..ops.nms import soft_oks_nms
    from ..ops.nms_torch import oks_nms_device_batched

    kpts = defaultdict(list)
    for idx, kpt in enumerate(preds):
        kpts[int(img_paths[idx][-16:-4])].append({
            "keypoints": kpt,
            "center": all_boxes[idx][0:2],
            "scale": all_boxes[idx][2:4],
            "area": all_boxes[idx][4],
            "score": all_boxes[idx][5],
            "image": int(img_paths[idx][-16:-4]),
        })

    groups = list(kpts.values())
    for img_kpts in groups:
        for p in img_kpts:
            box_score = p["score"]
            ks = [p["keypoints"][j][2] for j in range(num_joints)
                  if p["keypoints"][j][2] > in_vis_thre]
            kpt_score = (sum(ks) / len(ks)) if ks else 0
            p["score"] = kpt_score * box_score
    if soft:
        keeps = [soft_oks_nms(img_kpts, oks_thre) for img_kpts in groups]
    else:
        keeps = oks_nms_device_batched(groups, oks_thre, device=device)
    return [img_kpts if len(keep) == 0 else [img_kpts[k] for k in keep]
            for img_kpts, keep in zip(groups, keeps)]


def write_results_json(oks_nmsed_kpts, res_file, num_joints=NUM_JOINTS,
                       cat_id=1):
    """COCO results JSON (coco.py:381-442)."""
    results = []
    for img_kpts in oks_nmsed_kpts:
        if len(img_kpts) == 0:
            continue
        for k in img_kpts:
            kp = np.asarray(k["keypoints"], dtype=np.float64)[:, :3]
            results.append({
                "image_id": k["image"],
                "category_id": cat_id,
                "keypoints": [float(v) for v in kp.flatten()],
                "score": float(k["score"]),
                "center": [float(v) for v in k["center"]],
                "scale": [float(v) for v in k["scale"]],
            })
    os.makedirs(os.path.dirname(res_file), exist_ok=True)
    with open(res_file, "w") as f:
        json.dump(results, f, sort_keys=True, indent=4)
    return results
