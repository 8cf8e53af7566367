"""MPII dataset: db builder and PCKh evaluation (host numpy + scipy).

A copy of ``fhpe_tpu/data/mpii.py`` (``fhpe_tpu.data`` imports JAX in its
package): :func:`build_db` (the reference's ``lib/dataset/mpii.py``
index, center/scale adjustment and pickle cache), :func:`evaluate` and
their constants, pinned to the original by source equality in
``tests/test_torch_port_hygiene.py``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import OrderedDict

import numpy as np

logger = logging.getLogger(__name__)

NUM_JOINTS = 16
FLIP_PAIRS = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
PARENT_IDS = [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14]
UPPER_BODY_IDS = (7, 8, 9, 10, 11, 12, 13, 14, 15)
LOWER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6)

# gt_valid.mat joint order (mpii.py:134-147 resolves these by name; the
# indices are fixed by the MPII toolkit convention)
JOINT_NAMES = ["rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis",
               "thorax", "upper_neck", "head", "rwri", "relb", "rsho",
               "lsho", "lelb", "lwri"]


def build_db(root: str, image_set: str, data_format: str = "jpg",
             cache_root: str | None = None):
    """List of sample records (mpii.py:56-107), with optional pickle cache."""
    if cache_root:
        db_file = os.path.join(cache_root, f"mpii_cached_{image_set}_db.pkl")
        if os.path.exists(db_file):
            with open(db_file, "rb") as fd:
                return pickle.load(fd)

    file_name = os.path.join(root, "annot", image_set + ".json")
    with open(file_name) as f:
        anno = json.load(f)

    gt_db = []
    for a in anno:
        c = np.array(a["center"], dtype=np.float64)
        s = np.array([a["scale"], a["scale"]], dtype=np.float64)
        if c[0] != -1:
            c[1] = c[1] + 15 * s[1]
            s = s * 1.25
        c = c - 1  # matlab 1-based -> 0-based

        joints_3d = np.zeros((NUM_JOINTS, 3), dtype=np.float64)
        joints_3d_vis = np.zeros((NUM_JOINTS, 3), dtype=np.float64)
        if image_set != "test":
            joints = np.array(a["joints"], dtype=np.float64)
            joints[:, 0:2] = joints[:, 0:2] - 1
            joints_vis = np.array(a["joints_vis"], dtype=np.float64)
            assert len(joints) == NUM_JOINTS
            joints_3d[:, 0:2] = joints[:, 0:2]
            joints_3d_vis[:, 0] = joints_vis
            joints_3d_vis[:, 1] = joints_vis

        image_dir = "images.zip@" if data_format == "zip" else "images"
        gt_db.append({
            "image": os.path.join(root, image_dir, a["image"]),
            "center": c,
            "scale": s,
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


# PCKh protocol constants (the MPII matlab toolkit convention the reference
# transcribes, mpii.py:109-194): distances normalize by 0.6x the headbox
# diagonal; pelvis and thorax (gt-order indices 6, 7) are excluded from the
# mean; the "@0.1" summary actually reads the 0.11 bin of the PCK curve —
# index 11 of arange(0, 0.51, 0.01) — a published-code quirk we preserve
# because the README numbers (BASELINE.md) were produced with it.
PCKH_HEADSIZE_BIAS = 0.6
PCKH_THRESHOLD = 0.5
PCKH_EXCLUDED = (6, 7)          # pelvis, thorax
PCKH_AT_01_BIN = 11

# named summary rows -> joints averaged into each (left/right pairs)
PCKH_SUMMARY_GROUPS = [
    ("Head", ("head",)),
    ("Shoulder", ("lsho", "rsho")),
    ("Elbow", ("lelb", "relb")),
    ("Wrist", ("lwri", "rwri")),
    ("Hip", ("lhip", "rhip")),
    ("Knee", ("lkne", "rkne")),
    ("Ankle", ("lank", "rank")),
]


def evaluate(cfg, preds, output_dir: str | None = None):
    """PCKh evaluation against ``gt_<TEST_SET>.mat``.

    preds: (N, J, >=2) predicted joint locations in original image coords,
    0-based; converted to 1-based to match the matlab gt.  Returns
    (OrderedDict of named metrics, Mean PCKh@0.5).  Output is pinned
    bit-identical to the reference's transcription of the MPII toolkit
    (``lib/dataset/mpii.py:109-194``) by tests/test_mpii_eval_golden.py.
    """
    from scipy.io import loadmat, savemat

    preds = np.asarray(preds)[:, :, 0:2] + 1.0

    if output_dir:
        savemat(os.path.join(output_dir, "pred.mat"), mdict={"preds": preds})

    if "test" in cfg.DATASET.TEST_SET:
        return OrderedDict([("Null", 0.0)]), 0.0

    gt = loadmat(os.path.join(cfg.DATASET.ROOT, "annot",
                              f"gt_{cfg.DATASET.TEST_SET}.mat"))

    # the .mat arrays arrive joint-major: pos_gt_src (J, 2, N),
    # jnt_missing (J, N), headboxes_src (2 corners, 2, N)
    gt_xy = gt["pos_gt_src"]
    visible = 1 - gt["jnt_missing"]                        # (J, N)
    boxes = gt["headboxes_src"]

    norm_dist = (np.linalg.norm(boxes[1] - boxes[0], axis=0)
                 * PCKH_HEADSIZE_BIAS)                     # (N,) per sample
    pred_xy = np.transpose(preds, (1, 2, 0))               # -> (J, 2, N)
    # normalized radial error, zeroed where the gt joint is missing
    err = (np.linalg.norm(pred_xy - gt_xy, axis=1)
           / (norm_dist * np.ones((len(visible), 1)))) * visible  # (J, N)
    count = np.sum(visible, axis=1)                        # (J,) visible N

    def pck_at(threshold):
        hits = ((err <= threshold) * visible).sum(axis=1)
        return (100.0 * hits) / count                      # (J,) percent

    pckh = pck_at(PCKH_THRESHOLD)
    curve_bins = np.arange(0, PCKH_THRESHOLD + 0.01, 0.01)
    pck_curve = np.stack([pck_at(t) for t in curve_bins])  # (bins, J)

    # mean weights: visible-count share among the included joints only
    included = np.ones(len(count), dtype=bool)
    included[list(PCKH_EXCLUDED)] = False
    ratio = np.where(included, count, 0.0)
    ratio = ratio / np.float64(ratio.sum())

    def joint_index(name):
        # elementwise == handles both flat and nested .mat cell storage
        return np.where(gt["dataset_joints"] == name)[1][0]

    name_value = OrderedDict()
    for label, names in PCKH_SUMMARY_GROUPS:
        vals = [pckh[joint_index(n)] for n in names]
        name_value[label] = (vals[0] if len(vals) == 1
                             else 0.5 * (vals[0] + vals[1]))
    name_value["Mean"] = np.sum(pckh * ratio)
    name_value["Mean@0.1"] = np.sum(pck_curve[PCKH_AT_01_BIN] * ratio)
    return name_value, name_value["Mean"]
