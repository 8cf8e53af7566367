"""MPII PCKh evaluation (host numpy + scipy).

A copy of ``evaluate`` and its constants from ``fhpe_tpu/data/mpii.py``
(``fhpe_tpu.data`` imports JAX in its package), pinned to the original by
source equality in ``tests/test_torch_port_hygiene.py``.  The db builder
comes with the port's CLI slice (``ROADMAP.md`` queue A, item 7).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

NUM_JOINTS = 16
FLIP_PAIRS = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]

# gt_valid.mat joint order (mpii.py:134-147 resolves these by name; the
# indices are fixed by the MPII toolkit convention)
JOINT_NAMES = ["rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis",
               "thorax", "upper_neck", "head", "rwri", "relb", "rsho",
               "lsho", "lelb", "lwri"]


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
