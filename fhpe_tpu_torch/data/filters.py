"""Dataset filtering: the ks-metric sample selector.

A copy of ``fhpe_tpu/data/filters.py``, pinned to it by
``tests/test_torch_port_hygiene.py``.

Behavioral equivalent of ``JointsDataset.select_data``
(JointsDataset.py:200-231): keeps samples whose visible-joint centroid is
close to the box center under a Gaussian kernel of the box area, with the
reference's exact metric threshold ``(0.2/16)*num_vis + 0.45 - 0.2/16``.
Applied when ``DATASET.SELECT_DATA`` is true.
"""

from __future__ import annotations

from typing import List

import numpy as np

PIXEL_STD = 200.0


def select_data(db: List[dict]) -> List[dict]:
    selected = []
    for rec in db:
        joints = np.asarray(rec["joints_3d"])
        vis = np.asarray(rec["joints_3d_vis"])
        mask = vis[:, 0] > 0
        num_vis = int(mask.sum())
        if num_vis == 0:
            continue
        joints_center = joints[mask, :2].mean(axis=0)
        bbox_center = np.asarray(rec["center"], dtype=np.float64)
        area = rec["scale"][0] * rec["scale"][1] * (PIXEL_STD ** 2)
        diff_norm2 = np.linalg.norm(joints_center - bbox_center, 2)
        ks = np.exp(-1.0 * (diff_norm2 ** 2) / ((0.2 ** 2) * 2.0 * area))
        metric = (0.2 / 16) * num_vis + 0.45 - 0.2 / 16
        if ks > metric:
            selected.append(rec)
    return selected
