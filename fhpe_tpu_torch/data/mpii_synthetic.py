"""Synthetic MPII ground truth (``annot/gt_<set>.mat`` in the MPII
toolkit's schema) for checking PCKh evaluation without the dataset (the
CPU tests against ``fhpe_tpu``, ``chip_smoke.py`` on the card).  numpy and
scipy only, from a seed; no images.
"""

from __future__ import annotations

import os

import numpy as np

from .mpii import JOINT_NAMES, NUM_JOINTS

IMAGE_W, IMAGE_H = 720, 576
HEADBOX = 60.0     # side of the square headbox: PCKh@0.5 allows ~25 px


def synthetic_mpii_gt(num_people: int, seed: int = 0) -> dict:
    """One person per row: ``pos_gt_src`` (J, 2, N) 1-based joint
    positions, ``jnt_missing`` (J, N) (about one joint in eight missing,
    none missing in the first row so every joint is counted),
    ``headboxes_src`` (2, 2, N) a ``HEADBOX``-px square around the head."""
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.uniform(40, IMAGE_W - 40, (NUM_JOINTS, num_people)),
                    rng.uniform(40, IMAGE_H - 40, (NUM_JOINTS, num_people))],
                   axis=1)
    missing = (rng.uniform(size=(NUM_JOINTS, num_people)) < 0.125)
    missing[:, 0] = False
    head = pos[JOINT_NAMES.index("head")]                  # (2, N)
    boxes = np.stack([head - HEADBOX / 2, head + HEADBOX / 2])
    return {"pos_gt_src": pos, "jnt_missing": missing.astype(np.float64),
            "headboxes_src": boxes}


def write_mpii_gt(root: str, image_set: str, gt: dict) -> str:
    """Write ``gt`` where the evaluator looks for it:
    ``<root>/annot/gt_<image_set>.mat``."""
    from scipy.io import savemat

    names = np.zeros((1, NUM_JOINTS), dtype=object)
    for j, name in enumerate(JOINT_NAMES):
        names[0, j] = name
    path = os.path.join(root, "annot", f"gt_{image_set}.mat")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    savemat(path, {"dataset_joints": names, **gt})
    return path


def preds_at_gt(gt: dict, offset_px: float = 0.0,
                seed: int = 0) -> np.ndarray:
    """(N, J, 3) predictions in the evaluator's 0-based frame: the ground
    truth moved ``offset_px`` in a random direction per joint, confidence
    1.  ``offset_px = 0`` gives PCKh 100 on every joint."""
    rng = np.random.RandomState(seed)
    xy = np.transpose(gt["pos_gt_src"], (2, 0, 1)) - 1.0   # (N, J, 2)
    angle = rng.uniform(0, 2 * np.pi, xy.shape[:2])
    xy = xy + offset_px * np.stack([np.cos(angle), np.sin(angle)], -1)
    return np.concatenate([xy, np.ones(xy.shape[:2] + (1,))], -1)
