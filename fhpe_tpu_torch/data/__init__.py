"""Dataset constants the serving path needs: joint counts and flip pairs.

A copy of those entries of ``fhpe_tpu.data.dataset_meta`` and the COCO
constants (``fhpe_tpu/data/coco.py``); the MPII ones come from this
package's copy of ``fhpe_tpu/data/mpii.py``.  Importing ``fhpe_tpu.data``
pulls in its loader, which imports JAX.
"""

from __future__ import annotations

from .mpii import FLIP_PAIRS as MPII_FLIP_PAIRS
from .mpii import NUM_JOINTS as MPII_NUM_JOINTS

COCO_NUM_JOINTS = 17
COCO_FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]


def dataset_meta(name: str) -> dict:
    """Per-dataset ``num_joints`` and ``flip_pairs``."""
    if name == "synthetic":  # hermetic smoke dataset (MPII-shaped)
        return dataset_meta("mpii")
    if name == "mpii":
        return {"num_joints": MPII_NUM_JOINTS, "flip_pairs": MPII_FLIP_PAIRS}
    if name == "coco":
        return {"num_joints": COCO_NUM_JOINTS, "flip_pairs": COCO_FLIP_PAIRS}
    raise KeyError(f"unknown DATASET.DATASET '{name}'")


__all__ = ["dataset_meta"]
