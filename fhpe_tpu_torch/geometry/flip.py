"""Horizontal-flip helpers: the flip test's, on NCHW heatmaps, and the
loader's joint mirror (:func:`fliplr_joints`, a copy of
``fhpe_tpu/geometry/flip.py``'s, pinned by
``tests/test_torch_port_hygiene.py``)."""

from __future__ import annotations

import numpy as np
import torch


def flip_pair_permutation(num_joints: int, matched_parts) -> np.ndarray:
    """Joint-index permutation realizing the left/right swap."""
    perm = np.arange(num_joints)
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back_torch(output_flipped: torch.Tensor,
                    perm: torch.Tensor) -> torch.Tensor:
    """Un-flip heatmaps predicted on a mirrored image.

    ``output_flipped`` is NCHW ``(batch, joints, height, width)``: reverse
    the width (dim 3), then permute the joint dim (1) with ``perm`` from
    :func:`flip_pair_permutation` (a long tensor on the same device).
    """
    return output_flipped.flip(3).index_select(1, perm)


def fliplr_joints(joints: np.ndarray, joints_vis: np.ndarray, width: int,
                  matched_parts):
    """Mirror joint coordinates horizontally and swap left/right pairs.

    Matches transforms.py:32-46 including the ``width - x - 1`` convention and
    the final ``joints * joints_vis`` masking.  Returns new arrays.
    """
    joints = np.array(joints, copy=True)
    joints_vis = np.array(joints_vis, copy=True)
    joints[:, 0] = width - joints[:, 0] - 1
    perm = flip_pair_permutation(joints.shape[0], matched_parts)
    joints = joints[perm]
    joints_vis = joints_vis[perm]
    return joints * joints_vis, joints_vis
