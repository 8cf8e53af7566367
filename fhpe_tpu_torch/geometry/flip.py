"""Horizontal-flip helpers for the flip test, on NCHW heatmaps."""

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
