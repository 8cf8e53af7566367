"""Chain shapes and seeded inputs for holding the P5 implementations to
each other (the CPU tests against ``fhpe_tpu``'s ``chain_reference`` and
``chain_pallas``, ``chip_smoke.py`` the CUDA kernels against their plain
versions).  numpy only, from a seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Every branch chain of HRNet-W32 and W48 at 256x192, batch 32: (B, C, H, W)
# of the four branches (4 blocks each in stages 2-4).
W32_SHAPES = [(32, 32, 64, 48), (32, 64, 32, 24), (32, 128, 16, 12),
              (32, 256, 8, 6)]
W48_SHAPES = [(32, 48, 64, 48), (32, 96, 32, 24), (32, 192, 16, 12),
              (32, 384, 8, 6)]
BLOCKS = 4
# Chains per branch in one HRNet forward: stages 2, 3 and 4 have 1, 4 and
# 3 modules of 2, 3 and 4 branches, so 26 chains.
BRANCH_CHAINS = (8, 8, 7, 3)
# Edge cases (B, C, H, W, blocks): one sample, a 1x1 image (only the centre
# tap sees data), odd batch and sides, channels that fill no tile evenly, a
# row longer than a pixel tile.
EDGE_CASES = [(1, 8, 1, 1, 1), (3, 8, 5, 7, 2), (1, 32, 64, 48, 4),
              (3, 40, 9, 6, 3), (2, 72, 3, 130, 1)]


def chain_params(c: int, blocks: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One chain's parameters, float32: ``weights`` (2 blocks, C, C, 3, 3)
    He-scale normal, BatchNorm ``gammas`` uniform(0.5, 1.5) and ``betas``
    normal(0, 0.1), (2 blocks, C)."""
    rng = np.random.RandomState(seed)
    n = 2 * blocks
    return {"weights": (rng.randn(n, c, c, 3, 3) * np.sqrt(2.0 / (9 * c))
                        ).astype(np.float32),
            "gammas": rng.uniform(0.5, 1.5, (n, c)).astype(np.float32),
            "betas": rng.normal(0, 0.1, (n, c)).astype(np.float32)}


def chain_input(b: int, c: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """A chain input as HRNet feeds one: a ReLU output (about half zeros),
    float32 (B, C, H, W)."""
    x = np.random.RandomState(seed).randn(b, c, h, w)
    return np.maximum(x, 0).astype(np.float32)
