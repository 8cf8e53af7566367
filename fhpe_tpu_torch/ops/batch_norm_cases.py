"""Shapes and seeded inputs for holding the train-mode BatchNorm
implementations to each other (the CPU tests hold the plan and its
arithmetic, ``chip_smoke.py`` and ``tools/profile_bn.py`` the CUDA kernels
against their plain versions).  numpy only, from a seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Shape = Tuple[int, int, int, int]

# The train-mode BatchNorm calls of one student step at batch 32, as
# {(N, C, H, W): calls}; the tests pin each to its model at batch 1.
# FPD hourglass student (hg4_128_fpd_student.yaml): 182 calls, every
# BatchNorm of the net once.
HG_STEP: Dict[Shape, int] = {
    (32, 32, 128, 128): 4, (32, 64, 64, 64): 21, (32, 128, 64, 64): 13,
    (32, 64, 32, 32): 24, (32, 128, 32, 32): 12, (32, 64, 16, 16): 24,
    (32, 128, 16, 16): 12, (32, 64, 8, 8): 24, (32, 128, 8, 8): 12,
    (32, 64, 4, 4): 24, (32, 128, 4, 4): 12}
# FPD HRNet-W32 student (w32_fpd_student.yaml): the 84 BatchNorms outside
# the branch chains (stem, layer1, transitions, fuse layers).
W32_STEP: Dict[Shape, int] = {
    (32, 64, 128, 96): 1, (32, 64, 64, 48): 9, (32, 256, 64, 48): 5,
    (32, 32, 64, 48): 1, (32, 32, 32, 24): 16, (32, 64, 32, 24): 8,
    (32, 32, 16, 12): 9, (32, 64, 16, 12): 8, (32, 128, 16, 12): 13,
    (32, 32, 8, 6): 3, (32, 64, 8, 6): 2, (32, 128, 8, 6): 2,
    (32, 256, 8, 6): 7}
# ... and the backward alone of its 208 chain BatchNorms (P5t runs their
# forward): 8 per chain, 8, 8, 7 and 3 chains on branches 0-3.
W32_CHAIN_STEP: Dict[Shape, int] = {
    (32, 32, 64, 48): 64, (32, 64, 32, 24): 64, (32, 128, 16, 12): 56,
    (32, 256, 8, 6): 24}
STEP_SHAPES = {"hourglass": HG_STEP, "w32": W32_STEP}
# Edge cases: H*W not a whole number of 16-byte units (single values), one
# value per sample, one sample, a channel count past the plan's target, and
# more values per channel than any student step.
EDGE_SHAPES = [(3, 5, 7, 9), (4, 3, 1, 1), (1, 7, 3, 5), (2, 2000, 2, 4),
               (5, 6, 6, 10), (64, 8, 128, 128)]


def bn_inputs(n: int, c: int, h: int, w: int, seed: int = 0):
    """``(x, dy, gamma, beta, running_mean, running_var)``, float32: x
    normal around a per-channel offset of up to 3 (so the statistics'
    shift matters) and scale of 0.5 to 2, dy standard normal, gamma
    uniform(0.5, 1.5), beta normal(0, 0.3), running statistics as a
    model's after calibration."""
    rng = np.random.RandomState(seed)
    loc = rng.uniform(-3, 3, (1, c, 1, 1))
    scale = rng.uniform(0.5, 2.0, (1, c, 1, 1))
    x = (rng.randn(n, c, h, w) * scale + loc).astype(np.float32)
    dy = rng.randn(n, c, h, w).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.3, c).astype(np.float32)
    running_mean = rng.normal(0, 0.1, c).astype(np.float32)
    running_var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, dy, gamma, beta, running_mean, running_var
