"""Inputs with planted edge cases for holding the 3x3 filter-gradient
implementations to each other (the CPU tests against ``fhpe_tpu``'s
``dw_pallas``, ``chip_smoke.py`` the CUDA kernel against its plain
version).  numpy only, from a seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Every 3x3 stride-1 conv of the FPD hourglass student (hg4_128) at batch
# 32: (B, C, H, W) of its Bottleneck conv2s (stem layer1 at 128x128 with
# C = 32; layer2, layer3 and the hourglass levels at 64 ... 4 with C = 64).
STUDENT_SHAPES = [(32, 32, 128, 128), (32, 64, 64, 64), (32, 64, 32, 32),
                  (32, 64, 16, 16), (32, 64, 8, 8), (32, 64, 4, 4)]
# The (B, C, H, W) multisets P4 gets in one bf16 train step at batch 32,
# as {shape: launches}; the tests pin each to its model at batch 1.
# FPD hourglass student (hg4_128_fpd_student.yaml): 59 launches.
HG_STEP = {(32, 32, 128, 128): 1, (32, 64, 64, 64): 10, (32, 64, 32, 32): 12,
           (32, 64, 16, 16): 12, (32, 64, 8, 8): 12, (32, 64, 4, 4): 12}
# FPD HRNet-W32 student (w32_fpd_student.yaml): the branch chains'
# backward (8 per chain, 26 chains) and layer1's 4 Bottleneck conv2s.
W32_STEP = {(32, 32, 64, 48): 64, (32, 64, 64, 48): 4, (32, 64, 32, 24): 64,
            (32, 128, 16, 12): 56, (32, 256, 8, 6): 24}
# PoseResNet-50 (res50_256x192_d256x3_adam_lr1e-3.yaml): the Bottleneck
# conv2s of stride 1 in layers 1-4.
RN50_STEP = {(32, 64, 64, 48): 3, (32, 128, 32, 24): 3, (32, 256, 16, 12): 5,
             (32, 512, 8, 6): 2}
STEP_SHAPES = {"hourglass": HG_STEP, "w48_w32": W32_STEP, "rn50": RN50_STEP}
# Edge cases: one sample, a 1x1 image (only the centre tap sees data),
# non-square and odd sides, fewer channels than a tile.
EDGE_SHAPES = [(1, 64, 64, 64), (3, 16, 1, 1), (2, 8, 7, 9), (5, 8, 3, 2)]
# Wider than the kernel's column span, as many channels as RN-50's widest,
# and even widths of 2 mod 4 whose whole-row run tiles are all too large
# (the bf16 plan takes halo columns there): the cases the step sets do not
# reach.
WIDE_SHAPES = [(2, 16, 5, 300), (2, 512, 4, 4), (2, 64, 4, 126),
               (2, 32, 8, 82)]

Case = Tuple[str, np.ndarray, np.ndarray]


def planted_wgrad_cases(b: int, c: int, h: int, w: int,
                        seed: int = 0) -> List[Case]:
    """``[(name, x, dy)]``, float32 (B, C, H, W) NCHW:

    * ``noise``: x and dy standard normal;
    * ``border``: x zero but for its four corners and four edge midpoints
      (distinct values per channel), dy ones: every value of dW comes
      from the zero padding's edge, where a shifted tap falls off the image;
    * ``zero dy``: dW must be exactly 0.
    """
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    dy = rng.randn(b, c, h, w).astype(np.float32)
    border = np.zeros_like(x)
    for k, (py, px) in enumerate([(0, 0), (0, w - 1), (h - 1, 0),
                                  (h - 1, w - 1), (0, w // 2), (h - 1, w // 2),
                                  (h // 2, 0), (h // 2, w - 1)]):
        border[:, :, py, px] += (k + 1) * (1.0 + np.arange(c)[None, :] / c)
    return [("noise", x, dy),
            ("border", border, np.ones_like(dy)),
            ("zero dy", x, np.zeros_like(dy))]
