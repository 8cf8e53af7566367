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
# Edge cases: one sample, a 1x1 image (only the centre tap sees data),
# non-square and odd sides, fewer channels than a tile.
EDGE_SHAPES = [(1, 64, 64, 64), (3, 16, 1, 1), (2, 8, 7, 9), (5, 8, 3, 2)]

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
