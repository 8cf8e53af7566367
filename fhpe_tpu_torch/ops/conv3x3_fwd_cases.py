"""Shapes and seeded inputs for holding the 3x3 conv implementations to
each other (the CPU tests against the Pallas probes P1-P3 and
``lax.conv``, ``chip_smoke.py`` the CUDA kernel against its plain
version), and the one-ulp bar of a bfloat16 output.  numpy and torch
only, inputs from a seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# The stride-1 3x3 convs of PoseResNet-50 at 256x192, batch 32: (B, C, H,
# W) of each layer's Bottleneck conv2 (3, 3, 5 and 2 of them).
RN50_SHAPES = [(32, 64, 64, 48), (32, 128, 32, 24), (32, 256, 16, 12),
               (32, 512, 8, 6)]
RN50_COUNTS = [3, 3, 5, 2]
# The probes' own shape, (B, H, W, C) = (64, 64, 48, 32), as NCHW.
PROBE_SHAPE = (64, 32, 64, 48)
# Edge cases: one sample and three, channels that fill no tile evenly (8,
# 40), a 1x1 image (only the centre tap sees data), a row longer than a
# pixel tile, odd sides.
EDGE_SHAPES = [(1, 8, 1, 1), (3, 40, 9, 6), (1, 64, 64, 48), (2, 8, 3, 130),
               (3, 8, 5, 7)]
# Wide cases for the bf16 kernel's tiles: rows wider than one column tile
# (W = 200, 258), odd W, channels that fill no 16- or 32-channel step (24,
# 72) or no 8-channel vector (20, 12: the weights load element by
# element), several whole images per tile (5 x 3x3), and C = 1024.
WIDE_SHAPES = [(2, 24, 7, 200), (3, 72, 11, 13), (1, 20, 6, 258),
               (5, 12, 3, 3), (2, 1024, 4, 5)]

Case = Tuple[str, np.ndarray, np.ndarray]


def conv_cases(b: int, c: int, h: int, w: int, seed: int = 0) -> List[Case]:
    """``[(name, x, weight)]``, float32, x (B, C, H, W), weight OIHW:

    * ``relu``: x a ReLU output (about half zeros, as every conv2 of a
      Bottleneck takes), weights He-scale normal;
    * ``border``: x zero but for its four corners and four edge midpoints,
      so every tap that reaches data sits beside the zero padding;
    * ``zero weights``: y must be exactly 0.
    """
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(b, c, h, w), 0).astype(np.float32)
    wt = (rng.randn(c, c, 3, 3) * np.sqrt(2.0 / (9 * c))).astype(np.float32)
    border = np.zeros_like(x)
    for k, (py, px) in enumerate([(0, 0), (0, w - 1), (h - 1, 0),
                                  (h - 1, w - 1), (0, w // 2), (h - 1, w // 2),
                                  (h // 2, 0), (h // 2, w - 1)]):
        border[:, :, py, px] += (k + 1) * (1.0 + np.arange(c)[None, :] / c)
    return [("relu", x, wt), ("border", border, wt),
            ("zero weights", x, np.zeros_like(wt))]


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of ``ref`` (8 significant bits):
    ``2 ** (floor(log2 |ref|) - 7)``, and the smallest subnormal at 0."""
    a = ref.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                       torch.full_like(a, 2.0 ** -133))


def within_bf16_ulp(got: torch.Tensor, ref: torch.Tensor,
                    slack: float = 0.0) -> bool:
    """Every value of ``got`` within one bfloat16 ulp of ``ref``'s, plus
    ``slack``: two float32 sums that differ by d round to bfloat16 values
    at most one ulp plus d apart."""
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= bf16_ulp(ref) + slack).all())
