"""Heatmaps with planted edge cases for holding decode implementations
to each other (the CPU tests against ``fhpe_tpu``, ``chip_smoke.py`` the
CUDA kernel against its plain version).  numpy only, from a seed.
"""

from __future__ import annotations

import numpy as np


def planted_heatmaps(b: int, j: int, h: int, w: int,
                     seed: int = 0) -> np.ndarray:
    """(b, j, h, w) float32 NCHW: Gaussian noise with rows that hold

    * an all-tie row (all zeros: peak 0 is masked, argmax is index 0);
    * a positive all-tie row (argmax index 0, no offset);
    * a non-positive row (masked coords);
    * a plateau of equal maxima (the first in row-major order wins);
    * two equal far-apart peaks (the first wins);
    * a peak with equal left/right and up/down neighbours (sign 0);
    * peaks at every border combination px, py in {0, 1, size-2, size-1}.

    Needs ``b * j >= 22`` rows for every case; later cases are dropped
    on fewer rows.
    """
    rng = np.random.RandomState(seed)
    hm = rng.randn(b, j, h, w).astype(np.float32)

    def plateau(r):
        r[h // 3:h // 3 + 2, w // 3:w // 3 + 3] = 7.0

    def twin_peaks(r):
        r[h - 2, w - 2] = 9.0
        r[1, 1] = 9.0

    def flat_neighbours(r):
        cy, cx = h // 2, w // 2
        r[cy, cx] = 8.0
        if 0 < cx < w - 1:
            r[cy, cx - 1] = r[cy, cx + 1] = 3.0
        if 0 < cy < h - 1:
            r[cy - 1, cx] = r[cy + 1, cx] = 3.0

    def border(py, px):
        def plant(r):
            r[py, px] = 10.0
        return plant

    cases = [lambda r: r.fill(0.0), lambda r: r.fill(0.5),
             lambda r: np.negative(np.abs(r), out=r),
             plateau, twin_peaks, flat_neighbours]
    for py in sorted({0, min(1, h - 1), max(h - 2, 0), h - 1}):
        for px in sorted({0, min(1, w - 1), max(w - 2, 0), w - 1}):
            cases.append(border(py, px))

    for row, plant in zip(hm.reshape(b * j, h, w), cases):
        plant(row)
    return hm


def decision_margin(hm: np.ndarray) -> np.ndarray:
    """(B, J) smallest margin of the decode's decisions on each heatmap.

    The decisions are the argmax (top-2 gap), the <= 0 mask (|peak|) and,
    where the quarter offset applies, the two neighbour signs.  Two
    heatmaps closer than the margin decode identically.
    """
    b, j, h, w = hm.shape
    flat = hm.reshape(b * j, h * w)
    top2 = np.sort(flat, axis=1)[:, -2:]
    idx = flat.argmax(axis=1)
    px, py = idx % w, idx // w
    interior = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    r = np.arange(b * j)
    nb = np.clip(np.stack([idx + 1, idx - 1, idx + w, idx - w]), 0,
                 h * w - 1)
    dx = np.abs(flat[r, nb[0]] - flat[r, nb[1]])
    dy = np.abs(flat[r, nb[2]] - flat[r, nb[3]])
    margin = np.minimum(top2[:, 1] - top2[:, 0], np.abs(top2[:, 1]))
    margin = np.where(interior, np.minimum(margin, np.minimum(dx, dy)),
                      margin)
    return margin.reshape(b, j)
