"""Detections with planted edge cases for holding the NMS implementations
to each other (the CPU tests against ``fhpe_tpu``, ``chip_smoke.py`` the
CUDA kernels against their plain versions).  numpy only, from a seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Case = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _person(rng, joints: int) -> np.ndarray:
    base = rng.uniform(50, 600, size=(1, 2))
    return base + rng.normal(scale=rng.uniform(10, 60), size=(joints, 2))


def planted_nms_cases(n: int, seed: int = 0, joints: int = 17) -> List[Case]:
    """``[(name, xs, ys, areas, scores, valid)]`` with N = ``n`` rows:
    xs, ys (N, J), areas and scores (N,) float32, valid (N,) bool; padded
    rows as ``oks_nms_device`` pads them (zeros, area 1, score -inf).

    * ``clusters``: half the rows valid, people with 1-4 near-duplicates
      each (OKS among them > 0.9) and distinct scores;
    * ``equal scores``: the same rows, every valid score 0.5 (the larger
      index wins);
    * ``one valid``: all padding but one row;
    * ``no valid``: nothing to keep;
    * ``one cluster``: every valid row a duplicate of one person.
    """
    rng = np.random.RandomState(seed)
    m = max(1, n // 2)

    def empty():
        xs = np.zeros((n, joints), np.float32)
        ys = np.zeros((n, joints), np.float32)
        areas = np.ones(n, np.float32)
        scores = np.full(n, -np.inf, np.float32)
        return xs, ys, areas, scores, np.zeros(n, bool)

    def fill(xs, ys, areas, scores, valid, count, one_person=False):
        rows = rng.permutation(n)[:count]   # valid rows anywhere, not first
        person, area, left = None, 0.0, 0
        for r in rows:
            if left == 0 and not (one_person and person is not None):
                person = _person(rng, joints)
                area = rng.uniform(5e3, 4e4)
                left = rng.randint(1, 5)
            kp = person + rng.normal(scale=0.2, size=person.shape)
            xs[r], ys[r] = kp[:, 0], kp[:, 1]
            areas[r] = area * rng.uniform(0.98, 1.02)
            scores[r] = rng.uniform(0.05, 1.0)
            valid[r] = True
            left -= 1

    cases = []
    c = empty()
    fill(*c, m)
    cases.append(("clusters", *c))
    xs, ys, areas, scores, valid = (a.copy() for a in c)
    scores[valid] = 0.5
    cases.append(("equal scores", xs, ys, areas, scores, valid))
    c = empty()
    fill(*c, 1)
    cases.append(("one valid", *c))
    cases.append(("no valid", *empty()))
    c = empty()
    fill(*c, m, one_person=True)
    cases.append(("one cluster", *c))
    return cases
