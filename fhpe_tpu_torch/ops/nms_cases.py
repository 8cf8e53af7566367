"""Detections with planted edge cases for holding the NMS implementations
to each other (the CPU tests against ``fhpe_tpu``, ``chip_smoke.py`` the
CUDA kernels against their plain versions), and a COCO-scale evaluated
set for timing.  numpy only, from a seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Case = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]
Image = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _person(rng, joints: int) -> np.ndarray:
    base = rng.uniform(50, 600, size=(1, 2))
    return base + rng.normal(scale=rng.uniform(10, 60), size=(joints, 2))


def planted_nms_cases(n: int, seed: int = 0, joints: int = 17) -> List[Case]:
    """``[(name, xs, ys, areas, scores, valid)]`` with N = ``n`` rows:
    xs, ys (N, J), areas and scores (N,) float32, valid (N,) bool; padded
    rows as the greedy kernel's callers pad them (zeros, area 1, score
    -inf; the COCO path packs only the valid rows).

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


def _clustered(rng, n: int, joints: int, per_person: float = 3.0):
    """n detections of about n / per_person people, each a cluster of
    near-duplicates (0.2 px apart: mutual OKS > 0.9), in arbitrary order:
    (xs, ys (n, J), areas (n,)) float32."""
    people = max(1, int(round(n / per_person)))
    person = rng.randint(0, people, n)
    base = (rng.uniform(50, 600, (people, 1, 2))
            + rng.normal(size=(people, joints, 2))
            * rng.uniform(10, 60, (people, 1, 1)))
    kp = base[person] + rng.normal(scale=0.2, size=(n, joints, 2))
    areas = rng.uniform(5e3, 4e4, people)[person] * rng.uniform(0.98, 1.02, n)
    return (kp[..., 0].astype(np.float32), kp[..., 1].astype(np.float32),
            areas.astype(np.float32))


def ragged_nms_images(seed: int = 0, joints: int = 17) -> List[Image]:
    """``[(name, xs, ys, areas, scores)]``, the images of a ragged CSR pack
    (every detection valid): empty images, one detection, clusters, all
    scores equal, three score levels, NaN and -inf scores among the
    others, and one image above the scan's shared-memory cap (600)."""
    rng = np.random.RandomState(seed)
    images = []
    for name, n in (("empty", 0), ("one", 1), ("clusters", 23),
                    ("empty", 0), ("equal scores", 40),
                    ("nan and -inf scores", 30), ("three levels", 64),
                    ("clusters", 130), ("above the cap", 600)):
        xs, ys, areas = _clustered(rng, n, joints)
        scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
        if name == "equal scores":
            scores[:] = 0.5
        elif name == "three levels":
            scores = rng.choice(np.float32([0.2, 0.5, 0.9]), n)
        elif name.startswith("nan"):
            scores[rng.permutation(n)[:8]] = np.nan
            scores[rng.permutation(n)[:8]] = -np.inf
        images.append((name, xs, ys, areas, scores))
    return images


def coco_scale_groups(images: int = 5000, seed: int = 0,
                      joints: int = 17) -> list:
    """A synthetic evaluated set at COCO val2017's scale: ``images``
    per-image ``kpts_db`` lists ({"keypoints" (J, 3), "area", "score"}),
    about 20 detections per image (log-normal, capped at 100, a few
    empty), each person detected 1-5 times as near-duplicates (mutual OKS
    > 0.9), as a person detector's boxes give them."""
    rng = np.random.RandomState(seed)
    sizes = np.minimum(100, np.floor(rng.lognormal(np.log(16.0), 0.75,
                                                   images))).astype(int)
    groups = []
    for n in sizes:
        xs, ys, areas = _clustered(rng, n, joints)
        kp = np.stack([xs, ys, rng.uniform(0, 1, (n, joints))], -1)
        scores = rng.uniform(0.05, 1.0, n)
        groups.append([{"keypoints": kp[i], "area": float(areas[i]),
                        "score": float(scores[i])} for i in range(n)])
    return groups
