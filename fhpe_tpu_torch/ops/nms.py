"""Box NMS, OKS-NMS and soft OKS-NMS on the host (numpy).

A copy of ``fhpe_tpu/ops/nms.py`` (importing ``fhpe_tpu`` pulls in JAX),
pinned equal to it by ``tests/test_torch_port_hygiene.py``.  Keep-list
identical to the reference ``lib/nms/nms.py``, with the pairwise loops
vectorized.  The on-device OKS-NMS that COCO evaluation runs is
``ops/nms_torch.py::oks_nms_device_batched``; soft OKS-NMS (``TEST.SOFT_NMS``)
stays here on the host, as in ``fhpe_tpu``.

Reference quirk preserved: ``oks_iou``'s ``in_vis_thre`` filter evaluates
``list(vg > t) and list(vd > t)`` — Python ``and`` returns the second
operand whenever the first is non-empty, so only the *detection*'s
visibility mask filters (nms.py:91).  The COCO eval path never passes
``in_vis_thre``, so this does not affect headline metrics.
"""

from __future__ import annotations

import numpy as np

COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0


def nms(dets: np.ndarray, thresh: float):
    """Greedy box IoU NMS; dets (N, 5) = [x1, y1, x2, y2, score].

    Keep-list identical to nms.py:35-72 (and cpu_nms.pyx / gpu_nms).
    """
    if dets.shape[0] == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]

    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None) -> np.ndarray:
    """OKS between one gt/ref keypoint set ``g`` (51,) and dets ``d`` (N, 51).

    Vectorized over detections; numerically identical to nms.py:75-94.
    """
    if sigmas is None:
        sigmas = COCO_SIGMAS
    variances = (np.asarray(sigmas) * 2) ** 2
    g = np.asarray(g, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    if d.size == 0:
        return np.zeros((0,))
    d = d.reshape(len(d), -1)
    xg, yg = g[0::3], g[1::3]
    xd, yd = d[:, 0::3], d[:, 1::3]
    a_d = np.asarray(a_d, dtype=np.float64)

    e = ((xd - xg) ** 2 + (yd - yg) ** 2) / variances \
        / ((a_g + a_d[:, None]) / 2 + np.spacing(1)) / 2  # (N, J)
    if in_vis_thre is not None:
        vd = d[:, 2::3]
        mask = vd > in_vis_thre  # reference quirk: vg mask is discarded
        cnt = mask.sum(axis=1)
        s = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1)


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS NMS over per-image detections (nms.py:97-124).

    kpts_db: list of {"score", "keypoints" (J,3), "area"}.
    Returns indices (into kpts_db) to keep.
    """
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]

    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[1:][ovr <= thresh]
    return keep


def _rescore(overlap, scores, thresh, kind="gaussian"):
    if kind == "linear":
        idx = overlap >= thresh
        scores = scores.copy()
        scores[idx] = scores[idx] * (1 - overlap[idx])
        return scores
    return scores * np.exp(-overlap ** 2 / thresh)


def soft_oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None,
                 max_dets: int = 20):
    """Soft OKS NMS with gaussian rescoring (nms.py:138-177)."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])

    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[1:]
        scores = _rescore(ovr, scores[1:], thresh)
        resort = scores.argsort()[::-1]
        order = order[resort]
        scores = scores[resort]
        keep.append(int(i))
    return keep
