"""COCO keypoint AP/AR evaluation, implemented from the COCOeval protocol.

A copy of ``fhpe_tpu/eval/coco_eval.py`` (importing ``fhpe_tpu`` pulls
in JAX), pinned equal to it by ``tests/test_torch_port_hygiene.py``.  Host
numpy: OKS thresholds 0.50:0.05:0.95, greedy score-ordered matching
against ground truth (ignore-aware), area ranges all/medium/large,
maxDets=20, 101-point interpolated precision, and the 10-entry stats
vector [AP, AP.5, AP.75, AP(M), AP(L), AR, AR.5, AR.75, AR(M), AR(L)].
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..ops.nms import COCO_SIGMAS

OKS_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNGS = {"all": (0.0, 1e10), "medium": (32 ** 2, 96 ** 2),
             "large": (96 ** 2, 1e10)}
MAX_DETS = 20

STATS_NAMES = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
               "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]


def _dt_area_bbox(kp: np.ndarray):
    """Detection area/bbox from keypoint extent (COCO loadRes convention)."""
    xs, ys = kp[0::3], kp[1::3]
    x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
    return (x2 - x1) * (y2 - y1), (x1, y1, x2 - x1, y2 - y1)


def compute_oks(gts, dts, sigmas=None) -> np.ndarray:
    """IoU-like OKS matrix (len(dts), len(gts)) for one image.

    gts/dts: lists of dicts with 'keypoints' (flat 3J), gt also 'bbox'/'area'.
    """
    sigmas = COCO_SIGMAS if sigmas is None else sigmas
    variances = (np.asarray(sigmas) * 2) ** 2
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], dtype=np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros_like(xd)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / variances \
                / (gt["area"] + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


def _evaluate_img(gts, dts, ious, area_rng, max_dets):
    """Greedy matching for one (image, area range); returns match arrays.

    COCOeval-protocol details that matter here:
    * gts sort by the AREA-AWARE ignore flag (base ignore OR outside this
      range) so the ignore-last early-break is valid per range;
    * an already-matched **crowd** gt may be matched again (subsequent dets
      overlapping a crowd region are ignored, not false positives).
    """
    gt_ig_flag = [
        1 if (g["_ignore"] or g["area"] < area_rng[0]
              or g["area"] > area_rng[1]) else 0
        for g in gts]
    order = sorted(range(len(gts)), key=lambda i: gt_ig_flag[i])
    gts = [gts[i] for i in order]
    gt_ig = np.array([gt_ig_flag[i] for i in order])
    gt_crowd = np.array([int(g.get("iscrowd", 0)) for g in gts])
    dts = sorted(dts, key=lambda d: -d["score"])[:max_dets]
    # ious was computed in original gt order; reorder columns
    if len(ious):
        ious = ious[:, [g["_idx"] for g in gts]]

    T, G, D = len(OKS_THRS), len(gts), len(dts)
    gtm = -np.ones((T, G), dtype=np.int64)
    dtm = -np.ones((T, D), dtype=np.int64)
    dt_ig = np.zeros((T, D))
    for t, thr in enumerate(OKS_THRS):
        for di, dt in enumerate(dts):
            iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[t, gi] >= 0 and not gt_crowd[gi]:
                    continue
                if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                    break  # gts sorted ignore-last; no better match ahead
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[t, di] = gt_ig[m]
            dtm[t, di] = m
            gtm[t, m] = di
    # unmatched dts outside the area range are ignored
    a = np.array([
        d["_area"] < area_rng[0] or d["_area"] > area_rng[1] for d in dts])
    if D:
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == -1, a[None, :]))
    return {
        "dt_scores": np.array([d["score"] for d in dts]),
        "dt_matches": dtm,
        "dt_ignore": dt_ig,
        "num_gt": int(np.count_nonzero(gt_ig == 0)),
    }


def _accumulate(per_img_results):
    """precision (T, R) and recall (T,) from per-image match arrays."""
    T, R = len(OKS_THRS), len(RECALL_THRS)
    results = [r for r in per_img_results if r is not None]
    if not results:
        return None
    dt_scores = np.concatenate([r["dt_scores"] for r in results])
    order = np.argsort(-dt_scores, kind="mergesort")
    dtm = np.concatenate([r["dt_matches"] for r in results], axis=1)[:, order]
    dt_ig = np.concatenate([r["dt_ignore"] for r in results], axis=1)[:, order]
    npig = sum(r["num_gt"] for r in results)
    if npig == 0:
        return None

    tps = np.logical_and(dtm >= 0, np.logical_not(dt_ig))
    fps = np.logical_and(dtm < 0, np.logical_not(dt_ig))
    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

    precision = -np.ones((T, R))
    recall = -np.ones(T)
    for t in range(T):
        tp, fp = tp_sum[t], fp_sum[t]
        nd = len(tp)
        rc = tp / npig
        pr = tp / (fp + tp + np.spacing(1))
        recall[t] = rc[-1] if nd else 0
        # interpolated precision envelope
        pr = pr.tolist()
        for i in range(nd - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, RECALL_THRS, side="left")
        q = np.zeros(R)
        for ri, pi in enumerate(inds):
            q[ri] = pr[pi] if pi < nd else 0
        precision[t] = q
    return precision, recall


class CocoKeypointEval:
    """Evaluate keypoint detections against a :class:`CocoIndex` ground truth."""

    def __init__(self, coco_index, sigmas=None):
        self.coco = coco_index
        self.sigmas = COCO_SIGMAS if sigmas is None else sigmas

    def _gather_gts(self, img_ids):
        gts = defaultdict(list)
        for img_id in img_ids:
            for ann in self.coco.annotations(img_id, iscrowd=None):
                if ann.get("category_id") != self.coco.person_cat_id:
                    continue
                g = dict(ann)
                g["_ignore"] = 1 if (ann.get("iscrowd", 0)
                                     or ann.get("num_keypoints", 0) == 0) else 0
                gts[img_id].append(g)
        return gts

    def evaluate(self, detections):
        """detections: list of {'image_id', 'keypoints' (flat), 'score'}.

        Returns list of (stat_name, value) pairs (coco.py:452-456 order).
        """
        dts = defaultdict(list)
        for d in detections:
            d = dict(d)
            kp = np.asarray(d["keypoints"], dtype=np.float64)
            d["_area"], _ = _dt_area_bbox(kp)
            dts[d["image_id"]].append(d)

        img_ids = list(self.coco.img_ids)
        gts = self._gather_gts(img_ids)

        per_area = {name: [] for name in AREA_RNGS}
        for img_id in img_ids:
            g, d = gts.get(img_id, []), dts.get(img_id, [])
            if not g and not d:
                for name in AREA_RNGS:
                    per_area[name].append(None)
                continue
            for idx, gt in enumerate(g):
                gt["_idx"] = idx
            ious = compute_oks(g, sorted(d, key=lambda x: -x["score"])[:MAX_DETS],
                               self.sigmas) if g and d else np.zeros((len(d), len(g)))
            for name, rng in AREA_RNGS.items():
                per_area[name].append(_evaluate_img(g, d, ious, rng, MAX_DETS))

        acc = {name: _accumulate(per_area[name]) for name in AREA_RNGS}

        def ap(name, thr=None):
            if acc[name] is None:
                return -1.0
            precision, _ = acc[name]
            p = precision if thr is None else precision[
                [int(np.where(np.isclose(OKS_THRS, thr))[0][0])]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def ar(name, thr=None):
            if acc[name] is None:
                return -1.0
            _, recall = acc[name]
            r = recall if thr is None else recall[
                [int(np.where(np.isclose(OKS_THRS, thr))[0][0])]]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        stats = [ap("all"), ap("all", 0.5), ap("all", 0.75),
                 ap("medium"), ap("large"),
                 ar("all"), ar("all", 0.5), ar("all", 0.75),
                 ar("medium"), ar("large")]
        return list(zip(STATS_NAMES, stats))
