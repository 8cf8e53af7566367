"""Dataset-metric dispatch for evaluation.

Counterpart of ``make_evaluate_fn`` in ``fhpe_tpu/cli/common.py``: the
COCO branch (rescore + OKS-NMS on the card -> results JSON -> COCO AP),
the MPII branch (PCKh against ``gt_<TEST_SET>.mat``, host) and the
``synthetic`` branch.  ``validate`` comes with the port's CLI slice
(``ROADMAP.md`` queue A, item 7).
"""

from __future__ import annotations

import os
from collections import OrderedDict


def make_evaluate_fn(cfg, device="cuda"):
    """``cfg.DATASET.DATASET`` -> ``fn(cfg, preds, output_dir, all_boxes,
    img_paths) -> (name_values, perf)``, or None for ``synthetic`` (whose
    metric is the in-training PCK proxy).

    preds: (N, J, 3) keypoints in image coordinates with their maxvals;
    all_boxes: (N, 6) [cx, cy, sx, sy, area, score]; img_paths end in the
    zero-padded image id (``.../val2017/000000000139.jpg``).  The OKS-NMS
    runs on ``device``.
    """
    name = cfg.DATASET.DATASET
    if name == "synthetic":
        return None
    if name == "mpii":
        from ..data import mpii

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            return mpii.evaluate(cfg, preds, output_dir or None)
        return fn
    if name == "coco":
        from ..data.coco import (NUM_JOINTS, CocoIndex, rescore_and_nms,
                                 write_results_json)
        from ..eval.coco_eval import CocoKeypointEval

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            nmsed = rescore_and_nms(
                preds, all_boxes, img_paths, num_joints=NUM_JOINTS,
                in_vis_thre=cfg.TEST.IN_VIS_THRE,
                oks_thre=cfg.TEST.OKS_THRE, soft=cfg.TEST.SOFT_NMS,
                device=device)
            res_file = os.path.join(
                output_dir or ".", "results",
                f"keypoints_{cfg.DATASET.TEST_SET}_results_{cfg.RANK}.json")
            results = write_results_json(nmsed, res_file)
            if "test" in cfg.DATASET.TEST_SET:
                return OrderedDict([("Null", 0.0)]), 0.0
            ann = os.path.join(cfg.DATASET.ROOT, "annotations",
                               f"person_keypoints_{cfg.DATASET.TEST_SET}.json")
            nv = OrderedDict(CocoKeypointEval(CocoIndex(ann)).evaluate(results))
            return nv, nv["AP"]
        return fn
    raise KeyError(name)
