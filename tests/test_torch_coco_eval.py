"""Port COCO evaluation against fhpe_tpu on synthetic annotations:
``rescore_and_nms`` (OKS-NMS through the port's device drop-in, its plain
versions on the CPU), ``write_results_json``, ``CocoKeypointEval`` and
``make_evaluate_fn``; then the slice end to end: the JAX Predictor and
the port's on the same tiny-HRNet weights and crops -> evaluate -> the
same 10 stats."""

import json
from unittest import mock

import numpy as np
import pytest

from fhpe_tpu.cli.common import make_evaluate_fn as make_evaluate_fn_jax
from fhpe_tpu.data import coco as coco_jax
from fhpe_tpu.eval.coco_eval import CocoKeypointEval as CocoKeypointEvalJax
from fhpe_tpu.serve import Predictor as PredictorJax
from fhpe_tpu_torch.cli.common import make_evaluate_fn
from fhpe_tpu_torch.data import coco
from fhpe_tpu_torch.data.coco_synthetic import (gt_boxes, oks_margin,
                                                planted_detections,
                                                synthetic_coco_gt,
                                                write_coco_gt)
from fhpe_tpu_torch.eval.coco_eval import CocoKeypointEval
from fhpe_tpu_torch.ops import nms_torch
from fhpe_tpu_torch.serve import Predictor

from test_torch_hrnet import H, W, he_weights, hrnet_cfg
from torch_threads import torch_threads  # noqa: F401

IMAGE_SET = "val2017"
ASPECT = W / H


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    gt = synthetic_coco_gt(24, seed=0)
    write_coco_gt(root, IMAGE_SET, gt)
    preds, boxes, paths = planted_detections(gt, root, IMAGE_SET, ASPECT,
                                             seed=1)
    return root, gt, preds, boxes, paths


def _eval_cfg(root):
    cfg = hrnet_cfg()
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = IMAGE_SET
    cfg.TEST.IN_VIS_THRE = 0.2
    cfg.TEST.OKS_THRE = 0.9
    return cfg


def _same_nmsed(got, ref):
    assert len(got) == len(ref)
    for g_img, r_img in zip(got, ref):
        assert len(g_img) == len(r_img)
        for g, r in zip(g_img, r_img):
            assert g.keys() == r.keys()
            assert g["image"] == r["image"] and g["score"] == r["score"]
            for k in ("keypoints", "center", "scale", "area"):
                np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("soft", [False, True])
def test_rescore_and_nms_matches_jax(synth, soft):
    """The kept detections per image, in order, equal fhpe_tpu's (host
    float64 ``oks_nms``); every OKS here is > 1e-5 from the threshold."""
    _, _, preds, boxes, paths = synth
    launches = nms_torch.pairwise_oks_launches
    got = coco.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                               oks_thre=0.9, soft=soft, device="cpu")
    ref = coco_jax.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                                   oks_thre=0.9, soft=soft)
    _same_nmsed(got, ref)
    assert nms_torch.pairwise_oks_launches == launches   # CPU: plain
    if not soft:
        assert sum(map(len, got)) < len(preds)   # duplicates were dropped
        full = coco.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                                    oks_thre=2.0, device="cpu")
        assert min(oks_margin(img, 0.9) for img in full) > 1e-5


@pytest.mark.parametrize("oks_thre", [0.5, 0.9])
def test_rescore_and_nms_one_batched_call_no_launches(synth, oks_thre):
    """The hard NMS of all images goes through one
    ``oks_nms_device_batched`` call; on the CPU it runs the plain versions
    (no kernel launch) and the kept detections equal fhpe_tpu's."""
    _, _, preds, boxes, paths = synth
    names = ("pairwise_oks_launches", "greedy_nms_launches",
             "oks_nms_segment_launches")
    before = [getattr(nms_torch, n) for n in names]
    batched = nms_torch.oks_nms_device_batched
    with mock.patch.object(nms_torch, "oks_nms_device_batched",
                           side_effect=batched) as spy:
        got = coco.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                                   oks_thre=oks_thre, device="cpu")
    assert spy.call_count == 1
    assert len(spy.call_args.args[0]) == len(set(paths)) == len(got)
    assert [getattr(nms_torch, n) for n in names] == before
    full = coco.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                                oks_thre=2.0, device="cpu")
    assert min(oks_margin(img, oks_thre) for img in full) > 1e-5
    _same_nmsed(got, coco_jax.rescore_and_nms(preds, boxes, paths,
                                              in_vis_thre=0.2,
                                              oks_thre=oks_thre))


def test_results_json_and_eval_match_jax(synth, tmp_path):
    root, _, preds, boxes, paths = synth
    nmsed = coco.rescore_and_nms(preds, boxes, paths, in_vis_thre=0.2,
                                 oks_thre=0.9, device="cpu")
    got = coco.write_results_json(nmsed, str(tmp_path / "a" / "r.json"))
    ref = coco_jax.write_results_json(nmsed, str(tmp_path / "b" / "r.json"))
    assert got == ref
    assert (tmp_path / "a" / "r.json").read_text() == \
        (tmp_path / "b" / "r.json").read_text()

    ann = f"{root}/annotations/person_keypoints_{IMAGE_SET}.json"
    stats = CocoKeypointEval(coco.CocoIndex(ann)).evaluate(got)
    assert stats == CocoKeypointEvalJax(coco_jax.CocoIndex(ann)).evaluate(ref)
    assert dict(stats)["AP"] > 0.5   # detections sit on the ground truth


def test_make_evaluate_fn_matches_jax(synth, tmp_path):
    root, _, preds, boxes, paths = synth
    cfg = _eval_cfg(root)
    nv, perf = make_evaluate_fn(cfg, device="cpu")(
        cfg, preds, str(tmp_path / "port"), boxes, paths)
    nv_ref, perf_ref = make_evaluate_fn_jax(cfg)(
        cfg, preds, str(tmp_path / "jax"), boxes, paths)
    assert list(nv.items()) == list(nv_ref.items()) and perf == perf_ref
    res = tmp_path / "port" / "results" / \
        f"keypoints_{IMAGE_SET}_results_0.json"
    assert len(json.loads(res.read_text())) < len(preds)
    cfg.DATASET.DATASET = "synthetic"
    assert make_evaluate_fn(cfg) is None
    cfg.DATASET.DATASET = "mpii"     # PCKh: tests/test_torch_mpii_eval.py
    assert callable(make_evaluate_fn(cfg))
    cfg.DATASET.DATASET = "lsp"
    with pytest.raises(KeyError):
        make_evaluate_fn(cfg)


def test_slice_end_to_end_matches_jax(synth, tmp_path):
    """Tiny HRNet (He-scale weights, ``he_weights``), float32, flip test
    on, one crop per ground-truth person at its box: the JAX Predictor
    and the port's give preds within 1e-3 px and maxvals within 5e-5 of
    the largest (float32 rounding of two convolution libraries, as in
    test_torch_hrnet), and the same 10 COCO stats after each package's
    evaluate.  Random weights predict nothing, so the ground truth here
    is the JAX Predictor's keypoints plus 3 px of noise: the stats then
    lie between 0 and 1 and turn on the predictions."""
    root, gt, _, _, _ = synth
    cfg = _eval_cfg(root)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    sd, variables = he_weights(cfg, seed=4)
    boxes, paths = gt_boxes(gt, root, IMAGE_SET, ASPECT)
    crops = np.random.RandomState(5).randint(
        0, 256, size=(len(boxes), H, W, 3)).astype(np.uint8)

    port = Predictor(cfg, sd, batch_size=8, device="cpu")
    preds, maxvals = port.predict_crops(crops, boxes[:, :2], boxes[:, 2:4])
    ref = PredictorJax(cfg, variables, batch_size=8, n_devices=1)
    ref_preds, ref_maxvals = ref.predict_crops(crops, boxes[:, :2],
                                               boxes[:, 2:4])
    np.testing.assert_allclose(preds, ref_preds, rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0,
                               atol=5e-5 * np.abs(ref_maxvals).max())

    truth = json.loads(json.dumps(gt))
    noise = np.random.RandomState(6).normal(scale=3.0, size=ref_preds.shape)
    for a, kp in zip(truth["annotations"], ref_preds + noise):
        g = np.asarray(a["keypoints"]).reshape(-1, 3)
        g[:, :2] = np.where(g[:, 2:] > 0, kp, 0)
        a["keypoints"] = g.reshape(-1).tolist()
    cfg.DATASET.ROOT = str(tmp_path / "truth")
    write_coco_gt(cfg.DATASET.ROOT, IMAGE_SET, truth)

    nv, _ = make_evaluate_fn(cfg, device="cpu")(
        cfg, np.concatenate([preds, maxvals[..., None]], -1),
        str(tmp_path / "port"), boxes, paths)
    nv_ref, _ = make_evaluate_fn_jax(cfg)(
        cfg, np.concatenate([ref_preds, ref_maxvals[..., None]], -1),
        str(tmp_path / "jax"), boxes, paths)
    assert list(nv.keys()) == list(nv_ref.keys()) and len(nv) == 10
    assert list(nv.values()) == list(nv_ref.values())
    assert 0.1 < nv["AP"] < 1.0
