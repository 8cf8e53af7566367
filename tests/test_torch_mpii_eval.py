"""MPII PCKh through the port's ``make_evaluate_fn`` against fhpe_tpu's,
on a synthetic ``gt_valid.mat`` (``data/mpii_synthetic.py``) with planted
and perturbed predictions."""

import numpy as np
import pytest

from fhpe_tpu.cli.common import make_evaluate_fn as make_evaluate_fn_jax
from fhpe_tpu_torch.cli.common import make_evaluate_fn
from fhpe_tpu_torch.config import get_default_config
from fhpe_tpu_torch.data.mpii_synthetic import (HEADBOX, preds_at_gt,
                                                synthetic_mpii_gt,
                                                write_mpii_gt)

from torch_threads import torch_threads  # noqa: F401

PEOPLE = 40
# PCKh@0.5 allows 0.5 * 0.6 * |headbox diagonal| px
THRESHOLD_PX = 0.5 * 0.6 * np.sqrt(2) * HEADBOX


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpii")
    gt = synthetic_mpii_gt(PEOPLE, seed=0)
    write_mpii_gt(str(root), "valid", gt)
    cfg = get_default_config()
    cfg.DATASET.DATASET = "mpii"
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.TEST_SET = "valid"
    return cfg, gt


@pytest.mark.parametrize("offset", [0.0, 0.5 * THRESHOLD_PX,
                                    0.99 * THRESHOLD_PX, 1.01 * THRESHOLD_PX,
                                    3.0 * THRESHOLD_PX])
def test_pckh_matches_jax(synth, tmp_path, offset):
    cfg, gt = synth
    preds = preds_at_gt(gt, offset, seed=1)
    if offset == 3.0 * THRESHOLD_PX:       # a mix: half the people exact
        preds[::2] = preds_at_gt(gt)[::2]
    nv, perf = make_evaluate_fn(cfg, device="cpu")(
        cfg, preds, str(tmp_path), None, None)
    nv_ref, perf_ref = make_evaluate_fn_jax(cfg)(cfg, preds, str(tmp_path),
                                                 None, None)
    assert list(nv.items()) == list(nv_ref.items()) and perf == perf_ref
    assert list(nv) == ["Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee",
                        "Ankle", "Mean", "Mean@0.1"]
    expect = {0.0: 100.0, 0.5 * THRESHOLD_PX: 100.0,
              0.99 * THRESHOLD_PX: 100.0, 1.01 * THRESHOLD_PX: 0.0}
    if offset in expect:
        assert nv["Mean"] == pytest.approx(expect[offset])
    else:
        assert 0.0 < nv["Mean"] < 100.0
    assert (tmp_path / "pred.mat").is_file()


def test_synthetic_gt_counts_every_joint(synth):
    _, gt = synth
    visible = 1 - gt["jnt_missing"]
    assert gt["pos_gt_src"].shape == (16, 2, PEOPLE)
    assert gt["headboxes_src"].shape == (2, 2, PEOPLE)
    assert (visible.sum(1) > 0).all() and (visible == 0).any()


def test_test_set_short_circuits(synth):
    cfg, gt = synth
    cfg = cfg.clone()
    cfg.DATASET.TEST_SET = "test"
    nv, perf = make_evaluate_fn(cfg)(cfg, preds_at_gt(gt), None, None, None)
    assert dict(nv) == {"Null": 0.0} and perf == 0.0
