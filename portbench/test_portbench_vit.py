"""CPU tests of the ViTPose cell at a size a CPU holds: its seeded weights
load into the port and the reference alike and give the same heatmaps,
its roofline counts, and a run's ``correct``: true for the sound program,
false for each fault and for the precision control (as
``test_portbench_correctness.py`` does for the other cells)."""

import copy

import pytest
import torch

from portbench import harness, inputs, program, vit_inputs
from portbench.reference import serve as ref_serve
from portbench.reference import vit_pose as ref_vit
from portbench.roofline import bound_s, vit

CELL = "vitpose_fpd_coco.train"


def tiny_vit(dim, depth, heads):
    return {"NAME": "vit_pose", "NUM_JOINTS": 17, "IMAGE_SIZE": [48, 64],
            "HEATMAP_SIZE": [12, 16], "SIGMA": 2, "INIT_WEIGHTS": False,
            "TARGET_TYPE": "gaussian",
            "EXTRA": {"PATCH_SIZE": 16, "PATCH_PADDING": 2, "EMBED_DIM": dim,
                      "DEPTH": depth, "NUM_HEADS": heads, "MLP_RATIO": 4,
                      "QKV_BIAS": True, "DROP_PATH_RATE": 0.3,
                      "DECONV_WITH_BIAS": False, "NUM_DECONV_LAYERS": 2,
                      "NUM_DECONV_FILTERS": [16, 16],
                      "NUM_DECONV_KERNELS": [4, 4], "FINAL_CONV_KERNEL": 1}}


def tiny():
    cfg = copy.deepcopy(harness.data("configs", "vitpose_fpd_coco"))
    s = cfg["student"]
    s["TPU"]["COMPUTE_DTYPE"] = "float32"
    s["TRAIN"]["BATCH_SIZE_PER_GPU"] = s["TEST"]["BATCH_SIZE_PER_GPU"] = 4
    s["MODEL"] = tiny_vit(32, 3, 2)
    cfg["teacher"]["MODEL"] = tiny_vit(48, 4, 3)
    return cfg, harness.data("traffic", "train_vit"), \
        harness.data("limits", CELL)


def test_reference_matches_the_port():
    model_cfg = tiny_vit(32, 3, 2)
    groups = {"MODEL": model_cfg, "TPU": {"COMPUTE_DTYPE": "float32"}}
    sd = vit_inputs.seeded_state_dict(model_cfg, 7, 0, "cpu", calibrate=True)
    port = program.port_model(program.port_cfg(groups), sd, "cpu")
    ref = ref_vit.build(model_cfg)
    ref.load_state_dict(sd)
    assert set(port.state_dict()) == set(ref.state_dict())
    images = inputs.smooth_images(inputs.generator(7, 1, "cpu"), 2, 64, 48,
                                  "cpu")
    x = ref_serve.normalize(images)
    keep = torch.from_numpy(vit_inputs.keep_flags(7, 2, 3, 0.6))
    for train in (False, True):
        port.train(train)
        ref.train(train)
        with torch.no_grad():
            got = port(x, drop_path_keep=keep)
            want = ref(x, keep if train else None)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_roofline_counts():
    cfg = harness.data("configs", "vitpose_fpd_coco")
    b, l = cfg["student"]["MODEL"], cfg["teacher"]["MODEL"]
    assert vit.tokens(b) == 192
    step = vit.forward_flop(l) + vit.train_flop(b)
    assert 220e9 < step < 250e9         # about 234 GFLOP an image
    nbytes, ops = vit.attention_call(b, 64, False)
    assert ops == 4 * 64 * 12 * 192 ** 2 * 64
    assert nbytes == 4 * 64 * 192 * 768 * 2
    assert vit.attention_call(b, 64, True)[1] == 2 * ops
    assert bound_s(nbytes, ops) == nbytes / 3.35e12     # memory-bound
    assert len(vit.linears(l)) == 96 and len(vit.linears(b)) == 48
    assert vit.gemm_step_s(l, b, 64) * 1e3 == pytest.approx(
        sum(2 * 64 * 192 * k * n for k, n in vit.linears(l)) / 989e12 * 1e3
        + 3 * sum(2 * 64 * 192 * k * n for k, n in vit.linears(b))
        / 989e12 * 1e3, 1e-6)


@pytest.mark.parametrize("reading", ["sound", "unchanged", "half_batch",
                                     "control"])
def test_correct_catches_each_fault(reading):
    cfg, mix, lim = tiny()
    r = harness.run_cell(
        CELL, 2 ** 31 + 7, 0.5, False, "cpu", config=cfg, traffic=mix,
        limits=lim, control=reading == "control",
        fault=reading if reading in ("unchanged", "half_batch") else None)
    assert r["correct"] is (reading == "sound"), r["checks"]
    assert r["attempted"] >= 1
