"""ViTPose on the port (``models/vit_pose.py``), its AdamW with layer decay
and clipping (``train/state.py``, ``train/step.py``) and the drop-path
keep flags (``data/drop_path.py``), held to the plain reference
``tests/reference_vit_pose.py`` on seeded random weights at a small size
(D 32, depth 2, 2 heads, a 64x48 input, 4 joints), student and teacher
alike; and PoseResNet's decoder, now shared, as it was.

Both sides compute in float64 (the port's CPU parity mode): the two
differ only in the order of their sums (SDPA against the written-out
softmax, foreach against per-tensor AdamW), ~1e-15 relative per
reduction, so every number is held to 1e-9 of its tensor's largest
magnitude.  A missing ``1 / (1 - p)``, a wrong group scale or a skipped
clip moves a gradient or a parameter by whole percents.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

import reference_vit_pose as ref
from fhpe_tpu_torch.cli.common import train_batch_keys, train_step_keys
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import drop_path
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.pose_resnet import PoseResNet
from fhpe_tpu_torch.train import (create_train_state, make_fpd_train_step,
                                  make_optimizer)
from fhpe_tpu_torch.train.state import adamw_groups

from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VITPOSE = os.path.join(REPO, "experiments_torch", "fpd_coco", "vitpose")
STUDENT = os.path.join(VITPOSE, "vitpose_b_fpd_student.yaml")
HOURGLASS = os.path.join(
    REPO, "experiments/fpd_mpii/hourglass/hg4_128_fpd_student.yaml")
D, DEPTH, HEADS, J, FILTERS = 32, 2, 2, 4, (8, 8)
H, W, B = 64, 48, 3
RATE, CLIP, LR = 0.3, 0.05, 5e-4
RTOL = 1e-9         # float64 on both sides, sums in another order


def small_cfg(**over):
    opts = {"MODEL.IMAGE_SIZE": [W, H], "MODEL.HEATMAP_SIZE": [W // 4, H // 4],
            "MODEL.NUM_JOINTS": J, "MODEL.EXTRA.EMBED_DIM": D,
            "MODEL.EXTRA.DEPTH": DEPTH, "MODEL.EXTRA.NUM_HEADS": HEADS,
            "MODEL.EXTRA.NUM_DECONV_FILTERS": list(FILTERS),
            "MODEL.EXTRA.DROP_PATH_RATE": RATE, "TRAIN.CLIP_GRAD_NORM": CLIP,
            "TPU.COMPUTE_DTYPE": "float64", **over}
    return load_config(STUDENT, [str(x) for kv in opts.items() for x in kv])


def seeded(model, seed):
    """Weights that make every part count: linears at 1/sqrt(fan_in),
    LayerNorm and BatchNorm scales uniform(0.5, 1.5), shifts and biases
    normal(0, 0.1), ``pos_embed`` normal(0, 0.5), BatchNorm statistics
    random too; float64."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith(("norm1.weight", "norm2.weight", "last_norm.weight",
                         "running_var")) or (v.ndim == 1 and "deconv" in k
                                             and k.endswith("weight")):
            sd[k] = torch.rand(v.shape, generator=g, dtype=torch.float64) + 0.5
        elif v.ndim == 1 or k.endswith("pos_embed"):
            std = 0.5 if k.endswith("pos_embed") else 0.1
            sd[k] = torch.randn(v.shape, generator=g,
                                dtype=torch.float64) * std
        else:
            fan_in = v[0].numel() if "deconv" not in k else v.shape[0]
            sd[k] = torch.randn(v.shape, generator=g,
                                dtype=torch.float64) / fan_in ** 0.5
    model.load_state_dict(sd)
    return model.double()


def pair(seed, rate=RATE):
    cfg = small_cfg()
    port = seeded(get_pose_net(cfg), seed)
    plain = ref.ViTPose((H, W), J, D, DEPTH, HEADS, FILTERS,
                        drop_path_rate=rate).double()
    plain.load_state_dict(port.state_dict())
    return cfg, port, plain


def batch(seed):
    g = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    keep = drop_path.draw_keep(rng, B, [0.0, 0.5])
    keep[0, 1] = (0, 1)     # block 1 drops a branch of each kind
    keep[1, 1] = (1, 0)
    keep[2, 1] = (1, 1)
    return {"image": torch.randn(B, 3, H, W, generator=g, dtype=torch.float64),
            "target": torch.rand(B, J, H // 4, W // 4, generator=g,
                                 dtype=torch.float64),
            "target_weight": (torch.rand(B, J, generator=g) > 0.2).double(),
            "drop_path_keep": torch.from_numpy(keep)}


def close(got, want, name=""):
    scale = want.abs().max().clamp(min=1e-300)
    assert ((got - want).abs().max() / scale) <= RTOL, name


@pytest.mark.parametrize("mode", ["eval", "train_flags"])
def test_forward_matches_reference(mode):
    _, port, plain = pair(1)
    x = batch(2)
    train = mode == "train_flags"
    port.train(train), plain.train(train)
    keep = x["drop_path_keep"] if train else None
    with torch.no_grad():
        got = port(x["image"], drop_path_keep=keep)
        want = plain(x["image"], keep)
    assert got.shape == (B, J, H // 4, W // 4) and got.dtype == torch.float64
    close(got, want)


def test_fpd_step_matches_reference():
    """One FPD step through ``create_train_state`` and
    ``make_fpd_train_step``: loss, every gradient after clipping, AdamW's
    first moments and every parameter after the step."""
    cfg, port, plain = pair(3)
    _, t_port, t_plain = pair(4)
    t_port.eval().requires_grad_(False)
    state = create_train_state(cfg, port, device="cpu")
    assert len(state.optimizer.param_groups) == 2 * (DEPTH + 2)
    step = make_fpd_train_step(cfg, t_port)
    x = batch(5)
    state, metrics = step(state, dict(x))
    ref_state = {}
    loss, grads, total = ref.fpd_step(plain, t_plain, x, 0.5, LR, 0.1, 0.75,
                                      CLIP, ref_state)
    assert total > 3 * CLIP         # the clip binds
    close(metrics["loss"], loss, "loss")
    named = dict(state.model.named_parameters())
    for n, p in plain.named_parameters():
        close(named[n].grad, grads[n], n)
        close(state.optimizer.state[named[n]]["exp_avg"],
              ref_state[("m", n)], n)
        close(named[n].detach(), p.detach(), n)


def test_layer_decay_groups_of_vitpose_b():
    """The full ViTPose-B layout on the meta device: every parameter's
    rate and weight decay as the reference assigns them."""
    cfg = load_config(STUDENT)
    with torch.device("meta"):
        model = get_pose_net(cfg)
    named = list(model.named_parameters())
    got = {}
    for g in adamw_groups(cfg, model):
        for p in g["params"]:
            got[id(p)] = (float(cfg.TRAIN.LR) * g["lr_scale"],
                          g["weight_decay"])
    want = ref.groups(named, 12, 5e-4, 0.1, 0.75)
    assert len(got) == len(named) == 3 + 12 * 12 + 2 + 8
    for n, p in named:
        assert got[id(p)] == pytest.approx(want[n], rel=1e-12), n
    bare = sorted(n for n, _ in named if want[n][1] == 0)
    assert "backbone.pos_embed" in bare and "backbone.blocks.3.norm2.weight" \
        in bare and "backbone.blocks.0.attn.qkv.weight" not in bare
    with pytest.raises(ValueError, match="names no layers"):
        make_optimizer(cfg, nn.Linear(2, 2))


# the published widths (ViTPose_{base,large}_coco_256x192.py) and recipe
PUBLISHED = {
    "vitpose_b_fpd_student.yaml": dict(dim=768, depth=12, heads=12,
                                       backbone=85_794_816, decay=0.75,
                                       drop_path=0.3),
    "vitpose_l_256x192.yaml": dict(dim=1024, depth=24, heads=16,
                                   backbone=303_296_512, decay=0.8,
                                   drop_path=0.5),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_experiment_files_at_published_values(name):
    """Each experiment file builds its ViTPose at the published widths
    (backbone 86 M and 303 M parameters, on the meta device) with the
    published recipe: 256x192 in, 64x48 out, 17 joints, AdamW 5e-4, weight
    decay 0.1, clipping at 1, 64 images a GPU, 210 epochs."""
    want = PUBLISHED[name]
    cfg = load_config(os.path.join(VITPOSE, name))
    e, t = cfg.MODEL.EXTRA, cfg.TRAIN
    assert (e.EMBED_DIM, e.DEPTH, e.NUM_HEADS, e.MLP_RATIO, e.PATCH_SIZE,
            e.PATCH_PADDING, e.QKV_BIAS) == (want["dim"], want["depth"],
                                             want["heads"], 4, 16, 2, True)
    assert (list(cfg.MODEL.IMAGE_SIZE), list(cfg.MODEL.HEATMAP_SIZE),
            cfg.MODEL.NUM_JOINTS) == ([192, 256], [48, 64], 17)
    assert (t.OPTIMIZER, t.LR, t.WD, t.LAYER_DECAY, t.CLIP_GRAD_NORM,
            t.BATCH_SIZE_PER_GPU, list(t.LR_STEP), t.END_EPOCH) == (
        "adamw", 5e-4, 0.1, want["decay"], 1.0, 64, [170, 200], 210)
    assert e.DROP_PATH_RATE == want["drop_path"]
    with torch.device("meta"):
        model = get_pose_net(cfg)
    assert sum(p.numel() for p in model.backbone.parameters()) == \
        want["backbone"]
    assert model.backbone.grid == (16, 12)


def test_keep_flags_and_batch_keys():
    """The data layer's flags keep each block's branches with its rate's
    complement, and only a student that drops paths uploads them: the
    hourglass's train keys are the copy's."""
    rates = np.array([0.0, 0.1, 0.5])
    flags = drop_path.draw_keep(np.random.RandomState(0), 20000, rates)
    assert flags.shape == (20000, 3, 2) and flags.dtype == np.float32
    np.testing.assert_allclose(1 - flags.mean((0, 2)), rates, atol=0.01)
    hg = load_config(HOURGLASS)
    assert train_step_keys(hg) == train_batch_keys(hg)
    vit = small_cfg()
    assert train_step_keys(vit) == train_batch_keys(vit) + [drop_path.KEY]
    assert train_step_keys(small_cfg(
        **{"MODEL.EXTRA.DROP_PATH_RATE": 0.0})) == train_batch_keys(vit)


def test_pose_resnet_decoder_unchanged():
    """PoseResNet's decoder, built by the shared helper, has the keys and
    gives the outputs of the decoder it had before, built here as it was."""
    torch.manual_seed(0)
    net = PoseResNet(18, num_joints=J, num_deconv_filters=(16, 16, 16))
    old, cin = [], 512
    for _ in range(3):
        old += [nn.ConvTranspose2d(cin, 16, 4, stride=2, padding=1,
                                   output_padding=0, bias=False),
                nn.BatchNorm2d(16, eps=1e-5, momentum=0.1), nn.ReLU()]
        cin = 16
    old = nn.Sequential(*old)
    final = nn.Conv2d(16, J, 1)
    keys = [k for k in net.state_dict() if k.startswith(("deconv", "final"))]
    assert keys == [f"deconv_layers.{k}" for k in old.state_dict()] + [
        f"final_layer.{k}" for k in final.state_dict()]
    old.load_state_dict({k[len("deconv_layers."):]: v for k, v in
                         net.state_dict().items()
                         if k.startswith("deconv_layers.")})
    final.load_state_dict(net.final_layer.state_dict())
    x = torch.randn(2, 512, 2, 2)
    net.eval(), old.eval()
    with torch.no_grad():
        assert torch.equal(net.final_layer(net.deconv_layers(x)),
                           final(old(x)))
