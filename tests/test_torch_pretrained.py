"""``MODEL.PRETRAINED`` in the port (``fhpe_tpu_torch/utils/pretrained.py``)
against ``fhpe_tpu.utils.torch_import.load_pretrained``.

Both sides start from one init (the port model's seeded weights, carried
to ``fhpe_tpu``'s tree by ``import_for_model``) and load one trunk
checkpoint written from a seed: a ResNet-18 trunk with the ImageNet
classifier's ``fc.*`` keys (all of it, and with one tensor of the wrong
shape), and a narrow HRNet with classification extras, filtered by the
W32 YAML's ``PRETRAINED_LAYERS``.  The port's ``state_dict`` after the
load equals ``state_dict_from_jax`` of ``fhpe_tpu``'s, with the same
count.  Then the no-op cases: a missing file (with the warning), the
hourglass, ``INIT_WEIGHTS`` off.
"""

import logging
import os

import numpy as np
import pytest
import torch

from fhpe_tpu.utils.torch_import import import_for_model
from fhpe_tpu.utils.torch_import import load_pretrained as load_pretrained_jax
from fhpe_tpu_torch.config import MODEL_EXTRAS, get_default_config, load_config
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.utils.convert import state_dict_from_jax
from fhpe_tpu_torch.utils.pretrained import load_pretrained
from test_torch_hrnet import hrnet_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W32_YAML = os.path.join(REPO, "experiments/coco/hrnet/"
                        "w32_256x192_adam_lr1e-3.yaml")


def _resnet18_cfg():
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 8
    cfg.MODEL.EXTRA = MODEL_EXTRAS["pose_resnet"]()
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [64, 64, 64]
    return cfg


def _seeded(cfg, seed):
    torch.manual_seed(seed)
    return get_pose_net(cfg)


def _resnet18_trunk(cfg, wrong_shape=False):
    """A torchvision-style ImageNet trunk: the trunk keys of a seeded
    PoseResNet-18, no deconv/final keys, and a 1000-way ``fc``."""
    sd = {k: v for k, v in _seeded(cfg, 1).state_dict().items()
          if not k.startswith(("deconv_layers", "final_layer"))}
    sd["fc.weight"] = torch.randn(1000, 512)
    sd["fc.bias"] = torch.randn(1000)
    if wrong_shape:
        sd["layer1.0.conv1.weight"] = torch.randn(64, 64, 1, 1)
    return sd


def _hrnet_trunk(cfg):
    """A seeded narrow HRNet's keys (its ``final_layer`` included, shape
    compatible, which ``PRETRAINED_LAYERS`` must drop) plus the ImageNet
    classifier's extras."""
    sd = dict(_seeded(cfg, 1).state_dict())
    sd["classifier.weight"] = torch.randn(1000, 64)
    sd["incre_modules.0.0.conv1.weight"] = torch.randn(8, 8, 1, 1)
    return sd


def _pretrained_cfg(kind):
    if kind.startswith("resnet18"):
        return _resnet18_cfg()
    cfg = hrnet_cfg()
    cfg.MODEL.EXTRA.PRETRAINED_LAYERS = list(
        load_config(W32_YAML).MODEL.EXTRA.PRETRAINED_LAYERS)
    return cfg


@pytest.mark.parametrize("kind", ["resnet18", "resnet18_wrong_shape",
                                  "hrnet"])
def test_load_pretrained_against_fhpe_tpu(tmp_path, kind):
    cfg = _pretrained_cfg(kind)
    trunk = (_hrnet_trunk(cfg) if kind == "hrnet"
             else _resnet18_trunk(cfg, kind.endswith("wrong_shape")))
    path = str(tmp_path / "trunk.pth")
    torch.save(trunk, path)
    cfg.MODEL.INIT_WEIGHTS = True
    cfg.MODEL.PRETRAINED = path

    model = _seeded(cfg, 0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    variables = import_for_model(cfg, {k: v.numpy() for k, v in init.items()})
    loaded_jax, n_jax = load_pretrained_jax(cfg, variables)
    n = load_pretrained(cfg, model)

    assert n == n_jax > 0
    want = state_dict_from_jax(cfg, loaded_jax)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                       msg=k)
    # the trunk came from the file, the head kept its init
    torch.testing.assert_close(got["conv1.weight"], trunk["conv1.weight"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["final_layer.weight"],
                               init["final_layer.weight"], rtol=0, atol=0)
    if kind == "resnet18_wrong_shape":
        torch.testing.assert_close(got["layer1.0.conv1.weight"],
                                   init["layer1.0.conv1.weight"], rtol=0,
                                   atol=0)


def _unchanged(model, before):
    return all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_missing_file_warns_and_does_nothing(caplog):
    cfg = _resnet18_cfg()
    cfg.MODEL.INIT_WEIGHTS = True
    cfg.MODEL.PRETRAINED = "/nonexistent/imagenet.pth"
    model = _seeded(cfg, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logger = logging.getLogger("test_torch_pretrained")
    with caplog.at_level(logging.WARNING):
        assert load_pretrained(cfg, model, logger) == 0
    assert "RANDOM INIT" in caplog.text and cfg.MODEL.PRETRAINED in caplog.text
    assert _unchanged(model, before)


@pytest.mark.parametrize("case", ["hourglass", "init_weights_off",
                                  "empty_path"])
def test_pretrained_noop(tmp_path, case):
    """The hourglass has no pretrained path (even with a file there);
    ``INIT_WEIGHTS`` off or an empty path does nothing."""
    if case == "hourglass":
        cfg = get_default_config()
        cfg.MODEL.NAME = "hourglass"
        cfg.MODEL.EXTRA = MODEL_EXTRAS["hourglass"]()
        cfg.MODEL.EXTRA.NUM_STACKS, cfg.MODEL.EXTRA.NUM_FEATURES = 1, 16
    else:
        cfg = _resnet18_cfg()
    path = str(tmp_path / "x.pth")
    torch.save(_seeded(cfg, 1).state_dict(), path)
    cfg.MODEL.INIT_WEIGHTS = case != "init_weights_off"
    cfg.MODEL.PRETRAINED = "" if case == "empty_path" else path
    model = _seeded(cfg, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained(cfg, model) == 0
    assert _unchanged(model, before)
    assert not np.array_equal(before["conv1.weight"].numpy(),
                              torch.load(path)["conv1.weight"].numpy())
