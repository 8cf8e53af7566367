"""Torch-checkpoint import parity: run the actual torch reference models on
random inputs and require our flax models with imported weights to match.

The reference modules under /root/reference/lib are executed here purely as
an *oracle* (they are the shipped behavior we must reproduce); none of
their code is part of the package.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import serialization

from torch_threads import torch_threads  # noqa: F401

torch = pytest.importorskip("torch")
sys.path.insert(0, "/root/reference/lib")

from fhpe_tpu.config import get_default_config, load_config
from fhpe_tpu.config.defaults import MODEL_EXTRAS
from fhpe_tpu.models import get_pose_net
from fhpe_tpu.utils.torch_import import (import_for_model,
                                         load_torch_state_dict)

W32_YAML = "/root/reference/experiments/coco/hrnet/w32_256x192_adam_lr1e-3.yaml"


def _torch_sd_to_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _apply_imported(cfg, imported, x_nhwc):
    model = get_pose_net(cfg, dtype=jnp.float32)
    init = model.init(jax.random.PRNGKey(0), x_nhwc[:1], train=False)
    variables = serialization.from_state_dict(init, imported)
    return model.apply(variables, x_nhwc, train=False)


def test_hourglass_forward_parity():
    from types import SimpleNamespace
    import models.hourglass as ref_hg

    stacks, feats = 2, 64
    rcfg = SimpleNamespace(MODEL=SimpleNamespace(
        EXTRA=SimpleNamespace(NUM_FEATURES=feats, NUM_STACKS=stacks,
                              NUM_BLOCKS=1),
        NUM_JOINTS=8))
    tmodel = ref_hg.get_pose_net(rcfg, is_train=False).eval()

    cfg = get_default_config()
    cfg.MODEL.NAME = "hourglass"
    cfg.MODEL.NUM_JOINTS = 8
    cfg.MODEL.EXTRA = MODEL_EXTRAS["hourglass"]()
    cfg.MODEL.EXTRA.NUM_STACKS = stacks
    cfg.MODEL.EXTRA.NUM_FEATURES = feats

    imported = import_for_model(cfg, _torch_sd_to_numpy(tmodel))

    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        ref_out = tmodel(torch.from_numpy(x))[-1].numpy()

    ours = np.asarray(_apply_imported(
        cfg, imported, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))[-1]
    ours_nchw = np.transpose(ours, (0, 3, 1, 2))
    np.testing.assert_allclose(ours_nchw, ref_out, rtol=1e-3, atol=1e-4)


def test_pose_resnet18_forward_parity():
    import yaml as _yaml
    import models.pose_resnet as ref_rn

    class DCfg(dict):
        __getattr__ = dict.__getitem__

    def wrap(d):
        return (DCfg({k: wrap(v) for k, v in d.items()})
                if isinstance(d, dict) else d)

    rcfg = wrap({"MODEL": {"EXTRA": {
        "NUM_LAYERS": 18, "DECONV_WITH_BIAS": False, "NUM_DECONV_LAYERS": 3,
        "NUM_DECONV_FILTERS": [64, 64, 64], "NUM_DECONV_KERNELS": [4, 4, 4],
        "FINAL_CONV_KERNEL": 1}, "NUM_JOINTS": 8, "INIT_WEIGHTS": False,
        "PRETRAINED": ""}})
    tmodel = ref_rn.get_pose_net(rcfg, is_train=False).eval()

    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 8
    cfg.MODEL.EXTRA = MODEL_EXTRAS["pose_resnet"]()
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [64, 64, 64]

    imported = import_for_model(cfg, _torch_sd_to_numpy(tmodel))

    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        ref_out = tmodel(torch.from_numpy(x)).numpy()
    ours = np.asarray(_apply_imported(
        cfg, imported, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    np.testing.assert_allclose(np.transpose(ours, (0, 3, 1, 2)), ref_out,
                               rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_hrnet_w32_forward_parity():
    import yaml as _yaml
    import models.pose_hrnet as ref_hr

    class DCfg(dict):
        __getattr__ = dict.__getitem__

    def wrap(d):
        return (DCfg({k: wrap(v) for k, v in d.items()})
                if isinstance(d, dict) else d)

    rcfg = wrap(_yaml.safe_load(open(W32_YAML)))
    tmodel = ref_hr.PoseHighResolutionNet(rcfg).eval()

    cfg = load_config(W32_YAML)
    imported = import_for_model(cfg, _torch_sd_to_numpy(tmodel))

    rng = np.random.RandomState(2)
    x = rng.randn(1, 3, 128, 96).astype(np.float32)
    with torch.no_grad():
        ref_out = tmodel(torch.from_numpy(x)).numpy()
    ours = np.asarray(_apply_imported(
        cfg, imported, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    np.testing.assert_allclose(np.transpose(ours, (0, 3, 1, 2)), ref_out,
                               rtol=1e-3, atol=1e-4)


def test_dataparallel_prefix_stripped(tmp_path):
    w = {"module.conv1.weight": torch.randn(4, 3, 3, 3),
         "module.conv1.bias": torch.randn(4)}
    p = tmp_path / "dp.pth"
    torch.save(w, str(p))
    sd = load_torch_state_dict(str(p))
    assert set(sd) == {"conv1.weight", "conv1.bias"}


def test_full_ckpt_format(tmp_path):
    w = {"state_dict": {"module.conv1.weight": torch.randn(4, 3, 3, 3)},
         "epoch": 3}
    p = tmp_path / "full.pth"
    torch.save(w, str(p))
    sd = load_torch_state_dict(str(p))
    assert "conv1.weight" in sd
