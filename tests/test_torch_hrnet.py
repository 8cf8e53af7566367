"""Port HRNet against fhpe_tpu: parameter counts, the weight-name contract
(``import_hrnet`` round trip), the eval forward, the bf16 dtype flow, and
the Predictor on a single-tensor model."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.config import get_default_config
from fhpe_tpu.config.defaults import MODEL_EXTRAS
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.utils.torch_import import import_hrnet
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import (get_pose_net, is_multi_output,
                                   param_count, pose_hrnet)
from fhpe_tpu_torch.models.common import (bf16_flow_violations,
                                          he_scale_weights)
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 96   # HRNet halves each side five times: multiples of 32


def hrnet_cfg(joints=17):
    """A narrow HRNet: widths 8/16/32/64, BASIC blocks; stage 2 has two
    blocks per branch and stage 4 two modules, so a multi-block branch and
    a stage-4 module with and without ``multi_scale_output`` all run."""
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_hrnet"
    cfg.MODEL.NUM_JOINTS = joints
    cfg.MODEL.IMAGE_SIZE = [W, H]
    cfg.MODEL.HEATMAP_SIZE = [W // 4, H // 4]
    cfg.DATASET.DATASET = "coco"
    cfg.MODEL.EXTRA = MODEL_EXTRAS["pose_hrnet"]()
    for s, widths in ((2, [8, 16]), (3, [8, 16, 32]), (4, [8, 16, 32, 64])):
        st = cfg.MODEL.EXTRA[f"STAGE{s}"]
        st.NUM_CHANNELS = widths
        st.NUM_BRANCHES = len(widths)
        st.NUM_BLOCKS = [2 if s == 2 else 1] * len(widths)
        st.NUM_MODULES = 2 if s == 4 else 1
    return cfg


def stage_cfgs(cfg):
    return {k: dict(cfg.MODEL.EXTRA[k]) for k in ("STAGE2", "STAGE3",
                                                  "STAGE4")}


def he_weights(cfg, seed):
    """He-scale conv kernels, random BN scale and bias from numpy, BN
    running statistics from one seeded batch (``he_scale_weights``): the
    port state_dict and the same weights as fhpe_tpu variables through
    ``import_hrnet``."""
    sd = he_scale_weights(get_pose_net(cfg), seed, (H, W))
    variables = import_hrnet({k: v.numpy() for k, v in sd.items()},
                             stage_cfgs(cfg))
    return sd, variables


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("yaml,expect", [
    ("w32_256x192_adam_lr1e-3.yaml", 28_536_113),
    ("w48_256x192_adam_lr1e-3.yaml", 63_595_745)])
def test_hrnet_param_count(yaml, expect):
    cfg = load_config(os.path.join(REPO, "experiments/coco/hrnet", yaml))
    with torch.device("meta"):
        model = get_pose_net(cfg)
    assert param_count(model) == expect
    assert not is_multi_output(model)


def test_hrnet_state_dict_round_trip():
    """import_hrnet(port.state_dict()) consumes every key and rebuilds the
    flax tree exactly; state_dict_from_jax inverts it exactly (strict)."""
    cfg = hrnet_cfg()
    model = get_pose_net_jax(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=False))
    rng = np.random.RandomState(0)   # fhpe_tpu's tree, every leaf random
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    port = get_pose_net(cfg)
    port.load_state_dict(state_dict_from_jax(cfg, variables))   # strict
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _leaves_equal(import_hrnet(sd, stage_cfgs(cfg)), variables)

    fresh = he_scale_weights(port, 1, (H, W))
    back = state_dict_from_jax(cfg, import_hrnet(
        {k: v.numpy() for k, v in fresh.items()}, stage_cfgs(cfg)))
    assert back.keys() == fresh.keys()
    for k in fresh:
        assert torch.equal(back[k], fresh[k]), k


def test_hrnet_reference_init():
    """normal(0, 0.001) conv kernels, zero final bias, BN 1 / 0."""
    port = get_pose_net(hrnet_cfg())
    w = torch.cat([m.weight.flatten() for m in port.modules()
                   if isinstance(m, torch.nn.Conv2d)])
    assert 0.0008 < w.std().item() < 0.0012
    assert torch.equal(port.final_layer.bias, torch.zeros(17))
    for m in port.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))


@pytest.mark.parametrize("seed", [1, 2])
def test_hrnet_eval_forward_matches_jax(seed):
    """Heatmaps, float32, eval mode, He-scale weights (``he_weights``):
    within 5e-5 of the largest |heatmap| (measured <= 6e-6 on the CPU; the
    two convolution libraries sum in another order, and the narrow
    channels' BN statistics amplify that rounding)."""
    cfg = hrnet_cfg()
    sd, variables = he_weights(cfg, seed)
    x = np.random.RandomState(seed + 10).randn(2, H, W, 3).astype(np.float32)
    ref = np.asarray(get_pose_net_jax(cfg, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)

    port = get_pose_net(cfg).eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        out = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert out.dtype == torch.float32
    assert out.shape == (2, 17, H // 4, W // 4)
    scale = np.abs(ref).max()
    assert 1.0 < scale < 1e3   # not ~0 (reference init), not blown up
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-5 * scale)


def test_hrnet_bf16_dtype_flow(monkeypatch):
    """Every conv, BN, block, branch chain and fuse upsample that runs
    takes and emits bf16 under the port's autocast; the heatmaps come out
    float32.  The blocks inside a fused ``BranchChain`` do not run (the
    chain is one P5 call), so the count is every checked module but those
    75 (the 13 chains hold 15 blocks, 30 convs and 30 BNs), plus the
    heatmaps: 127.
    An upsample that emits float32 (what CUDA autocast does to
    ``F.interpolate``) must be caught at the first fuse."""
    port = get_pose_net(hrnet_cfg()).eval()
    x = torch.randn(2, 3, H, W)
    checked, bad = bf16_flow_violations(port, x)
    chains = [m for m in port.modules()
              if isinstance(m, pose_hrnet.BranchChain) and m.fused]
    inside = {id(s) for ch in chains for s in ch.modules() if s is not ch}
    assert len(chains) == 13 and len(inside) == 75
    assert checked == 127 == 1 + sum(isinstance(m, (
        torch.nn.Conv2d, torch.nn.BatchNorm2d, *port.flow_blocks))
        and id(m) not in inside for m in port.modules())
    assert bad == []

    monkeypatch.setattr(pose_hrnet.UpsampleNearest, "forward",
                        lambda self, t: torch.nn.functional.interpolate(
                            t, scale_factor=self.factor).float())
    _, bad = bf16_flow_violations(port, x)
    assert bad and bad[0][0] == "stage2.0.fuse_layers.0.1.2"


def test_predictor_keeps_the_batch_of_a_single_tensor_model():
    """HRNet returns one (B, J, h, w) tensor: the Predictor must not index
    it as the hourglass's per-stack list (``model(x)[-1]`` would keep the
    last sample only)."""
    cfg = hrnet_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.FLIP_TEST = False
    sd, _ = he_weights(cfg, 3)
    p = Predictor(cfg, sd, batch_size=4, device="cpu")
    crops = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, size=(4, H, W, 3)).astype(np.uint8))
    hm = p.merged_heatmaps(crops)
    assert hm.shape == (4, 17, H // 4, W // 4)
    from fhpe_tpu_torch.ops.preprocess import normalize_images
    with torch.no_grad():
        ref = p.model(normalize_images(crops))
    assert torch.equal(hm, ref)
