"""Port hourglass against fhpe_tpu: parameter counts, the weight-name
contract (``import_hourglass`` round trip) and the eval forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.config import get_default_config
from fhpe_tpu.config.defaults import MODEL_EXTRAS
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.utils.torch_import import import_hourglass
from fhpe_tpu_torch.models import get_pose_net, param_count
from fhpe_tpu_torch.utils.convert import state_dict_from_jax

from torch_threads import torch_threads  # noqa: F401


def _cfg(stacks, feats, joints=16, dead_bias_skip=False):
    cfg = get_default_config()
    cfg.MODEL.NAME = "hourglass"
    cfg.MODEL.NUM_JOINTS = joints
    cfg.MODEL.EXTRA = MODEL_EXTRAS["hourglass"]()
    cfg.MODEL.EXTRA.NUM_STACKS = stacks
    cfg.MODEL.EXTRA.NUM_FEATURES = feats
    cfg.TPU.DEAD_BIAS_SKIP = dead_bias_skip
    return cfg


def _jax_variables(cfg, hw, seed=0):
    """flax init, with BN scale/bias/mean/var randomized (numpy) so the
    eval-mode BatchNorm is not the identity."""
    model = get_pose_net_jax(cfg, dtype=jnp.float32)
    init = model.init(jax.random.PRNGKey(seed),
                      jnp.zeros((1, hw[0], hw[1], 3)), train=False)
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale" or name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if path[-2].key == "BatchNorm_0":   # BN bias and mean
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(perturb, dict(init))
    return model, variables


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("stacks,feats,expect", [(4, 128, 3_287_936),
                                                 (8, 256, 25_594_624)])
def test_hourglass_param_count(stacks, feats, expect):
    with torch.device("meta"):
        model = get_pose_net(_cfg(stacks, feats))
    assert param_count(model) == expect


@pytest.mark.parametrize("dead_bias_skip", [False, True])
def test_state_dict_round_trip(dead_bias_skip):
    """import_hourglass(port.state_dict()) rebuilds the flax tree exactly,
    and state_dict_from_jax inverts it exactly."""
    cfg = _cfg(2, 32, joints=4, dead_bias_skip=dead_bias_skip)
    _, variables = _jax_variables(cfg, (64, 64))
    port = get_pose_net(cfg)
    port.load_state_dict(state_dict_from_jax(cfg, variables))   # strict
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _leaves_equal(import_hourglass(sd, 2, 1), variables)

    fresh = get_pose_net(cfg).state_dict()
    back = state_dict_from_jax(cfg, import_hourglass(
        {k: v.numpy() for k, v in fresh.items()}, 2, 1))
    assert back.keys() == fresh.keys()
    for k in fresh:
        assert torch.equal(back[k], fresh[k]), k


@pytest.mark.parametrize("dead_bias_skip", [False, True])
def test_eval_forward_matches_jax(dead_bias_skip):
    """Per-stack heatmaps, float32, eval mode, within atol 1e-4.

    The two convolution libraries sum in another order and eval BN is
    folded differently (torch: x * (w * invstd) + shift), so the float32
    results differ by rounding that grows through ~60 layers.  The input
    is non-square, 64 x 128 (H x W): the net halves each side six times,
    so the sides must be multiples of 64.
    """
    cfg = _cfg(2, 32, joints=4, dead_bias_skip=dead_bias_skip)
    hw = (64, 128)
    model, variables = _jax_variables(cfg, hw, seed=1)
    x = np.random.RandomState(2).randn(2, hw[0], hw[1], 3).astype(np.float32)

    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = get_pose_net(cfg).eval()
    port.load_state_dict(state_dict_from_jax(cfg, variables))
    with torch.no_grad():
        outs = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(outs) == ref.shape[0] == 2
    for s, out in enumerate(outs):
        assert out.dtype == torch.float32
        assert out.shape == (2, 4, hw[0] // 4, hw[1] // 4)
        np.testing.assert_allclose(out.numpy(),
                                   ref[s].transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-4)


def test_unported_models_raise():
    """Every MODEL.NAME of fhpe_tpu is ported; the port refuses a
    PoseResNet deconv of kernel 3, where fhpe_tpu's Deconv departs from
    torch's (ROADMAP.md queue C), and an unknown name."""
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.EXTRA = MODEL_EXTRAS["pose_resnet"]()
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [3, 3, 3]
    with torch.device("meta"), pytest.raises(NotImplementedError,
                                             match="queue C"):
        get_pose_net(cfg)
    cfg.MODEL.NAME = "pose_resnet2"
    with pytest.raises(KeyError):
        get_pose_net(cfg)
