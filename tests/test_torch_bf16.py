"""The port's bfloat16 flow against fhpe_tpu at TPU.COMPUTE_DTYPE bfloat16.

fhpe_tpu's flow: convs in bf16 on float32 parameters, BatchNorm in
float32 emitting bf16, residual adds in bf16, heatmaps cast to float32.
The port gets it from ``utils.dtype.autocast``, the context the Predictor
runs its forwards in.

Two bf16 implementations drift apart with depth, so a loose tolerance on
the served keypoints cannot tell the right flow from an all-float32 or an
all-bf16 one.  The discriminating checks sit where the rounding points can
agree bit for bit: with ``TPU.DEAD_BIAS_SKIP`` on (flax adds a conv bias
in a second bf16 rounding, the CPU conv in its float32 accumulator), at
one Bottleneck and at the first stack's heatmaps.  Each check also runs
the two wrong flows and requires that the same criterion rejects them.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.models.hourglass import Bottleneck as BottleneckJax
from fhpe_tpu.serve import Predictor as PredictorJax
from fhpe_tpu_torch.models import get_pose_net, hourglass
from fhpe_tpu_torch.models.common import bf16_flow_violations
from fhpe_tpu_torch.serve import Predictor
from fhpe_tpu_torch.utils.convert import state_dict_from_jax
from fhpe_tpu_torch.utils.dtype import autocast

from test_torch_hourglass import _cfg, _jax_variables
from test_torch_serve import H, N, W, _serve_cfg
from torch_threads import torch_threads  # noqa: F401

FLOWS = ["port", "all_float32", "all_bfloat16"]


def _run(module: torch.nn.Module, x: torch.Tensor, flow: str):
    """``x`` bf16 NCHW through ``module`` in the given flow."""
    module = copy.deepcopy(module).eval()
    with torch.inference_mode():
        if flow == "port":
            with autocast(torch.bfloat16, "cpu"):
                return module(x)
        if flow == "all_float32":
            return module(x.float())
        return module.to(torch.bfloat16)(x)


def _stats(got: np.ndarray, ref: np.ndarray):
    d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    return float(np.mean(d == 0)), float(d.mean())


def _check(flow, stats, min_exact, max_mean):
    exact, mean = stats
    agrees = exact >= min_exact and mean <= max_mean
    assert agrees == (flow == "port"), (flow, exact, mean)


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg(2, 32, joints=16, dead_bias_skip=True)
    _, variables = _jax_variables(cfg, (64, 128), seed=3)
    port = get_pose_net(cfg).eval()
    port.load_state_dict(state_dict_from_jax(cfg, variables))
    return cfg, variables, port


@pytest.fixture(scope="module")
def bottleneck_refs(tiny):
    """Per block: the port's Bottleneck, its bf16 input (NCHW) and the JAX
    Bottleneck's output on it (float32, NCHW), each JAX output computed
    once for the three flows."""
    _, variables, port = tiny
    blocks = {
        "layer1.0": (("layer1", "block0"), port.layer1[0], 8, True, 8),
        "res.0.0": (("res0", "block0"), port.res[0][0], 16, False, 32),
    }
    cache = {}

    def get(block):
        if block not in cache:
            path, module, planes, down, cin = blocks[block]
            sub = {k: variables[k][path[0]][path[1]]
                   for k in ("params", "batch_stats")}
            x = jnp.asarray(2 * np.random.RandomState(4).randn(
                4, 32, 64, cin), jnp.bfloat16)
            ref = BottleneckJax(planes, downsample=down, dtype=jnp.bfloat16,
                                biased=False).apply(sub, x, train=False)
            ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
            xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))
                                  .transpose(0, 3, 1, 2).copy()).bfloat16()
            cache[block] = module, xt, ref
        return cache[block]
    return get


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("block", ["layer1.0", "res.0.0"])
def test_bf16_bottleneck_matches_jax(bottleneck_refs, block, flow):
    """One pre-activation Bottleneck on a bf16 input.

    Measured on the CPU (seeds 3-5): the port's flow is bit-equal on
    >= 0.999 of the outputs, mean |diff| <= 5e-6; all-float32 on none,
    mean |diff| >= 2.3e-3; all-bf16 (BatchNorm in bf16) on <= 0.87,
    mean |diff| >= 5e-4.  Tolerance: >= 0.99 bit-equal, mean <= 1e-4.
    """
    module, xt, ref = bottleneck_refs(block)
    out = _run(module, xt, flow)
    assert out.dtype == (torch.float32 if flow == "all_float32"
                         else torch.bfloat16)
    _check(flow, _stats(out.float().numpy(), ref), 0.99, 1e-4)


@pytest.fixture(scope="module")
def heatmaps_ref(tiny):
    """The tiny net's input (NHWC float32) and the JAX net's bf16 heatmaps
    on it (stacks, B, J, h, w), computed once for the three flows."""
    cfg, variables, _ = tiny
    x = np.random.RandomState(5).randn(4, 64, 128, 3).astype(np.float32)
    ref = get_pose_net_jax(cfg, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=False)
    return x, np.asarray(ref).transpose(0, 1, 4, 2, 3)


@pytest.mark.parametrize("flow", FLOWS)
def test_bf16_heatmaps_match_jax(tiny, heatmaps_ref, flow):
    """The whole tiny net (2 stacks, non-square 64 x 128 input): the first
    stack's heatmaps, cast to float32 by both models.

    Measured on the CPU (seeds 3-4): the port's flow bit-equal on >= 0.53
    of the values, mean |diff| <= 5.9e-4; all-float32 on none, mean
    >= 1.4e-3; all-bf16 on <= 0.22, mean >= 1.4e-3.  Tolerance: >= 0.4
    bit-equal, mean <= 1e-3.  The second stack is checked only for shape
    and dtype: by then rounding has spread to every flow alike.
    """
    _, _, port = tiny
    x, ref = heatmaps_ref
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    outs = _run(port, xt if flow != "all_bfloat16" else xt.bfloat16(), flow)
    assert [o.dtype for o in outs] == [torch.float32] * 2
    assert [tuple(o.shape) for o in outs] == [(4, 16, 16, 32)] * 2
    _check(flow, _stats(outs[0].numpy(), ref[0]), 0.4, 1e-3)


def test_bf16_dtype_flow(tiny, monkeypatch):
    """Every conv, BatchNorm, Bottleneck and Hourglass takes and emits
    bf16 under the port's autocast, and the heatmaps come out float32.
    ``chip_smoke.py`` runs the same check on the card, whose autocast
    lists other ops as float32 (the upsample among them); an upsample
    that emits float32 must be caught."""
    _, _, port = tiny
    x = torch.randn(2, 3, 64, 128)
    checked, bad = bf16_flow_violations(port, x)
    modules = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d,
                                 hourglass.Bottleneck, hourglass.Hourglass))
                  for m in port.modules())
    assert checked == modules + port.num_stacks
    assert bad == []

    monkeypatch.setattr(hourglass, "upsample_nearest",
                        lambda t: torch.nn.functional.interpolate(
                            t, scale_factor=2, mode="nearest").float())
    _, bad = bf16_flow_violations(port, x)
    assert bad and bad[0][0].startswith("hg.0")


def test_bf16_predictor_matches_jax():
    """The served keypoints at bf16, DEAD_BIAS_SKIP off as in the
    experiment files: 13 crops, flip test on, against the JAX Predictor.

    At this depth the two drift apart by bf16 rounding (merged heatmaps
    up to 0.035 apart, maxvals up to 0.024), and on the tiny random net's
    flat heatmaps that moves the argmax of some joints: preds agreed
    within 1e-3 px on 0.92-0.94 of the joints (CPU, seeds 3-5).
    Tolerance: maxvals within 0.05, preds within 1e-3 px on >= 0.85 of
    the joints.
    """
    cfg = _serve_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    _, variables = _jax_variables(cfg, (H, W), seed=3)
    rng = np.random.RandomState(0)
    crops = rng.randint(0, 256, size=(N, H, W, 3)).astype(np.uint8)
    centers = rng.uniform(100, 300, size=(N, 2))
    scales = rng.uniform(0.8, 1.6, size=(N, 2))

    port = Predictor(cfg, state_dict_from_jax(cfg, variables), batch_size=8,
                     device="cpu")
    preds, maxvals = port.predict_crops(crops, centers, scales)
    ref = PredictorJax(cfg, variables, batch_size=8, n_devices=1)
    ref_preds, ref_maxvals = ref.predict_crops(crops, centers, scales)

    assert preds.dtype == maxvals.dtype == np.float32
    np.testing.assert_allclose(maxvals, ref_maxvals, rtol=0, atol=0.05)
    close = (np.abs(preds - ref_preds) <= 1e-3).all(-1)
    assert close.mean() >= 0.85, close.mean()
