"""The 3x3 same-pad conv of the port (``ops/conv3x3_fwd.py``) against the
six Pallas functions of the conv probes P1-P3 in interpret mode and
against ``lax.conv`` in float64; the wrapper's refusals; and which models
route their convs' forwards to it (PoseResNet's 3x3 stride-1 convs, not
the hourglass's or HRNet's).

The probes hard-code their shapes as module globals (B, H, W, C and the
batch tile BT, with the derived WQ, M and MG where a probe has them), so
each is loaded fresh by path and its globals set to a small shape before
the call.  Importing ``pc_test.py`` runs its full-size call, which fails
at once outside interpret mode and prints the caught traceback.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fhpe_tpu.config import get_default_config
from fhpe_tpu.config.defaults import MODEL_EXTRAS
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models import common
from fhpe_tpu_torch.models.common import Conv3x3
from fhpe_tpu_torch.ops import conv3x3_fwd as cf
from fhpe_tpu_torch.ops.conv3x3_fwd_cases import (bf16_ulp, conv_cases,
                                                  within_bf16_ulp)
from fhpe_tpu_torch.utils.dtype import autocast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = os.path.join(REPO, "scripts", "probe")
B, H, W, C, BT = 8, 8, 12, 8, 4      # W a multiple of 4 for the groups
# (file, function, output dtype): P1 writes float32, P2 and P3 bfloat16
PALLAS = [("pallas_conv_probe.py", "conv_a", torch.float32),
          ("pallas_conv_probe.py", "conv_b", torch.float32),
          ("pc_test.py", "conv_c", torch.bfloat16),
          ("pallas_conv_probe2.py", "conv_c", torch.bfloat16),
          ("pallas_conv_probe2.py", "conv_a2", torch.bfloat16),
          ("pallas_conv_probe2.py", "conv_b2", torch.bfloat16)]
# float32 out: the plain version and the probe sum the same exact bf16
# products in float32 in another order, so they differ by float32 rounding
# of the sums only.
F32_REL_TOL = 1e-6
# float64 against lax.conv: rounding of float64 sums over 9C terms.
F64_REL_TOL = 1e-12


def _probe(fname):
    """The probe module loaded fresh, its shape globals set small."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{fname[:-3]}", os.path.join(PROBES, fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.H, mod.W, mod.C, mod.BT = B, H, W, C, BT
    for name, value in (("M", BT * H * W), ("WQ", (W + 4) // 4),
                        ("MG", BT * H * (W // 4))):
        if hasattr(mod, name):
            setattr(mod, name, value)
    return mod


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("fname,fn,out_dtype", PALLAS,
                         ids=[f"{f[:-3]}.{g}" for f, g, _ in PALLAS])
def test_plain_matches_pallas_probe(fname, fn, out_dtype):
    """bf16 NHWC x and HWIO w through the probe in interpret mode, the same
    values as NCHW / OIHW through the plain version: float32 out within
    F32_REL_TOL of max|y|, bfloat16 out within one bf16 ulp of the plain
    value elementwise."""
    rng = np.random.RandomState(len(fname) + len(fn))
    x = jnp.asarray(rng.randn(B, H, W, C), jnp.bfloat16)
    w = jnp.asarray(rng.randn(3, 3, C, C) * 0.1, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(_probe(fname), fn)(x, w)
    assert ref.shape == (B, H, W, C)
    assert ref.dtype == (jnp.float32 if out_dtype == torch.float32
                         else jnp.bfloat16)

    xt = _nchw(x).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(w, np.float32).transpose(3, 2, 0, 1)
                          .copy()).to(torch.bfloat16)
    got = cf.conv3x3_fwd(xt, wt, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    ref = _nchw(ref)
    if out_dtype == torch.float32:
        scale = ref.abs().max().item()
        assert scale > 1.0
        assert (got - ref).abs().max().item() <= F32_REL_TOL * scale
    else:
        assert within_bf16_ulp(ref, got.float())
        assert (got.float() == ref).float().mean() > 0.99


@pytest.mark.parametrize("shape", [(1, 3, 5, 7), (2, 5, 1, 9), (3, 8, 4, 4),
                                   (2, 16, 9, 2)])
def test_plain_matches_lax_conv_float64(shape):
    """Every planted case (``conv_cases``) at odd shapes, float64 on both
    sides; zero weights give exactly 0."""
    b, c, h, w = shape
    for name, x, wt in conv_cases(b, c, h, w, seed=sum(shape)):
        with jax.enable_x64(True):
            ref = jax.lax.conv_general_dilated(
                jnp.asarray(x.transpose(0, 2, 3, 1), jnp.float64),
                jnp.asarray(wt.transpose(2, 3, 1, 0), jnp.float64), (1, 1),
                "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
            ref = np.asarray(ref).transpose(0, 3, 1, 2)
        got = cf.conv3x3_fwd(torch.from_numpy(x).double(),
                             torch.from_numpy(wt).double())
        assert got.dtype == torch.float64
        if name == "zero weights":
            assert torch.equal(got, torch.zeros_like(got))
            continue
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=F64_REL_TOL * scale, err_msg=name)


def test_bf16_ulp():
    v = torch.tensor([1.0, 1.5, -3.0, 0.0, 2.0 ** -20])
    assert bf16_ulp(v).tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -6,
                                    2.0 ** -133, 2.0 ** -27]
    one = torch.tensor([1.0])
    assert within_bf16_ulp(one + 2.0 ** -7, one)
    assert not within_bf16_ulp(one + 2.0 ** -6, one)


def _xw(c=8, dtype=torch.float32):
    return torch.randn(2, c, 5, 6, dtype=dtype), \
        torch.randn(c, c, 3, 3, dtype=dtype)


@pytest.mark.parametrize("what,call,match", [
    ("bias", lambda x, w: cf.conv3x3_fwd(x, w, bias=torch.zeros(8)),
     "no bias"),
    ("stride", lambda x, w: cf.conv3x3_fwd(x, w, stride=2), "stride 1"),
    ("padding", lambda x, w: cf.conv3x3_fwd(x, w, padding=0), "pad 1"),
    ("c_in != c_out", lambda x, w: cf.conv3x3_fwd(
        x, torch.randn(16, 8, 3, 3)), r"\(C, C, 3, 3\)"),
    ("kernel 5", lambda x, w: cf.conv3x3_fwd(x, torch.randn(8, 8, 5, 5)),
     r"\(C, C, 3, 3\)"),
    ("non-contiguous x", lambda x, w: cf.conv3x3_fwd(
        x.transpose(2, 3), w), "contiguous"),
    ("channels_last x", lambda x, w: cf.conv3x3_fwd(
        x.contiguous(memory_format=torch.channels_last), w), "contiguous"),
    ("non-contiguous w", lambda x, w: cf.conv3x3_fwd(
        x, w.transpose(2, 3)), "contiguous"),
    ("dtypes differ", lambda x, w: cf.conv3x3_fwd(x, w.double()),
     "share a dtype"),
    ("float16 out", lambda x, w: cf.conv3x3_fwd(
        x, w, out_dtype=torch.float16), "out_dtype"),
    ("bf16 out of float32", lambda x, w: cf.conv3x3_fwd(
        x, w, out_dtype=torch.bfloat16), "out_dtype"),
    ("float16 on the CPU", lambda x, w: cf.conv3x3_fwd(
        x.half(), w.half()), "on the CPU"),
    ("3-d x", lambda x, w: cf.conv3x3_fwd(x[0], w), r"\(B, C, H, W\)"),
])
def test_wrapper_raises(what, call, match):
    x, w = _xw()
    with pytest.raises(ValueError, match=match):
        call(x, w)


def test_conv3x3_route_matches_the_cudnn_route():
    """A Conv3x3 with ``fwd_kernel`` against one without, float64, with
    grad on and off: outputs and the gradients of x and the weight agree
    (the backward is the same: ATen's input gradient and P4); a biased
    Conv3x3 refuses the route; under bf16 autocast the route emits
    bf16."""
    torch.manual_seed(0)
    ref = Conv3x3(8, 8, 3, padding=1, bias=False).double()
    route = Conv3x3(8, 8, 3, padding=1, bias=False, fwd_kernel=True).double()
    route.load_state_dict(ref.state_dict())
    x = torch.randn(2, 8, 7, 5, dtype=torch.float64, requires_grad=True)
    y_ref, y = ref(x), route(x)
    torch.testing.assert_close(y, y_ref, rtol=1e-12, atol=1e-12)
    dy = torch.randn_like(y)
    g_ref = torch.autograd.grad(y_ref, (x, ref.weight), dy)
    g = torch.autograd.grad(y, (x, route.weight), dy)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(route(x), y_ref, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="no bias"):
        Conv3x3(8, 8, 3, padding=1, fwd_kernel=True)

    route = route.float()
    xf = x.detach().float()
    for grad in (False, True):
        with torch.set_grad_enabled(grad), autocast(torch.bfloat16, "cpu"):
            out = route(xf.contiguous(memory_format=torch.channels_last))
        assert out.dtype == torch.bfloat16
        want = cf.conv3x3_fwd_plain(xf.bfloat16(), route.weight.detach()
                                    .bfloat16())
        assert torch.equal(out, want)


def _resnet_cfg(layers):
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.EXTRA = MODEL_EXTRAS["pose_resnet"]()
    cfg.MODEL.EXTRA.NUM_LAYERS = layers
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [16, 16, 16]
    return cfg


def _hourglass_cfg():
    cfg = get_default_config()
    cfg.MODEL.NAME = "hourglass"
    cfg.MODEL.NUM_JOINTS = 16
    cfg.MODEL.EXTRA = MODEL_EXTRAS["hourglass"]()
    cfg.MODEL.EXTRA.NUM_STACKS = 1
    cfg.MODEL.EXTRA.NUM_FEATURES = 16
    return cfg


def _hrnet_cfg():
    from test_torch_hrnet import hrnet_cfg
    return hrnet_cfg()


@pytest.mark.parametrize("name,make_cfg,hw,per_forward", [
    ("pose_resnet50", lambda: _resnet_cfg(50), (64, 48), 13),
    ("pose_resnet18", lambda: _resnet_cfg(18), (64, 48), 13),
    ("hourglass", _hourglass_cfg, (64, 64), 0),
    ("pose_hrnet", _hrnet_cfg, (96, 64), 0)])
def test_which_models_route_to_the_kernel(monkeypatch, name, make_cfg, hw,
                                          per_forward):
    """Calls of the wrapper per forward, under ``no_grad`` (eval) and with
    grad on (train): PoseResNet's 13 stride-1 3x3 convs, none of the
    hourglass's or HRNet's (their pinned P4 launch counts and cuDNN
    forwards stay)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return cf.conv3x3_fwd(*args, **kwargs)

    monkeypatch.setattr(common, "conv3x3_fwd", counted)
    torch.manual_seed(0)
    model = get_pose_net(make_cfg())
    x = torch.randn(2, 3, *hw)
    model.eval()
    with torch.no_grad():
        model(x)
    assert len(calls) == per_forward
    calls.clear()
    model.train()
    out = model(x)
    assert len(calls) == per_forward
    (out[-1] if isinstance(out, list) else out).sum().backward()
    assert len(calls) == per_forward
