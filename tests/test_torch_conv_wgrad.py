"""The 3x3 filter-gradient port (P4) on the CPU: its plain version against
the JAX package's ``dw_pallas`` (Pallas interpret mode) and against
``jax.vjp`` of the probe's conv, and the conv that routes its training
backward through it (``models/common.py::Conv3x3``).  The CUDA kernel
itself is checked on the card by ``chip_smoke.py``."""

import importlib.util
import os
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.common import Conv3x3, conv
from fhpe_tpu_torch.ops import conv_wgrad
from fhpe_tpu_torch.ops.conv_wgrad import (BF16_MAX_KPAD, BF16_SMEM_BUDGET,
                                           BF16_SMEM_MAX, BF16_TILE_CI,
                                           Bf16Geometry, bf16_plan,
                                           conv3x3_wgrad,
                                           conv3x3_wgrad_plain, split_k)
from fhpe_tpu_torch.ops.conv_wgrad_cases import (EDGE_SHAPES, STEP_SHAPES,
                                                 STUDENT_SHAPES, WIDE_SHAPES,
                                                 planted_wgrad_cases)
from fhpe_tpu_torch.tools.train_parity import (fpd_cfgs, hrnet_fpd_cfgs,
                                               rn50_cfg)

from test_torch_hourglass import _cfg
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Against the Pallas kernel and the vjp: both sum the same float32 products
# in another order, so dW agrees to float32 rounding of sums over B*H*W
# terms; 1e-5 of max|dW| holds that with room (the interpret-mode run at
# (8,8,8,16) gave 3.8e-5 absolute against the vjp at max|dW| 88.5).
REL_TOL = 1e-5


def _probe():
    spec = importlib.util.spec_from_file_location(
        "dw_pallas_probe", os.path.join(REPO, "scripts/probe/"
                                        "dw_pallas_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe():
    return _probe()


def _nhwc_inputs(shape, seed):
    """x, dy NHWC float32 numpy of ``shape`` (B, H, W, C)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _port_dw(x_nhwc, dy_nhwc):
    """The port's plain P4 on NHWC numpy, returned as HWIO like dw_pallas."""
    x = torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())
    dy = torch.from_numpy(dy_nhwc.transpose(0, 3, 1, 2).copy())
    return conv3x3_wgrad(x, dy).numpy().transpose(2, 3, 1, 0)


def _close(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * scale)


@pytest.mark.parametrize("shape,bc", [((8, 8, 8, 16), 4),
                                      ((4, 6, 10, 8), 2),
                                      ((8, 16, 16, 32), 4)])
def test_plain_matches_dw_pallas(probe, shape, bc):
    """dw_pallas itself, in Pallas interpret mode, over a grid of B / bc
    steps that accumulate into its float32 scratch."""
    x, dy = _nhwc_inputs(shape, seed=shape[-1])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.dw_pallas(jnp.asarray(x), jnp.asarray(dy), bc))
    assert ref.shape == (3, 3, shape[-1], shape[-1])
    _close(_port_dw(x, dy), ref)


@pytest.mark.parametrize("shape", [(8, 8, 8, 16), (4, 6, 10, 8),
                                   (8, 16, 16, 32), (1, 1, 1, 8)])
def test_plain_matches_conv_vjp(probe, shape):
    x, dy = _nhwc_inputs(shape, seed=7)
    c = shape[-1]
    w = jnp.zeros((3, 3, c, c), jnp.float32)
    _, vjp = jax.vjp(lambda ww: probe.conv(jnp.asarray(x), ww), w)
    ref = np.asarray(vjp(jnp.asarray(dy))[0])
    _close(_port_dw(x, dy), ref)


@pytest.mark.parametrize("shape", EDGE_SHAPES[1:])
def test_planted_cases_against_conv_backward(shape):
    """The planted cases the card runs, here through the plain version,
    against torch's own conv weight gradient in float64."""
    for name, x, dy in planted_wgrad_cases(*shape, seed=1):
        xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
        got = conv3x3_wgrad(xt, dyt)
        ref = torch.ops.aten.convolution_backward(
            dyt.double(), xt.double(), torch.zeros(shape[1], shape[1], 3, 3,
                                                   dtype=torch.float64),
            None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        assert got.dtype == torch.float32 and got.shape == ref.shape
        if name == "zero dy":
            assert not got.any()
        _close(got.numpy(), ref.numpy())


ALL_SHAPES = sorted({s for d in STEP_SHAPES.values() for s in d}
                    | set(STUDENT_SHAPES)) + EDGE_SHAPES + WIDE_SHAPES


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_split_k_covers_every_pixel(shape):
    """float32 (``split_k``): the slices cover the B*H*W pixels once.
    bf16 (``bf16_plan``, at 16-byte and 2-byte aligned pointers): the
    block tiles cover every (o, i, tap) of dW once, the slices' K tiles
    cover every pixel once, runs are taken only where the rows are
    aligned runs, and the tile fits the kernel's limits."""
    b, c, h, w = shape
    k = b * h * w
    chunk, slices = split_k(c, k)
    assert chunk % 32 == 0 and slices >= 1
    assert (slices - 1) * chunk < k <= slices * chunk
    for align in (16, 2):
        plan = bf16_plan(b, c, h, w, align)
        dw = np.zeros((c, c, 9), int)
        for m0 in range(0, c, plan.tile_m):
            for i0 in range(0, c, BF16_TILE_CI):
                dw[m0:m0 + plan.tile_m, i0:i0 + BF16_TILE_CI] += 1
        assert (dw == 1).all()
        g = plan.geometry
        assert (g.bands, g.col_tiles) == (-(-h // g.rows), -(-w // g.cols))
        assert plan.k_tiles == b * g.bands * g.col_tiles
        pixels = np.zeros((b, h, w), int)
        for z in range(plan.slices):
            first = z * plan.tiles_per_slice
            assert first < plan.k_tiles
            for t in range(first, min(plan.k_tiles,
                                      first + plan.tiles_per_slice)):
                rest, cc = divmod(t, g.col_tiles)
                sample, band = divmod(rest, g.bands)
                pixels[sample, band * g.rows:(band + 1) * g.rows,
                       cc * g.cols:(cc + 1) * g.cols] += 1
        assert (pixels == 1).all()
        if plan.runs:           # whole-row runs of 16-byte copies
            assert align == 16 and g.cols == w and w % 2 == 0
            assert (h * w) % 8 == 0 and (g.rows * w) % 8 == 0
        assert g.rows == 1 or (g.kpad <= BF16_MAX_KPAD
                               and g.smem <= BF16_SMEM_BUDGET)
        assert g.smem <= BF16_SMEM_MAX
    if shape in {s for d in STEP_SHAPES.values() for s in d}:
        assert bf16_plan(*shape).runs            # 16-byte runs on each step


@pytest.mark.parametrize("c", [8, 32, 64, 512])
def test_bf16_plan_fits_every_width(c):
    """At every W up to past the column span, for H from 1 to 16 and at
    both alignments, the bf16 tile fits an H100 block's shared memory and
    its runs need what the kernel's loads need: a shape whose run tiles
    are all too large (W = 2 mod 4 from 82 up) takes halo columns."""
    for w in range(1, 2 * 128 + 3):
        for h in (1, 2, 3, 4, 5, 7, 8, 16):
            for align in (16, 2):
                plan = bf16_plan(2, c, h, w, align)
                g = plan.geometry
                assert g.smem <= BF16_SMEM_MAX, (h, w, align, plan)
                assert g.kpad <= BF16_MAX_KPAD
                assert g.rows == 1 or g.smem <= BF16_SMEM_BUDGET
                if plan.runs:
                    assert (g.rows * w) % 8 == 0 and g.cols == w
    assert bf16_plan(2, c, 4, 126) is bf16_plan(2, c, 4, 126)   # cached


def _cu_source():
    with open(os.path.join(REPO, "fhpe_tpu_torch/ops/csrc/conv_wgrad.cu"),
              encoding="utf-8") as f:
        return f.read()


def test_bf16_geometry_is_the_kernels_struct():
    """The kernel takes the host's layout as its ``Geometry`` struct, ints
    in the order of ``Bf16Geometry``'s fields, and the host's constants are
    the kernel's."""
    src = _cu_source()
    body = re.search(r"struct Geometry \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b([a-z_]+)\s*[,;]", body)
    assert tuple(fields) == Bf16Geometry._fields
    ints = re.search(r"constexpr int kGeometryInts = (\d+);", src).group(1)
    assert int(ints) == len(Bf16Geometry._fields)
    for name, value in [("kCi", conv_wgrad.BF16_TILE_CI),
                        ("kStages", conv_wgrad.BF16_STAGES),
                        ("kFront", conv_wgrad.BF16_FRONT),
                        ("kOutPitch", conv_wgrad.BF16_OUT_PITCH)]:
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == value, name


def _step_wgrad_shapes(monkeypatch, cfg):
    """The (B, C, H, W) of every conv3x3_wgrad call of one training
    backward of ``cfg``'s model at batch 1, as {shape: calls}.  The
    stand-in checks the call as the wrapper does, then returns zeros of
    dW's shape and dtype: nothing here reads the filter gradients, and
    the plain version's values are held by the cases above."""
    calls = []

    def counting(x, dy):
        calls.append(tuple(x.shape))
        conv_wgrad._check(x, dy)
        c = x.shape[1]
        return x.new_zeros((c, c, 3, 3),
                           dtype=torch.promote_types(x.dtype, torch.float32))

    monkeypatch.setattr("fhpe_tpu_torch.models.common.conv3x3_wgrad",
                        counting)
    monkeypatch.setattr(conv_wgrad, "conv3x3_wgrad", counting)
    torch.manual_seed(0)
    model = get_pose_net(cfg).train()
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    out = model(torch.randn(1, 3, h, w))
    outs = out if isinstance(out, (list, tuple)) else [out]
    sum(o.square().sum() for o in outs).backward()
    return dict(Counter(calls))


@pytest.mark.parametrize("name,cfg", [
    ("hourglass", lambda: fpd_cfgs("float32")[0]),
    ("w48_w32", lambda: hrnet_fpd_cfgs("float32")[0]),
    ("rn50", lambda: rn50_cfg("float32"))])
def test_step_shape_sets_match_the_models(monkeypatch, name, cfg):
    """Each step set of ``conv_wgrad_cases.STEP_SHAPES`` (batch 32) is what
    the student's training backward hands P4, at full width (batch 1)."""
    got = _step_wgrad_shapes(monkeypatch, cfg())
    want = {(1, *s[1:]): n for s, n in STEP_SHAPES[name].items()}
    assert got == want
    assert {s[0] for s in STEP_SHAPES[name]} == {32}


def test_wrapper_rejects_bad_input():
    x = torch.zeros(2, 4, 5, 5)
    with pytest.raises(ValueError, match="one shape"):   # C_in != C_out
        conv3x3_wgrad(x, torch.zeros(2, 6, 5, 5))
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        conv3x3_wgrad(x[0], x[0])
    with pytest.raises(ValueError, match="on the CPU"):
        conv3x3_wgrad(x.half(), x.half())
    with pytest.raises(ValueError, match="share a dtype"):
        conv3x3_wgrad(x, x.double())


def test_conv_factory_routes_only_3x3_stride1_square():
    assert type(conv(8, 8, 3)) is Conv3x3
    for args in ((8, 16, 3), (8, 8, 3, 2), (8, 8, 1), (3, 8, 7, 2)):
        assert type(conv(*args)) is nn.Conv2d


def test_student_has_59_wgrad_convs():
    """The FPD student (4 stacks x 128 features): 3 stem conv2s and 14
    per stack (13 in the depth-4 hourglass, 1 in ``res``), so each
    training step launches P4 59 times on the card."""
    with torch.device("meta"):
        model = get_pose_net(_cfg(4, 128))
    assert sum(isinstance(m, Conv3x3) for m in model.modules()) == 59


def test_gradcheck_float64():
    torch.manual_seed(0)
    m = Conv3x3(3, 3, 3, padding=1).double()
    x = torch.randn(2, 3, 5, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(m, (x,))


@pytest.mark.parametrize("bias", [True, False])
def test_grads_equal_nn_conv2d(bias):
    """float32: forward and every gradient against ``nn.Conv2d`` on the
    same weights (the filter gradient sums in another order)."""
    torch.manual_seed(1)
    ref = nn.Conv2d(8, 8, 3, padding=1, bias=bias)
    m = Conv3x3(8, 8, 3, padding=1, bias=bias)
    m.load_state_dict(ref.state_dict())
    x = torch.randn(3, 8, 9, 7)
    xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
    g = torch.randn(3, 8, 9, 7)
    for mod, xi in zip((m, ref), xs):
        mod(xi).backward(g)
    assert torch.equal(m(x), ref(x))
    np.testing.assert_allclose(xs[0].grad, xs[1].grad, rtol=0, atol=1e-6)
    _close(m.weight.grad.numpy(), ref.weight.grad.numpy())
    if bias:
        np.testing.assert_allclose(m.bias.grad, ref.bias.grad, rtol=1e-6,
                                   atol=1e-6)


def test_bf16_autocast_rounds_weight_grad_like_a_cast():
    """Under bf16 autocast the conv computes on bf16 copies: the filter
    gradient reaches the float32 weight rounded to bf16, as torch's own
    conv (and fhpe_tpu's flax Conv with a bf16 dtype) give it."""
    torch.manual_seed(2)
    ref = nn.Conv2d(8, 8, 3, padding=1)
    m = Conv3x3(8, 8, 3, padding=1)
    m.load_state_dict(ref.state_dict())
    x = torch.randn(2, 8, 6, 6)
    outs = []
    for mod in (m, ref):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = mod(x)
        y.float().square().sum().backward()
        outs.append(y)
    assert outs[0].dtype == outs[1].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])
    for p in ("weight", "bias"):
        g, g_ref = getattr(m, p).grad, getattr(ref, p).grad
        assert g.dtype == torch.float32
        assert torch.equal(g, g.bfloat16().float())     # rounded to bf16
        np.testing.assert_allclose(g, g_ref, rtol=2 ** -7, atol=1e-6)


def test_no_grad_and_backward_routing(monkeypatch):
    """Under no_grad / inference_mode the conv is plain (no P4); a
    training backward calls P4 once per Conv3x3."""
    calls = []
    real = conv_wgrad.conv3x3_wgrad

    def counting(x, dy):
        calls.append(tuple(x.shape))
        return real(x, dy)

    monkeypatch.setattr("fhpe_tpu_torch.models.common.conv3x3_wgrad",
                        counting)
    torch.manual_seed(3)
    model = get_pose_net(_cfg(1, 16, joints=4))
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        model(x)
    with torch.inference_mode():
        model(x)
    assert calls == []
    model.train()
    sum(o.square().sum() for o in model(x)).backward()
    assert len(calls) == sum(isinstance(m, Conv3x3)
                             for m in model.modules()) == 17
    assert conv_wgrad.conv_wgrad_launches == 0          # CPU: plain version


def test_plain_float64_and_layout():
    """dW[o, i, r, c] by its definition, one tap at a time, in float64."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 4, 5)
    dy = rng.randn(2, 3, 4, 5)
    got = conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float64
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    for r in range(3):
        for c in range(3):
            ref = np.einsum("bohw,bihw->oi", dy, xp[:, :, r:r + 4, c:c + 5])
            np.testing.assert_allclose(got[:, :, r, c].numpy(), ref,
                                       rtol=1e-12, atol=1e-12)
