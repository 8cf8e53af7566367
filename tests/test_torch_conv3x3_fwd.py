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


# -- the bf16 kernel's tile plan and index math (ops/csrc/conv3x3_bf16.cuh) --

from fhpe_tpu_torch.ops.conv3x3_fwd_cases import (  # noqa: E402
    EDGE_SHAPES, PROBE_SHAPE, RN50_SHAPES, WIDE_SHAPES)

CU_SRC = os.path.join(REPO, "fhpe_tpu_torch", "ops", "csrc",
                      "conv3x3_bf16.cuh")
SMEM_LIMIT = 232448         # an H100's most shared memory a block
THREADS = 256               # kThreads of the bf16 kernel


def _tile_origin(plan, t):
    """(first sample, first row, first column) of tile ``t``, as the
    kernel decodes blockIdx.x."""
    cc, rest = t % plan.col_tiles, t // plan.col_tiles
    return ((rest // plan.bands) * plan.samples,
            (rest % plan.bands) * plan.rows, cc * plan.cols)


def _slot_pixels(plan, b, h, w):
    """For every tile and slot: the slot's output pixel (sample, y, x) and
    whether the kernel writes it, as the kernel's epilogue maps them."""
    t = np.arange(plan.tiles)[:, None]
    n = np.arange(cf.BF16_SLOTS)[None, :]
    cc, rest = t % plan.col_tiles, t // plan.col_tiles
    b0 = (rest // plan.bands) * plan.samples
    y0, x0 = (rest % plan.bands) * plan.rows, cc * plan.cols
    tile_px = plan.rows * plan.cols
    s, r = n // tile_px, n % tile_px
    bb, yy, xx = b0 + s, y0 + r // plan.cols, x0 + r % plan.cols
    ok = (n < plan.samples * tile_px) & (bb < b) & (yy < h) & (xx < w)
    return bb, yy, xx, ok


def _check_plan(b, c, h, w):
    plan = cf.bf16_plan(b, h, w)
    assert plan.patch_w == plan.cols + 2
    assert plan.patch == plan.samples * (plan.rows + 2) * plan.patch_w
    assert plan.patch <= cf.BF16_MAX_PATCH
    assert plan.samples * plan.rows * plan.cols <= cf.BF16_SLOTS
    assert plan.samples == 1 or (plan.rows, plan.cols) == (h, w)
    assert plan.smem == cf.plan_smem(plan.patch) <= SMEM_LIMIT
    bb, yy, xx, ok = _slot_pixels(plan, b, h, w)
    hits = np.zeros(b * h * w, np.int64)
    np.add.at(hits, ((bb * h + yy) * w + xx)[ok], 1)
    assert (hits == 1).all(), (b, c, h, w, plan)


@pytest.mark.parametrize("shape", RN50_SHAPES + [PROBE_SHAPE] + EDGE_SHAPES
                         + WIDE_SHAPES)
def test_bf16_plan_covers_every_pixel_once(shape):
    """Every output pixel of the case shapes belongs to exactly one tile
    slot that the kernel writes; the patch, the slots and the shared
    memory stay within the kernel's limits."""
    _check_plan(*shape)


@pytest.mark.parametrize("h,b", [(1, 1), (3, 2), (8, 3), (17, 1)])
def test_bf16_plan_fits_every_width(h, b):
    """The same for every W from 1 to 258."""
    for w in range(1, 259):
        _check_plan(b, 8, h, w)


def test_bf16_plan_is_the_kernels_struct():
    """The kernel takes the host's plan as its ``Plan`` struct, ints in the
    order of ``Bf16Plan``'s fields; its constants and its shared-memory
    formula are the host's."""
    import re
    src = open(CU_SRC).read()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    assert tuple(re.findall(r"\b([a-z_]+)\s*[,;]", body)) == \
        cf.Bf16Plan._fields
    ints = re.search(r"constexpr int kPlanInts = (\d+);", src).group(1)
    assert int(ints) == len(cf.Bf16Plan._fields)
    for name, value in (("kTileM", cf.BF16_TILE_M), ("kSlots", cf.BF16_SLOTS),
                        ("kChunk", cf.BF16_CHUNK), ("kPitch", cf.BF16_PITCH),
                        ("kMaxPatch", cf.BF16_MAX_PATCH),
                        ("kThreads", THREADS)):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == value, name
    assert "kWeightBytes = 9 * kTileM * kPitch * 2;" in src
    assert cf.BF16_WEIGHT_BYTES == 9 * cf.BF16_TILE_M * cf.BF16_PITCH * 2
    assert "kWeightBytes + p.patch * (kPitch * 2 + 4)" in src


def _byte_perm(a, b, sel):
    """CUDA's ``__byte_perm`` on words given as their four bytes."""
    src = list(a) + list(b)
    return [src[(sel >> (4 * i)) & 7] for i in range(4)]


def _weight_transpose():
    """{(tap, channel of 8): value e of the 72-value unit} as the kernel's
    store() assembles it: register k holds values 2k (low half) and 2k + 1
    (high half), each 16-bit half two tagged bytes, and the byte permutes
    of the source pick them."""
    words = [[(2 * k, 0), (2 * k, 1), (2 * k + 1, 0), (2 * k + 1, 1)]
             for k in range(36)]
    out = {}
    for tap in range(9):
        for k in range(4):
            e0 = 2 * k * 9 + tap
            e1 = e0 + 9
            sel = ((0x0032 if e0 & 1 else 0x0010)
                   | (0x7600 if e1 & 1 else 0x5400))
            got = _byte_perm(words[e0 >> 1], words[e1 >> 1], sel)
            for half in range(2):
                lo, hi = got[2 * half], got[2 * half + 1]
                assert lo[0] == hi[0] and (lo[1], hi[1]) == (0, 1)
                out[(tap, 2 * k + half)] = lo[0]
    return out


def _emulate_bf16_kernel(x, wt):
    """The bf16 kernel's index math in float64: the plan, the patch's pixel
    table, each chunk's pixel-major x staging and transposed weight
    staging (through the byte permutes), the ldmatrix row addresses with
    each tap's row offset, and the epilogue's slot -> pixel map.  Returns
    y and how many times each output was written."""
    b, c, h, w = x.shape
    plan = cf.bf16_plan(b, h, w)
    hw, pitch, tm = h * w, cf.BF16_PITCH, cf.BF16_TILE_M
    xf, wf = x.reshape(-1), wt.reshape(-1)
    y = torch.zeros(b * c * hw, dtype=torch.float64)
    writes = torch.zeros(b * c * hw, dtype=torch.int64)
    table = _weight_transpose()
    # trans[tap, k8]: the unit's value stored at (tap, channel k8)
    trans = torch.tensor([[table[(tap, k8)] for k8 in range(8)]
                          for tap in range(9)])[:, None, :]
    k8 = torch.arange(8)[None, :]
    sample_patch = (plan.rows + 2) * plan.patch_w
    tile_px = plan.rows * plan.cols
    n_valid = plan.samples * tile_px
    q = torch.arange(plan.patch)
    n = torch.arange(cf.BF16_SLOTS)
    # the B rows: slot n reads patch pixel pos(n) + the tap's offset
    s_n, r_n = n // tile_px, n % tile_px
    pos = torch.where(n < n_valid, s_n * sample_patch
                      + (r_n // plan.cols) * plan.patch_w
                      + r_n % plan.cols, torch.zeros_like(n))
    tid = torch.arange(THREADS)
    o_l, gq = tid >> 2, tid & 3
    for t in range(plan.tiles):
        b0, y0, x0 = _tile_origin(plan, t)
        s, r = q // sample_patch, q % sample_patch
        yy, xx = y0 - 1 + r // plan.patch_w, x0 - 1 + r % plan.patch_w
        bb = b0 + s
        inside = (bb < b) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        pix = torch.where(inside, bb * c * hw + yy * w + xx,
                          torch.full_like(q, -1))
        for m0 in range(0, c, tm):
            acc = torch.zeros(tm, cf.BF16_SLOTS, dtype=torch.float64)
            for c0 in range(0, c, cf.BF16_CHUNK):
                # unit u = g P + q: 8 channels of patch pixel q
                xs = torch.zeros(plan.patch, pitch, dtype=torch.float64)
                for g in range(4):
                    for k in range(8):
                        ch = c0 + 8 * g + k
                        ok = (pix >= 0) & (ch < c)
                        src = torch.where(ok, pix + ch * hw,
                                          torch.zeros_like(pix))
                        xs[:, 8 * g + k] = torch.where(
                            ok, xf[src], torch.zeros_like(xf[src]))
                # thread (o_l, gq): 72 values of 8 channels x 9 taps
                o = (m0 + o_l)[None, :, None]
                ch0 = (c0 + 8 * gq)[None, :, None]
                ok = (o < c) & (ch0 + trans // 9 < c)
                src = torch.where(ok, (o * c + ch0) * 9 + trans,
                                  torch.zeros_like(ok, dtype=torch.int64))
                ws = torch.zeros(9, tm, pitch, dtype=torch.float64)
                ws[:, o_l[:, None], (8 * gq)[:, None] + k8] = torch.where(
                    ok, wf[src], torch.zeros_like(wf[src]))
                for tap in range(9):
                    rows = xs[pos + (tap // 3) * plan.patch_w + tap % 3]
                    k = cf.BF16_CHUNK
                    acc += ws[tap, :, :k] @ rows[:, :k].T
            bb, yy, xx = b0 + s_n, y0 + r_n // plan.cols, x0 + r_n % plan.cols
            ok = (n < n_valid) & (bb < b) & (yy < h) & (xx < w)
            for o in range(m0, min(c, m0 + tm)):
                dst = (bb * c + o) * hw + yy * w + xx
                y[dst[ok]] = acc[o - m0, ok]
                writes[dst[ok]] += 1
    return y.view(b, c, h, w), writes


@pytest.mark.parametrize("shape", EDGE_SHAPES[:2] + EDGE_SHAPES[3:]
                         + WIDE_SHAPES)
def test_bf16_kernel_emulation_matches_plain(shape):
    """The emulated kernel against the plain version in float64 on every
    planted case: each output written exactly once, within float64
    rounding of the sums, zero weights giving exactly 0."""
    for name, x, wt in conv_cases(*shape, seed=sum(shape)):
        xt, wtt = torch.from_numpy(x).double(), torch.from_numpy(wt).double()
        got, writes = _emulate_bf16_kernel(xt, wtt)
        assert (writes == 1).all(), name
        ref = cf.conv3x3_fwd_plain(xt, wtt)
        scale = ref.abs().max().item()
        if name == "zero weights":
            assert not got.any()
            continue
        assert (got - ref).abs().max().item() <= F64_REL_TOL * scale, name
