"""Train-mode BatchNorm (+ ReLU) of the port (``ops/batch_norm.py``,
``models/common.py::BatchNorm2d``) on the CPU.

The plain Function is held to ``nn.BatchNorm2d`` + ``F.relu`` in float64
(outputs, running statistics, gradients) and to ``gradcheck``; the
kernels' plan over every student shape of the two CNN steps; the kernels'
arithmetic (``ops/csrc/batch_norm.cu``: the walk over a CTA's chunk, the
threads' shifted sums, the fixed-order merges) by a numpy emulation at
small shapes against float64; the models' keys, loads and bf16 flow with
the ReLU folded into their BatchNorms.  The kernels themselves run only
on the card (``tools/profile_bn.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import copy
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.common import (BatchNorm2d, batch_norm,
                                          bf16_flow_violations)
from fhpe_tpu_torch.models.pose_hrnet import BranchChain
from fhpe_tpu_torch.ops import batch_norm as bn
from fhpe_tpu_torch.ops.batch_norm_cases import (EDGE_SHAPES, STEP_SHAPES,
                                                 W32_CHAIN_STEP, bn_inputs)
from fhpe_tpu_torch.tools.train_parity import fpd_cfgs, hrnet_fpd_cfgs, \
    rn50_cfg

from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SRC = (REPO / "fhpe_tpu_torch" / "ops" / "csrc" / "batch_norm.cu").read_text()
VIT_STUDENT = str(REPO / "experiments_torch" / "fpd_coco" / "vitpose" /
                  "vitpose_b_fpd_student.yaml")
STUDENT_SHAPES = sorted({s for d in (*STEP_SHAPES.values(), W32_CHAIN_STEP)
                         for s in d})


def _case(shape, seed, dtype=torch.float64):
    x, dy, gamma, beta, rm, rv = (torch.from_numpy(a).to(dtype)
                                  for a in bn_inputs(*shape, seed=seed))
    return x, dy, gamma, beta, rm, rv


# -- the plain Function against nn.BatchNorm2d + F.relu -----------------------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (4, 3, 1, 1), (2, 6, 4, 4)])
def test_plain_function_matches_batchnorm_module(shape, relu):
    x, dy, gamma, beta, rm, rv = _case(shape, seed=sum(shape))
    ref = nn.BatchNorm2d(shape[1], eps=1e-5, momentum=0.1).double().train()
    with torch.no_grad():
        ref.weight.copy_(gamma)
        ref.bias.copy_(beta)
        ref.running_mean.copy_(rm)
        ref.running_var.copy_(rv)
    xs = x.clone().requires_grad_(True)
    g, b = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    rm_f, rv_f = rm.clone(), rv.clone()
    y = bn.BatchNormFn.apply(xs, g, b, rm_f, rv_f, 0.1, 1e-5, relu)
    xr = x.clone().requires_grad_(True)
    yr = ref(xr)
    yr = F.relu(yr) if relu else yr
    assert torch.equal(y, yr)
    assert torch.equal(rm_f, ref.running_mean)
    assert torch.equal(rv_f, ref.running_var)
    got = torch.autograd.grad(y, (xs, g, b), dy)
    want = torch.autograd.grad(yr, (xr, ref.weight, ref.bias), dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_function_gradcheck(relu):
    x, _, gamma, beta, _, _ = _case((3, 2, 3, 4), seed=5)
    args = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    assert torch.autograd.gradcheck(
        lambda x_, g_, b_: bn.BatchNormFn.apply(x_, g_, b_, None, None, 0.1,
                                                1e-5, relu), args)


@pytest.mark.parametrize("momentum", [0.1, None])
@pytest.mark.parametrize("relu", [False, True])
def test_module_kernel_route_follows_batchnorm2d(monkeypatch, momentum,
                                                 relu):
    """The module's kernel route (its own running-statistics factor and
    ``num_batches_tracked``), here through the plain Function, against
    ``nn.BatchNorm2d`` over three train steps and an eval forward."""
    monkeypatch.setattr(BatchNorm2d, "takes_kernel",
                        lambda self, x: self.training
                        and torch.is_grad_enabled())
    mod = BatchNorm2d(4, momentum=momentum, relu=relu).double()
    ref = nn.BatchNorm2d(4, momentum=momentum).double()
    ref.load_state_dict(mod.state_dict())
    for step in range(3):
        x = torch.randn(3, 4, 5, 5, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(step)) + step
        y, yr = mod(x), ref(x)
        assert torch.equal(y, F.relu(yr) if relu else yr)
    for k, v in ref.state_dict().items():
        assert torch.equal(mod.state_dict()[k], v), k
    assert int(mod.num_batches_tracked) == 3
    mod.eval(), ref.eval()
    x = torch.randn(2, 4, 3, 3, dtype=torch.float64)
    assert torch.equal(mod(x), F.relu(ref(x)) if relu else ref(x))


def test_module_keeps_batchnorm2d_off_the_card():
    """On the CPU, in eval mode and under no_grad the module is
    ``nn.BatchNorm2d``'s forward (then F.relu), bit for bit."""
    torch.manual_seed(0)
    mod = batch_norm(6, relu=True).double()
    ref = nn.BatchNorm2d(6).double()
    ref.load_state_dict(mod.state_dict())
    x = torch.randn(2, 6, 4, 4, dtype=torch.float64, requires_grad=True)
    assert not mod.takes_kernel(x)
    assert torch.equal(mod(x), F.relu(ref(x)))
    assert isinstance(mod, nn.BatchNorm2d) and mod.relu
    assert list(mod.state_dict()) == list(ref.state_dict())


def test_backward_plain_matches_aten():
    """The plain backward (the kernels' formula) against ATen's
    ``native_batch_norm_backward`` in float64, ReLU off."""
    x, dy, gamma, beta, rm, rv = _case((4, 3, 5, 6), seed=2)
    _, mean, invstd = torch.ops.aten.native_batch_norm(
        x, gamma, beta, rm, rv, True, 0.1, 1e-5)
    got = bn.batch_norm_backward(dy, x, mean, invstd, gamma, beta, False)
    want = torch.ops.aten.native_batch_norm_backward(
        dy, x, gamma, rm, rv, mean, invstd, True, 1e-5, [True, True, True])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)


def test_apply_plain_matches_the_forward():
    x, _, gamma, beta, rm, rv = _case((3, 4, 5, 5), seed=3)
    for relu in (False, True):
        y, mean, invstd = bn.batch_norm_train(x, gamma, beta, rm.clone(),
                                              rv.clone(), 0.1, 1e-5, relu)
        torch.testing.assert_close(
            bn.batch_norm_apply(x, mean, invstd, gamma, beta, relu), y,
            rtol=1e-12, atol=1e-12)


def test_wrappers_check_their_inputs():
    x = torch.zeros(2, 4, 3, 3)
    c = torch.ones(4)
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        bn.batch_norm_train(x[0], c, c, None, None)
    with pytest.raises(ValueError, match="per-channel"):
        bn.batch_norm_train(x, torch.ones(3), c, None, None)
    with pytest.raises(ValueError, match="more than 1 value"):
        bn.batch_norm_train(torch.zeros(1, 4, 1, 1), c, c, None, None)
    with pytest.raises(ValueError, match="on the CPU"):
        bn.batch_norm_train(x.half(), c, c, None, None)
    with pytest.raises(ValueError, match="differ"):
        bn.batch_norm_backward(x[:1], x, c, c, c, c)


# -- the kernels' plan ---------------------------------------------------------

def test_source_constants_match_the_plan():
    for name, value in [("kMaxThreads", bn.MAX_THREADS),
                        ("kMaxCluster", bn.MAX_CLUSTER),
                        ("kHeld", bn.HELD)]:
        got = re.search(rf"constexpr int {name} = (\d+);", SRC).group(1)
        assert int(got) == value, name
    assert "Replaces no TPU kernel" in SRC
    assert "What bounds it: device memory" in SRC
    assert "atomic" not in SRC.replace("no atomics", "")


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", STUDENT_SHAPES)
def test_plan_fills_the_card_at_every_student_shape(shape, itemsize):
    """16-byte units, at least two waves of CTAs (one per SM), every unit
    in a thread's registers up to 64 x 64 in bf16, whole warps."""
    n, c, h, w = shape
    p = bn.plan(n, c, h * w, itemsize)
    assert p.vec == 16 // itemsize
    assert c * p.cluster >= 2 * bn.SMS
    assert p.units * p.vec == n * h * w
    assert p.cluster <= bn.MAX_CLUSTER
    assert p.threads % 32 == 0 and 32 <= p.threads <= bn.MAX_THREADS
    if itemsize == 2:   # every unit in a register up to 64 x 64
        held = p.cluster * p.threads * bn.HELD >= p.units
        assert held == (h * w <= 64 * 64)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_plan_covers_edge_shapes(shape):
    n, c, h, w = shape
    for itemsize in (2, 4):
        for aligned in (True, False):
            p = bn.plan(n, c, h * w, itemsize, aligned)
            wide = 16 // itemsize
            assert p.vec == (wide if aligned and (h * w) % wide == 0 else 1)
            assert p.units * p.vec == n * h * w
            assert 1 <= p.cluster <= min(bn.MAX_CLUSTER, p.units)
            assert p.threads % 32 == 0 and 32 <= p.threads <= bn.MAX_THREADS


# -- the kernels' arithmetic, emulated -------------------------------------------

F32 = np.float32


def _walk(g, stride, nj, vec, hw_size):
    """Walk's offsets (within the channel: sample * H*W + h*w) of a
    thread's units g, g + stride, ..., stepped as the kernel steps."""
    n, hw = divmod(g * vec, hw_size)
    dn, dh = divmod(stride * vec, hw_size)
    for _ in range(nj):
        yield n * hw_size + hw
        hw, n = hw + dh, n + dn
        if hw >= hw_size:
            hw, n = hw - hw_size, n + 1


def _merge(a, b):
    n = F32(a[0] + b[0])
    if n == 0:
        return a
    f = F32(b[0] / n)
    d = F32(b[1] - a[1])
    return (n, F32(d * f + a[1]), F32(F32(a[2] + b[2]) + d * d * a[0] * f))


def _add(a, b):
    return (F32(a[0] + b[0]), F32(a[1] + b[1]))


def _tree(vals, combine, empty):
    """The warp shuffle tree (shfl_down 16 .. 1) over 32 lanes: lane 0's
    result."""
    lanes = list(vals) + [empty] * (32 - len(vals))
    off = 16
    while off:
        lanes = [combine(lanes[i], lanes[i + off]) if i + off < 32
                 else lanes[i] for i in range(32)]
        off //= 2
    return lanes[0]


def _emulate(x, p, dy=None):
    """The kernels' reduction of one channel: x, dy (N, H*W) float32 ->
    (count, mean, M2) as bn_train_forward reduces them, or with dy (sum g,
    sum g (x - mean)) as bn_train_backward does (mean from the forward's
    emulation; ReLU off): each thread's units in order, its CTA's threads
    in warps and warps in a tree, the cluster's CTAs in rank order.  Also
    asserts the walk covers every unit once, each at its own offset."""
    flat = x.reshape(-1)
    hw_size = x.shape[1]
    stride = p.cluster * p.threads
    seen = np.zeros(p.units, dtype=int)
    shift = flat[0]
    mean = None if dy is None else _emulate(x, p)[1]
    combine, empty = ((_merge, (F32(0),) * 3) if dy is None
                      else (_add, (F32(0),) * 2))
    ctas = []
    for rank in range(p.cluster):
        parts = []
        for t in range(p.threads):
            g = rank * p.threads + t
            nj = (p.units - 1 - g) // stride + 1 if g < p.units else 0
            acc = np.zeros((2, p.vec), dtype=F32)
            for j, off in enumerate(_walk(g, stride, nj, p.vec, hw_size)):
                u = g + j * stride
                assert off == u * p.vec
                seen[u] += 1
                v = flat[off:off + p.vec]
                if dy is None:
                    d = (v - shift).astype(F32)
                    acc[0] += d
                    acc[1] += d * d
                else:
                    gv = dy.reshape(-1)[off:off + p.vec]
                    acc[0] += gv
                    acc[1] += gv * (v - mean).astype(F32)
            t1, t2 = F32(acc[0].sum()), F32(acc[1].sum())
            if dy is not None:
                parts.append((t1, t2))
            elif nj:
                cnt = F32(nj * p.vec)
                d = F32(t1 / cnt)
                parts.append((cnt, F32(shift + d), max(F32(t2 - t1 * d),
                                                       F32(0))))
            else:
                parts.append(empty)
        warps = [_tree(parts[w:w + 32], combine, empty)
                 for w in range(0, len(parts), 32)]
        ctas.append(_tree(warps, combine, empty))
    assert (seen == 1).all()
    return _tree(ctas, combine, empty)


@pytest.mark.parametrize("shape,itemsize,plan", [
    ((3, 2, 7, 9), 2, None),            # single values, 16 CTAs a channel
    ((5, 2, 6, 10), 4, None),           # float32 units
    ((4, 2, 8, 8), 2, None),            # bf16 units, idle threads
    ((6, 1, 4, 4), 2, bn.Plan(8, 12, 3, 32)),      # a stride past a sample
    ((8, 1, 12, 16), 4, bn.Plan(4, 384, 2, 64)),   # held and streamed units
    ((4, 1, 40, 40), 2, bn.Plan(8, 800, 1, 256))])  # a CTA of 8 warps
def test_emulated_kernels_match_float64(shape, itemsize, plan):
    n, c, h, w = shape
    p = plan or bn.plan(n, c, h * w, itemsize)
    assert p.units * p.vec == n * h * w
    x, dy, *_ = bn_inputs(*shape, seed=sum(shape))
    for ch in range(c):
        xc = x[:, ch].reshape(n, h * w)
        dyc = dy[:, ch].reshape(n, h * w)
        count, mean, m2 = _emulate(xc, p)
        x64 = xc.astype(np.float64)
        assert count == n * h * w
        assert abs(mean - x64.mean()) <= 1e-6 * (abs(x64.mean()) + x64.std())
        assert abs(m2 / count - x64.var()) <= 1e-5 * x64.var()
        sg, sgx = _emulate(xc, p, dyc)
        g64 = dyc.astype(np.float64)
        scale = np.abs(g64).sum() * (np.abs(x64 - mean).max() + 1)
        assert abs(sg - g64.sum()) <= 1e-5 * np.abs(g64).sum()
        assert abs(sgx - (g64 * (x64 - mean)).sum()) <= 1e-5 * scale


# -- the students' shapes, keys, loads and flow -----------------------------------

STUDENT_CFGS = {"hourglass": lambda: fpd_cfgs("float32")[0],
                "hrnet": lambda: hrnet_fpd_cfgs("float32")[0],
                "pose_resnet": lambda: rn50_cfg("float32")}


@pytest.fixture(scope="module")
def student():
    """``student(make_cfg) -> (cfg, model)``: the full-width student of a
    ``STUDENT_CFGS`` entry, built once for the module (seed 0) and handed
    out as a fresh copy, with torch's generator where the build left it,
    so that a case draws the inputs it drew when it built its own."""
    built = {}

    def get(make_cfg):
        if make_cfg not in built:
            cfg = make_cfg()
            torch.manual_seed(0)
            model = get_pose_net(cfg)
            built[make_cfg] = cfg, model, torch.get_rng_state()
        cfg, model, rng = built[make_cfg]
        torch.set_rng_state(rng)
        return cfg, copy.deepcopy(model)
    return get


def _bn_calls(cfg, model):
    model.train()
    calls = []
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_hook(
                lambda mod, inp, out: calls.append(tuple(inp[0].shape)))
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    with torch.no_grad():
        model(torch.randn(2, 3, h, w))
    return model, {(32, *s[1:]): k for s, k in Counter(calls).items()}


@pytest.mark.parametrize("name,cfg", [("hourglass", STUDENT_CFGS["hourglass"]),
                                      ("w32", STUDENT_CFGS["hrnet"])])
def test_step_shape_sets_match_the_models(student, name, cfg):
    """Each set of ``batch_norm_cases.STEP_SHAPES`` is the student's
    BatchNorm calls in one train forward (182 and 84); HRNet's chains hold
    ``W32_CHAIN_STEP``'s BatchNorms."""
    model, got = _bn_calls(*student(cfg))
    assert got == STEP_SHAPES[name]
    assert sum(got.values()) == {"hourglass": 182, "w32": 84}[name]
    if name == "w32":
        chains = [m for m in model.modules()
                  if isinstance(m, BranchChain) and m.fused]
        assert sum(W32_CHAIN_STEP.values()) == 8 * len(chains) == 208


@pytest.mark.parametrize("name,cfg,relu", [
    ("hourglass", STUDENT_CFGS["hourglass"], 182),
    ("w32", STUDENT_CFGS["hrnet"], 130),
    ("rn50", STUDENT_CFGS["pose_resnet"], 36)])
def test_models_fold_each_relu_that_follows_a_batchnorm(name, cfg, relu):
    """Every BatchNorm is the port's subclass, with its ReLU where one
    follows it directly (HRNet's: 26 outside the chains, each block's bn1
    inside), and no ReLU module is left."""
    with torch.device("meta"):
        model = get_pose_net(cfg())
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    assert all(type(m) is BatchNorm2d for m in bns)
    assert sum(m.relu for m in bns) == relu
    assert not any(isinstance(m, nn.ReLU) for m in model.modules())


def _swap_plain(model):
    """A copy of ``model`` whose BatchNorms are nn.BatchNorm2d, each
    followed (by a forward hook) by the ReLU it folded: the same keys."""
    model = copy.deepcopy(model)
    for m in list(model.modules()):
        for child_name, child in list(m.named_children()):
            if type(child) is BatchNorm2d:
                plain = nn.BatchNorm2d(child.num_features, child.eps,
                                       child.momentum)
                plain.load_state_dict(child.state_dict())
                if child.relu:
                    plain.register_forward_hook(
                        lambda mod, inp, out: F.relu(out))
                setattr(m, child_name, plain)
    return model


def _family(student, family):
    """(model, input (H, W)): the vit_pose net cut small, the CNN
    students at full width on a quarter (HRNet: half) of each side."""
    if family == "vit_pose":
        cfg = load_config(VIT_STUDENT, [
            "MODEL.IMAGE_SIZE", "[24, 32]", "MODEL.HEATMAP_SIZE", "[6, 8]",
            "MODEL.EXTRA.EMBED_DIM", "32", "MODEL.EXTRA.DEPTH", "1",
            "MODEL.EXTRA.NUM_HEADS", "2",
            "MODEL.EXTRA.NUM_DECONV_FILTERS", "[8, 8]"])
        torch.manual_seed(0)
        return get_pose_net(cfg), (32, 24)
    cfg, model = student(STUDENT_CFGS[family])
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    cut = 2 if family == "hrnet" else 4   # HRNet's sides: multiples of 32
    return model, (h // cut, w // cut)


@pytest.mark.parametrize("family", ["hourglass", "hrnet", "pose_resnet",
                                    "vit_pose"])
def test_reference_loads_and_outputs_unchanged(student, family):
    """Each family's state_dict has the keys of the same net on
    nn.BatchNorm2d + ReLU, loads into it and back (strict), and both give
    the same outputs in train and eval mode."""
    model, hw = _family(student, family)
    plain = _swap_plain(model)
    sd = model.state_dict()
    assert list(sd) == list(plain.state_dict())
    plain.load_state_dict(sd, strict=True)
    model.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(2, 3, *hw)
    for mode in ("train", "eval"):
        a, b = getattr(model, mode)(), getattr(plain, mode)()
        with torch.no_grad():
            ya, yb = a(x), b(x)
        for u, v in zip(*(y if isinstance(y, list) else [y]
                          for y in (ya, yb))):
            assert torch.equal(u, v), (family, mode)


@pytest.mark.parametrize("family", ["hourglass", "hrnet"])
def test_bf16_flow_holds_with_folded_relus(student, family):
    cfg, model = student(STUDENT_CFGS[family])
    model.eval()
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    checked, bad = bf16_flow_violations(model, torch.randn(1, 3, h // 2,
                                                           w // 2))
    assert checked > 100 and bad == []
