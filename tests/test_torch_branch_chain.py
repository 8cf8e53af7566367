"""The port's HRNet branch chain (``ops/branch_chain.py``, the counterpart
of P5) against fhpe_tpu's: the plain chain against ``chain_reference``
and against the Pallas kernels ``chain_pallas`` in interpret mode; the
running statistics ``BranchChain`` keeps; ``BranchChainFn``'s gradients;
and which chains are routed to the kernels.

The JAX side takes NHWC inputs and HWIO kernels, the port NCHW and OIHW;
both get the same numpy-seeded values.  On the CPU the wrappers run the
plain versions; the CUDA kernels are held to them on the card by
``chip_smoke.py``.

Tolerances (each against the largest |y|): float32 differs only in the
order of the sums and in the variance algorithm (fhpe_tpu's one-pass
E[x^2] - E[x]^2 against the port's two-pass in float32, as fhpe_tpu's
model computes it): measured max |diff| 7.0e-7 and mean 8.7e-8, held to
1e-5 and 1e-6.  bfloat16 rounds four times per block, and a sum taken in
another order lands on the other side of a rounding boundary now and
then: one ulp (2^-8 to 2^-7 of the largest value) that carries into the
next convs (``chain_pallas`` also folds BN into the float32 accumulator
before it rounds): measured max |diff| 7.7e-3 against ``chain_reference``
and 7.4e-3 against ``chain_pallas``, mean 6.6e-4 and 4.6e-4, held to 2^-5
and 2e-3.  Batch statistics: means against sqrt(var + eps), variances
against var + eps.
"""

import os
import re
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.common import BasicBlock, Bottleneck
from fhpe_tpu_torch.models.pose_hrnet import BranchChain
from fhpe_tpu_torch.ops import branch_chain as bc
from fhpe_tpu_torch.ops import conv3x3_fwd as cf
from fhpe_tpu_torch.ops.branch_chain_cases import (EDGE_CASES, W32_SHAPES,
                                                   W48_SHAPES, chain_input,
                                                   chain_params)
from fhpe_tpu_torch.utils import convert

from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "probe", "fused_block"))
from fused_block import chain_reference  # noqa: E402
from fused_block_kernels import chain_pallas  # noqa: E402

Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
Y_MEAN_TOL = {"float32": 1e-6, "bfloat16": 2e-3}
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
X64_TOL = 1e-12
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(b, c, h, w, blocks, seed):
    """x, weights, gammas, betas (float32 torch) and the running statistics
    that match x: the float32 plain chain's batch statistics."""
    p = chain_params(c, blocks, seed)
    x = torch.from_numpy(chain_input(b, c, h, w, seed + 1))
    ws, gs, bs = (list(torch.from_numpy(p[k]).unbind(0))
                  for k in ("weights", "gammas", "betas"))
    ref = bc.branch_chain_train_plain(x, ws, gs, bs)
    return x, ws, gs, bs, list(ref.mean.unbind(0)), list(ref.var.unbind(0))


def _jax_tree(ws, gs, bs, means, variances):
    """fhpe_tpu's per-block params and batch_stats trees."""
    def leaf(t):
        return jnp.asarray(t.numpy())
    params, stats = [], []
    for k in range(len(ws) // 2):
        p, s = {}, {}
        for half, (conv, bn) in enumerate((("conv1", "bn1"),
                                           ("conv2", "bn2"))):
            i = 2 * k + half
            p[conv] = {"Conv_0": {"kernel": jnp.asarray(
                ws[i].numpy().transpose(2, 3, 1, 0))}}
            p[bn] = {"BatchNorm_0": {"scale": leaf(gs[i]),
                                     "bias": leaf(bs[i])}}
            s[bn] = {"BatchNorm_0": {"mean": leaf(means[i]),
                                     "var": leaf(variances[i])}}
        params.append(p)
        stats.append(s)
    return params, stats


def _held(got, ref, name, what=""):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    diff = np.abs(got - ref)
    assert diff.max() <= Y_TOL[name] * scale, (what, diff.max(), scale)
    assert diff.mean() <= Y_MEAN_TOL[name] * scale, (what, diff.mean(), scale)


def _stats_held(mean, var, ref_mean, ref_var, name):
    """Batch means within STATS_TOL of sqrt(var + eps), variances within
    STATS_TOL of var + eps."""
    scale = np.sqrt(np.asarray(ref_var, np.float64) + bc.BN_EPS)
    assert (np.abs(mean.numpy() - ref_mean) / scale).max() <= STATS_TOL[name]
    assert (np.abs(var.numpy() - ref_var) / scale ** 2).max() <= \
        STATS_TOL[name]


def _batch_stats_from(new_stats):
    """fhpe_tpu's chains return 0.9 old + 0.1 batch; with old = 0 the batch
    statistics are 10 x new: (2 nb, C) means and biased variances."""
    rows = [(m1, v1, m2, v2) for (m1, v1, m2, v2) in new_stats]
    means = np.stack([np.asarray(r[k]) for r in rows for k in (0, 2)])
    variances = np.stack([np.asarray(r[k]) for r in rows for k in (1, 3)])
    return 10.0 * means, 10.0 * variances


def _nhwc(t):
    return jnp.asarray(t.float().numpy().transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


# -- the plain chain against fhpe_tpu -------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks,c", [(1, 8), (2, 32), (3, 8), (4, 32)])
def test_plain_chain_matches_chain_reference(blocks, c, name, train):
    dt, jdt = DTYPES[name]
    x, ws, gs, bs, means, variances = _case(4, c, 7, 6, blocks, seed=c + 3)
    xd, wd = x.to(dt), [w.to(dt) for w in ws]
    zeros = [torch.zeros_like(m) for m in means]
    params, stats = _jax_tree(ws, gs, bs, *((zeros, zeros) if train
                                            else (means, variances)))
    y_ref, new_stats = chain_reference(_nhwc(xd), params, stats, train, jdt)
    if train:
        got = bc.branch_chain_train_plain(xd, wd, gs, bs)
        _held(got.y, _nchw(y_ref), name)
        _stats_held(got.mean, got.var, *_batch_stats_from(new_stats), name)
    else:
        got = bc.branch_chain_eval_plain(xd, wd, gs, bs, means, variances)
        _held(got, _nchw(y_ref), name)
    assert got[0].dtype == dt if train else got.dtype == dt


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks,c,w", [(2, 8, 16), (1, 32, 8)])
def test_plain_chain_matches_chain_pallas(blocks, c, w, name, train):
    """P5 itself, in interpret mode (its batch must be a multiple of 4 and
    W of 128 // C)."""
    dt, jdt = DTYPES[name]
    x, ws, gs, bs, means, variances = _case(4, c, 5, w, blocks, seed=c + 11)
    xd, wd = x.to(dt), [t.to(dt) for t in ws]
    zeros = [torch.zeros_like(m) for m in means]
    params, stats = _jax_tree(ws, gs, bs, *((zeros, zeros) if train
                                            else (means, variances)))
    y_ref, new_stats = chain_pallas(_nhwc(xd), params, stats, train, jdt,
                                    interpret=True)
    if train:
        got = bc.branch_chain_train_plain(xd, wd, gs, bs)
        _held(got.y, _nchw(y_ref), name)
        _stats_held(got.mean, got.var, *_batch_stats_from(new_stats), name)
    else:
        _held(bc.branch_chain_eval_plain(xd, wd, gs, bs, means, variances),
              _nchw(y_ref), name)


def test_train_outputs_feed_the_backward():
    """branch_chain_train's saved tensors: each block's input, the pre-BN
    conv outputs, and mean/var/inv per conv, consistent with y."""
    x, ws, gs, bs, _, _ = _case(2, 8, 5, 4, 3, seed=1)
    out = bc.branch_chain_train(x, ws, gs, bs)
    assert len(out.inputs) == 3 and len(out.pre) == 6
    assert out.inputs[0] is x
    assert out.mean.shape == out.var.shape == out.inv.shape == (6, 8)
    torch.testing.assert_close(out.inv, torch.rsqrt(out.var + bc.BN_EPS))
    for i, t in enumerate(out.pre):
        m, v = bc.batch_stats(t)
        torch.testing.assert_close(out.mean[i], m)
        torch.testing.assert_close(out.var[i], v)
    again = bc.branch_chain_train_plain(out.inputs[2], ws[4:], gs[4:], bs[4:])
    torch.testing.assert_close(again.y, out.y, rtol=0, atol=0)


# -- running statistics ------------------------------------------------------

def _chain_module(c, blocks, seed, dtype=torch.float64):
    x, ws, gs, bs, means, variances = _case(3, c, 6, 5, blocks, seed)
    chain = BranchChain(*[BasicBlock(c, c) for _ in range(blocks)])
    convs = [cv for b in chain for cv in (b.conv1, b.conv2)]
    bns = [bn for b in chain for bn in (b.bn1, b.bn2)]
    with torch.no_grad():
        for i, (cv, bn) in enumerate(zip(convs, bns)):
            cv.weight.copy_(ws[i])
            bn.weight.copy_(gs[i])
            bn.bias.copy_(bs[i])
            bn.running_mean.copy_(means[i])
            bn.running_var.copy_(variances[i] + 0.5)
    return chain.to(dtype), x.to(dtype), bns


@pytest.mark.parametrize("momentum", [0.1, None])
def test_running_stats_follow_bessel(momentum):
    """BranchChain moves each BN's running mean and variance as
    nn.BatchNorm2d does: momentum 0.1 (or the cumulative average), the
    variance Bessel-corrected by n / (n - 1), not P5's biased one."""
    chain, x, bns = _chain_module(8, 2, seed=5)
    for bn in bns:
        bn.momentum = momentum
    old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    chain.train()
    with torch.no_grad():
        y = chain(x)
    ws = [cv.weight for b in chain for cv in (b.conv1, b.conv2)]
    ref = bc.branch_chain_train_plain(x, ws, [bn.weight for bn in bns],
                                      [bn.bias for bn in bns])
    torch.testing.assert_close(y, ref.y, rtol=0, atol=0)
    n = x.numel() // x.shape[1]
    f = 0.1 if momentum else 1.0
    for i, (bn, (m0, v0)) in enumerate(zip(bns, old)):
        assert int(bn.num_batches_tracked) == 1
        torch.testing.assert_close(bn.running_mean,
                                   (1 - f) * m0 + f * ref.mean[i],
                                   rtol=X64_TOL, atol=0)
        bessel = (1 - f) * v0 + f * ref.var[i] * n / (n - 1)
        torch.testing.assert_close(bn.running_var, bessel, rtol=X64_TOL,
                                   atol=0)
        biased = (1 - f) * v0 + f * ref.var[i]
        assert not torch.allclose(bn.running_var, biased, rtol=1e-6)


def test_train_forward_matches_the_unfused_blocks():
    """The fused train-mode chain against the same blocks run one by one
    (nn.BatchNorm2d, convs): output and running statistics, float64."""
    chain, x, bns = _chain_module(16, 3, seed=9)
    unfused, _, ubns = _chain_module(16, 3, seed=9)
    unfused.fused = False
    chain.train()
    unfused.train()
    with torch.no_grad():
        torch.testing.assert_close(chain(x), unfused(x), rtol=X64_TOL,
                                   atol=X64_TOL)
    for a, b in zip(bns, ubns):
        for key in ("running_mean", "running_var", "num_batches_tracked"):
            torch.testing.assert_close(getattr(a, key), getattr(b, key),
                                       rtol=X64_TOL, atol=X64_TOL)
    chain.eval()
    unfused.eval()
    with torch.no_grad():
        torch.testing.assert_close(chain(x), unfused(x), rtol=X64_TOL,
                                   atol=X64_TOL)


# -- gradients -----------------------------------------------------------------

@pytest.mark.parametrize("blocks,x_grad", [(1, True), (2, True), (3, False),
                                           (4, True)])
def test_function_gradients_match_autograd(blocks, x_grad):
    """BranchChainFn (BN backward from ATen, conv input gradients from
    aten.convolution_backward, filter gradients from P4's wrapper)
    against autograd through the plain chain, float64."""
    x, ws, gs, bs, _, _ = _case(3, 8, 5, 6, blocks, seed=blocks)
    x, *params = (t.double().requires_grad_() for t in (x, *ws, *gs, *bs))
    x.requires_grad_(x_grad)
    n = len(params) // 3
    inputs = [x, *params] if x_grad else params
    y, mean, var = bc.BranchChainFn.apply(x, bc.BN_EPS, *params)
    assert not mean.requires_grad and not var.requires_grad
    dy = torch.from_numpy(np.random.RandomState(blocks).randn(*y.shape))
    got = torch.autograd.grad(y, inputs, dy)
    ref_out = bc.branch_chain_train_plain(x, params[:n], params[n:2 * n],
                                          params[2 * n:])
    ref = torch.autograd.grad(ref_out.y, inputs, dy)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=X64_TOL,
                                   atol=X64_TOL * r.abs().max().item())


def test_function_bf16_gradients_keep_their_dtypes():
    """Under autocast the chain gets bf16 copies of x and the weights: their
    gradients come back bf16 (as flax's bf16 conv rounds them), the BN
    parameters' float32."""
    x, ws, gs, bs, _, _ = _case(2, 8, 4, 4, 2, seed=3)
    xb = x.bfloat16().requires_grad_()
    wb = [w.bfloat16().requires_grad_() for w in ws]
    gs = [g.requires_grad_() for g in gs]
    y, _, _ = bc.BranchChainFn.apply(xb, bc.BN_EPS, *wb, *gs, *bs)
    grads = torch.autograd.grad(y.float().sum(), [xb, *wb, *gs])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5 + \
        [torch.float32] * 4
    assert all(torch.isfinite(g.float()).all() for g in grads)


# -- routing and the weight-name contract ----------------------------------

def test_routing_takes_exactly_the_eligible_chains():
    identity = BranchChain(BasicBlock(8, 8), BasicBlock(8, 8))
    projecting = BranchChain(BasicBlock(4, 8, downsample=True),
                             BasicBlock(8, 8))
    bottleneck = BranchChain(Bottleneck(16, 4), Bottleneck(16, 4))
    assert identity.fused
    assert not projecting.fused and not bottleneck.fused

    cfg = load_config(os.path.join(
        REPO, "experiments/fpd_coco/hrnet/w32_fpd_student.yaml"))
    with torch.device("meta"):
        model = get_pose_net(cfg)
    chains = [(n, m) for n, m in model.named_modules()
              if isinstance(m, BranchChain)]
    fused = [n for n, m in chains if m.fused]
    assert [n for n, m in chains if not m.fused] == ["layer1"]
    assert len(fused) == 26 and all(".branches." in n for n in fused)

    x = torch.rand(2, 8, 5, 4)
    calls = []
    with mock.patch("fhpe_tpu_torch.models.pose_hrnet.branch_chain_eval",
                    side_effect=lambda *a: calls.append("eval") or a[0]), \
            mock.patch.object(bc.BranchChainFn, "apply", side_effect=(
                lambda *a: calls.append("train") or (
                    a[0], torch.zeros(4, 8), torch.ones(4, 8)))):
        with torch.no_grad():
            identity.eval()(x)
        identity(x)                  # eval with gradients on: the blocks
        identity.train()(x)
        identity.fused = False
        identity(x)
        projecting.train()(torch.rand(2, 4, 5, 4))
    assert calls == ["eval", "train"]


def test_state_dict_keys_unchanged():
    """A chain keeps nn.Sequential's keys: W32's state_dict has exactly the
    keys of the name mapping fhpe_tpu's importer reads."""
    cfg = load_config(os.path.join(
        REPO, "experiments/fpd_coco/hrnet/w32_fpd_student.yaml"))
    with torch.device("meta"):
        keys = set(get_pose_net(cfg).state_dict())
    want = set()
    for kind, tkey, _ in convert._layers(cfg):
        if kind == "conv":
            want.add(f"{tkey}.weight")
        else:
            want |= {f"{tkey}.{k}" for k in (
                "weight", "bias", "running_mean", "running_var",
                "num_batches_tracked")}
    assert keys == want | {"final_layer.bias"}
    assert "stage3.0.branches.1.2.conv1.weight" in keys


def test_wrappers_check_their_inputs():
    x, ws, gs, bs, means, variances = _case(2, 8, 3, 3, 1, seed=2)
    with pytest.raises(ValueError, match="two convs per block"):
        bc.branch_chain_train(x, ws[:1], gs[:1], bs[:1])
    with pytest.raises(ValueError, match="weights must be"):
        bc.branch_chain_train(x, [w.double() for w in ws], gs, bs)
    with pytest.raises(ValueError, match="BN tensors"):
        bc.branch_chain_eval(x, ws, gs, bs, means[:1] * 2,
                             [v[:4] for v in variances])
    with pytest.raises(ValueError, match="CPU"):
        bc.branch_chain_train(x.half(), [w.half() for w in ws], gs, bs)


# -- the bf16 kernels' tiling (ops/csrc/branch_chain.cu on conv3x3_bf16.cuh) --

CSRC = os.path.join(REPO, "fhpe_tpu_torch", "ops", "csrc")
SMEM_LIMIT = 232448          # an H100's most shared memory a block
# branch_chain.cu's static shared memory beside the plan's dynamic bytes:
# the epilogue's BN parameters, s_bn[4][kTileM] floats
EPILOGUE_SMEM = 4 * cf.BF16_TILE_M * 4
CHAIN_SHAPES = W32_SHAPES + W48_SHAPES + [case[:4] for case in EDGE_CASES]


def _source(name):
    with open(os.path.join(CSRC, name), encoding="utf-8") as f:
        return f.read()


def _slot_pixels(plan, b, h, w):
    """Per tile and slot: the slot's output pixel (sample, y, x) and
    whether it lies in the image, as ``conv3x3_bf16.cuh::slot_offset``
    maps them (a slot past the tile's pixels, in the bottom band, the last
    column tile or past the last sample is out)."""
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


def test_chain_kernels_take_the_shared_mainloop_and_plan():
    """P5's bf16 conv runs the mainloop of conv3x3_bf16.cuh with the host's
    plan (checked, then the grid and dynamic shared memory are the plan's),
    its epilogue's static shared memory is EPILOGUE_SMEM, and the mainloop's
    constants are the host's."""
    src = _source("branch_chain.cu")
    assert '#include "conv3x3_bf16.cuh"' in src
    assert "__shared__ float s_bn[4][cb::kTileM];" in src
    assert "cb::mainloop<" in src
    assert "cb::check_plan(p, b, h, w)" in src
    assert "const dim3 grid(p.tiles, (a.c + cb::kTileM - 1) / cb::kTileM);" \
        in src
    assert "kernel<<<grid, cb::kThreads, p.smem, stream>>>" in src
    header = _source("conv3x3_bf16.cuh")
    for name, value in (("kTileM", cf.BF16_TILE_M), ("kSlots", cf.BF16_SLOTS),
                        ("kChunk", cf.BF16_CHUNK), ("kPitch", cf.BF16_PITCH),
                        ("kMaxPatch", cf.BF16_MAX_PATCH)):
        got = re.search(rf"constexpr int {name} = (\d+);", header).group(1)
        assert int(got) == value, name
    assert "kWeightBytes + p.patch * (kPitch * 2 + 4)" in header


@pytest.mark.parametrize("shape", CHAIN_SHAPES,
                         ids=["x".join(map(str, s)) for s in CHAIN_SHAPES])
def test_chain_plan_fits_and_covers_every_pixel_once(shape):
    """On every W32/W48 chain shape and edge case: the plan's shared memory
    with the epilogue's fits a block, and every output pixel lies in
    exactly one in-image slot."""
    b, c, h, w = shape
    plan = cf.bf16_plan(b, h, w)
    assert plan.smem == cf.plan_smem(plan.patch)
    assert plan.smem + EPILOGUE_SMEM <= SMEM_LIMIT
    bb, yy, xx, ok = _slot_pixels(plan, b, h, w)
    hits = np.zeros(b * h * w, np.int64)
    np.add.at(hits, ((bb * h + yy) * w + xx)[ok], 1)
    assert (hits == 1).all(), (shape, plan)


def _f32_tiles(b, h, w):
    """The float32 core's statistics tiles: 64 consecutive pixels of the
    flattened (B, H, W), as (sample, y, x, in-image) per tile and slot."""
    n = np.arange(-(-b * h * w // 64))[:, None] * 64 + np.arange(64)[None]
    ok = n < b * h * w
    n = np.where(ok, n, 0)
    return n // (h * w), (n % (h * w)) // w, n % w, ok


def _tile_stats(t, tiles):
    """Per tile and channel, as the kernels' epilogues compute them over a
    tile's in-image slots: count, mean and the sum of squared deviations
    from it (two passes), float64.  Returns (count, mean, m2), (tiles, C)."""
    bb, yy, xx, ok = (np.broadcast_to(a, tiles[3].shape) for a in tiles)
    vals = t.permute(0, 2, 3, 1).numpy()[np.where(ok, bb, 0),
                                         np.where(ok, yy, 0),
                                         np.where(ok, xx, 0)]  # (tiles, n, C)
    okf = ok[..., None].astype(np.float64)
    cnt = okf.sum(1)
    mean = (vals * okf).sum(1) / np.maximum(cnt, 1)
    m2 = (((vals - mean[:, None]) * okf) ** 2).sum(1)
    return np.broadcast_to(cnt, mean.shape), mean, m2


def _merge_like_the_kernel(cnt, mean, m2, threads=256):
    """chain_stats_reduce's fixed order: thread k merges tiles k, k + 256,
    ... (Chan's formula), then a tree halves the threads."""
    n_t = np.zeros((threads, cnt.shape[1]))
    mu_t, m2_t = n_t.copy(), n_t.copy()

    def merge(i, nb, mb, m2b):
        take = nb > 0
        tot = np.where(take, n_t[i] + nb, n_t[i])
        delta = mb - mu_t[i]
        frac = np.where(take, nb / np.where(take, tot, 1), 0)
        mu_t[i] = mu_t[i] + delta * frac
        m2_t[i] = m2_t[i] + np.where(
            take, m2b + delta * delta * n_t[i] * frac, 0)
        n_t[i] = tot

    for t in range(cnt.shape[0]):
        merge(t % threads, cnt[t], mean[t], m2[t])
    s = threads // 2
    while s:
        for i in range(s):
            merge(i, n_t[i + s].copy(), mu_t[i + s].copy(), m2_t[i + s].copy())
        s //= 2
    return n_t[0], mu_t[0], m2_t[0] / n_t[0]


@pytest.mark.parametrize("tiling", ["bf16 plan", "float32 64-pixel"])
@pytest.mark.parametrize("shape", [(3, 8, 5, 7), (1, 8, 1, 1), (3, 40, 9, 6),
                                   (2, 16, 3, 130), (5, 8, 13, 11)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_statistics_merge_to_the_batch_statistics(shape, tiling):
    """The train epilogue's per-tile (count, mean, M2) over each tile's
    in-image slots, ragged tiles included, merged in chain_stats_reduce's
    fixed order in float64: every pixel counted once, and the merged mean
    and variance equal batch_stats to 1e-12 relative."""
    b, c, h, w = shape
    t = torch.from_numpy(np.random.RandomState(sum(shape)).randn(
        b, c, h, w) + 0.5)
    if tiling == "bf16 plan":
        tiles = _slot_pixels(cf.bf16_plan(b, h, w), b, h, w)
    else:
        tiles = _f32_tiles(b, h, w)
    cnt, mean, m2 = _tile_stats(t, tiles)
    n, mu, var = _merge_like_the_kernel(cnt, mean, m2)
    assert (n == b * h * w).all()
    ref_mean, ref_var = bc.batch_stats(t)
    scale = t.abs().max().item()
    np.testing.assert_allclose(mu, ref_mean.numpy(), rtol=1e-12,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(var, ref_var.numpy(), rtol=1e-12, atol=0)


def _emulate_pre_conv(u, wt, pre, halo_bn=False):
    """conv3x3 of relu(bn(u)) as the bf16 mainloop stages it with its
    prologue, float64: per tile the patch's pixel table, each staged value
    relu(bn(u)) where the pixel lies in the image and 0 in the halo
    (``halo_bn``: relu(bn(0)) there instead, the rule broken), the nine
    taps as row offsets of the patch, and the epilogue's slot -> pixel
    map."""
    b, c, h, w = u.shape
    plan = cf.bf16_plan(b, h, w)
    mean, inv, gamma, beta = (p[None, :] for p in pre)
    uf = u.permute(0, 2, 3, 1).reshape(-1, c)        # pixel-major
    y = torch.zeros(b * h * w, c, dtype=torch.float64)
    sample_patch = (plan.rows + 2) * plan.patch_w
    tile_px = plan.rows * plan.cols
    q = torch.arange(plan.patch)
    n = torch.arange(cf.BF16_SLOTS)
    s_n, r_n = n // tile_px, n % tile_px
    pos = s_n * sample_patch + (r_n // plan.cols) * plan.patch_w \
        + r_n % plan.cols
    bb_s, yy_s, xx_s, ok_s = _slot_pixels(plan, b, h, w)
    for t in range(plan.tiles):
        cc, rest = t % plan.col_tiles, t // plan.col_tiles
        b0 = (rest // plan.bands) * plan.samples
        y0, x0 = (rest % plan.bands) * plan.rows, cc * plan.cols
        s, r = q // sample_patch, q % sample_patch
        yy, xx = y0 - 1 + r // plan.patch_w, x0 - 1 + r % plan.patch_w
        bb = b0 + s
        inside = (bb < b) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        src = torch.where(inside, (bb * h + yy) * w + xx,
                          torch.zeros_like(q))
        norm = torch.relu((uf[src] - mean) * inv * gamma + beta)
        halo = torch.relu((0 - mean) * inv * gamma + beta) if halo_bn \
            else torch.zeros_like(norm)
        xs = torch.where(inside[:, None], norm, halo)
        acc = torch.zeros(cf.BF16_SLOTS, c, dtype=torch.float64)
        for tap in range(9):
            rows = xs[(pos + (tap // 3) * plan.patch_w + tap % 3)
                      .clamp(max=plan.patch - 1)]
            acc += rows @ wt[:, :, tap // 3, tap % 3].T
        ok = torch.from_numpy(ok_s[t])
        dst = torch.from_numpy((bb_s[t] * h + yy_s[t]) * w + xx_s[t])
        y[dst[ok]] = acc[ok]
    return y.view(b, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(3, 8, 5, 7), (2, 8, 12, 11),
                                   (1, 8, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_prologue_keeps_the_halo_zero(shape):
    """The train-mode conv2's prologue: relu(bn1(u)) on every staged value
    inside the image, 0 in the halo, equals F.conv2d of relu(bn1(u))
    zero-padded; normalizing the halo too (relu(bn1(0)) is not 0) does
    not."""
    b, c, h, w = shape
    rng = np.random.RandomState(sum(shape))
    u = torch.from_numpy(rng.randn(b, c, h, w))
    wt = torch.from_numpy(rng.randn(c, c, 3, 3) / np.sqrt(9 * c))
    mean, var = bc.batch_stats(u)
    pre = (mean - 1.0, torch.rsqrt(var + bc.BN_EPS),
           torch.from_numpy(rng.uniform(0.5, 1.5, c)),
           torch.from_numpy(rng.normal(0.5, 0.1, c)))
    a = F.relu(bc._bn(u, *pre))
    ref = F.conv2d(a, wt, padding=1)
    got = _emulate_pre_conv(u, wt, pre)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12 * scale)
    wrong = _emulate_pre_conv(u, wt, pre, halo_bn=True)
    assert (wrong - ref).abs().max().item() > 1e-3 * scale


def test_statistics_partials_carry_their_counts():
    """Both train convs (the bf16 tensor-core one and the float32 core)
    write (count, mean, M2) per tile and channel as (3, tiles, C), and the
    merge reads each partial's count from it: no tile is assumed to hold
    64 consecutive pixels."""
    src = _source("branch_chain.cu")
    assert src.count("write_part(") == 3     # defined, and both convs
    merge = "merge(n, mean, m2, part[at], part[row + at], part[2 * row + at]);"
    assert merge in src
    assert "min(kBN, n_total - t * kBN)" not in src
    with open(bc.__file__, encoding="utf-8") as f:
        wrapper = f.read()
    assert "part = torch.empty((3, tiles, c)" in wrapper
    assert "TILE_PIXELS" not in wrapper
