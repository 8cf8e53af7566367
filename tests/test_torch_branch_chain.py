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
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.models.common import BasicBlock, Bottleneck
from fhpe_tpu_torch.models.pose_hrnet import BranchChain
from fhpe_tpu_torch.ops import branch_chain as bc
from fhpe_tpu_torch.ops.branch_chain_cases import chain_input, chain_params
from fhpe_tpu_torch.utils import convert

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
