"""A chain of HRNet BasicBlocks with identity residuals, NCHW.

Counterpart of the Pallas kernels of ``scripts/probe/fused_block/`` (P5):
``chain_pallas_eval`` (running statistics folded) and
``chain_pallas_train`` (exact whole-batch BatchNorm statistics), whose
semantics ``fused_block.py::chain_reference`` spells out.  Per block, with
x its input, ``round`` rounding to the compute dtype and BatchNorm
computed in float32 (float64 for float64 inputs):

    u = round(conv3x3(x, W1));  a = relu(round(bn1(u)))
    v = round(conv3x3(a, W2));  y = relu(round(bn2(v)) + x)

where ``bn(t) = (t - mean) * rsqrt(var + eps) * gamma + beta``.  Where P5
and the model differ, this follows the model
(``fhpe_tpu/models/pose_hrnet.py::BasicBlock`` on
``fhpe_tpu/models/common.py::BatchNorm``): the conv output is rounded
before it is normalized (P5 folds BN into the float32 accumulator), and
the batch variance is one-pass for bfloat16 and two-pass otherwise (P5 is
always one-pass).  The running-statistics update (Bessel-corrected, as
``nn.BatchNorm2d``) is the caller's: ``models/pose_hrnet.py::BranchChain``.

Tensors: x (B, C, H, W); per conv i = 0 .. 2 nb - 1 (conv1 then conv2 of
block i // 2) a weight (C, C, 3, 3) in x's dtype and (C,) BatchNorm
gamma, beta (and for eval running mean, variance), float32 (float64 for
float64 inputs).  Two forms each:

* the plain PyTorch versions, :func:`branch_chain_eval_plain` and
  :func:`branch_chain_train_plain`;
* the CUDA kernels ``ops/csrc/branch_chain.cu`` (an implicit-GEMM conv
  per launch with BN, ReLU and the residual in its epilogue; train mode
  adds per-tile statistics merged in a fixed order and a BN + ReLU
  prologue on conv2's input): bfloat16 on the tensor cores through the
  mainloop shared with conv3x3_fwd's kernel, tiled by
  ``conv3x3_fwd.bf16_plan``; float32 on the CUDA cores.

:func:`branch_chain_eval` and :func:`branch_chain_train` send CUDA tensors
to the kernels (they never fall back) and CPU tensors to the plain
versions.  :class:`BranchChainFn` is the train-mode chain with its
gradient: BatchNorm's backward from ATen, the input gradients from
``aten.convolution_backward`` and the filter gradients from the P4 kernel
(``ops/conv_wgrad.py``); the JAX package has no backward kernel for P5.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, conv_wgrad
from .conv3x3_fwd import Bf16Plan, bf16_plan

BN_EPS = 1e-5

# Chain calls that reached each kernel in this process (one per call, not
# per CUDA launch); a run reads them to show the main path went through the
# kernels.
branch_chain_eval_launches = 0
branch_chain_train_launches = 0

_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


class ChainTrain(NamedTuple):
    """A train-mode chain's results: ``y``; per conv the batch ``mean``,
    biased ``var`` and ``inv`` = rsqrt(var + eps), (2 nb, C) float32 (float64
    for float64 inputs); for the backward each block's ``inputs`` (x, then
    the outputs of blocks 0 .. nb - 2) and each conv's output before
    BatchNorm, ``pre`` (u0, v0, u1, v1, ...), in x's dtype."""
    y: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    inv: torch.Tensor
    inputs: Tuple[torch.Tensor, ...]
    pre: Tuple[torch.Tensor, ...]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _check(x, weights, gammas, betas, *stats) -> int:
    """Validate shapes, dtypes and devices; return the number of blocks."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    n = len(weights)
    if n == 0 or n % 2:
        raise ValueError(f"a chain takes two convs per block, got {n}")
    for group in (gammas, betas, *stats):
        if len(group) != n:
            raise ValueError(f"{n} weights but {len(group)} BN tensors")
    for w in weights:
        if tuple(w.shape) != (c, c, 3, 3):
            raise ValueError(f"weights must be ({c}, {c}, 3, 3), got "
                             f"{tuple(w.shape)}")
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"weights must be {x.dtype} on {x.device}, got "
                             f"{w.dtype} on {w.device}")
    acc = _acc(x.dtype)
    for group in (gammas, betas, *stats):
        for t in group:
            if tuple(t.shape) != (c,) or t.dtype != acc or \
                    t.device != x.device:
                raise ValueError(f"BN tensors must be ({c},) {acc} on "
                                 f"{x.device}, got {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
    return n // 2


def _conv(x, w):
    return F.conv2d(x, w, None, 1, 1)


def _bn(t, mean, inv, gamma, beta):
    """BatchNorm of ``t`` in float32 (float64), back in ``t``'s dtype."""
    def ch(p):
        return p[:, None, None]
    tf = t.to(_acc(t.dtype))
    return ((tf - ch(mean)) * ch(inv) * ch(gamma) + ch(beta)).to(t.dtype)


def batch_stats(t: torch.Tensor):
    """Biased batch mean and variance per channel, as fhpe_tpu's
    ``_batch_var``: one pass (clamped at 0) for 16-bit inputs, two passes
    otherwise."""
    tf = t.to(_acc(t.dtype))
    mean = tf.mean((0, 2, 3))
    if t.dtype.itemsize < 4:
        var = (tf.square().mean((0, 2, 3)) - mean.square()).clamp(min=0)
    else:
        var = (tf - mean[:, None, None]).square().mean((0, 2, 3))
    return mean, var


def branch_chain_eval_plain(x, weights, gammas, betas, means, variances,
                            eps: float = BN_EPS) -> torch.Tensor:
    """The plain version of the eval kernel, on any device."""
    nb = _check(x, weights, gammas, betas, means, variances)
    with torch.autocast(x.device.type, enabled=False):
        for k in range(nb):
            res, i = x, 2 * k
            u = _conv(x, weights[i])
            a = F.relu(_bn(u, means[i], torch.rsqrt(variances[i] + eps),
                           gammas[i], betas[i]))
            v = _conv(a, weights[i + 1])
            x = F.relu(_bn(v, means[i + 1],
                           torch.rsqrt(variances[i + 1] + eps),
                           gammas[i + 1], betas[i + 1]) + res)
    return x


def branch_chain_train_plain(x, weights, gammas, betas,
                             eps: float = BN_EPS) -> ChainTrain:
    """The plain version of the train kernel, on any device; differentiable
    by autograd (the reference for :class:`BranchChainFn`'s gradient)."""
    nb = _check(x, weights, gammas, betas)
    stats, inputs, pre = [], [], []
    with torch.autocast(x.device.type, enabled=False):
        for k in range(nb):
            inputs.append(x)
            res, t = x, x
            for half in range(2):
                i = 2 * k + half
                t = _conv(t, weights[i])
                pre.append(t)
                mean, var = batch_stats(t)
                inv = torch.rsqrt(var + eps)
                stats.append((mean, var, inv))
                t = _bn(t, mean, inv, gammas[i], betas[i])
                t = F.relu(t if half == 0 else t + res)
            x = t
    mean, var, inv = (torch.stack(s) for s in zip(*stats))
    return ChainTrain(x, mean, var, inv, tuple(inputs), tuple(pre))


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _plan(x):
    """The bf16 kernels' conv tiling (``conv3x3_fwd.bf16_plan``, cached) as
    the ints the C entry points take; None for float32."""
    if x.dtype != torch.bfloat16:
        return None
    b, _, h, w = x.shape
    return (ctypes.c_int * len(Bf16Plan._fields))(*bf16_plan(b, h, w))


def _kernel_check(x, tensors) -> None:
    if x.dtype not in _CUDA_DTYPES:
        raise ValueError(f"branch chain kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, *tensors)):
        raise ValueError("branch chain kernel takes contiguous tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"branch chain kernel: shape {tuple(x.shape)} "
                         f"exceeds 32-bit indexing")


def _eval_kernel(x, weights, gammas, betas, means, variances, eps):
    global branch_chain_eval_launches
    _check(x, weights, gammas, betas, means, variances)
    _kernel_check(x, [*weights, *gammas, *betas, *means, *variances])
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    tmp = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_branch_chain_eval(
            x.data_ptr(), y.data_ptr(), tmp.data_ptr(), len(weights) // 2,
            b, c, h, w, int(x.dtype == torch.bfloat16), _plan(x),
            _pointers(weights), _pointers(gammas), _pointers(betas),
            _pointers(means), _pointers(variances), eps, stream)
    _build.check(lib, code, "branch chain eval kernel launch")
    branch_chain_eval_launches += 1
    return y


def _train_kernel(x, weights, gammas, betas, eps) -> ChainTrain:
    global branch_chain_train_launches
    nb = _check(x, weights, gammas, betas)
    _kernel_check(x, [*weights, *gammas, *betas])
    b, c, h, w = x.shape
    outs = torch.empty((nb, *x.shape), dtype=x.dtype, device=x.device)
    pre = torch.empty((2 * nb, *x.shape), dtype=x.dtype, device=x.device)
    stats = torch.empty((3, 2 * nb, c), dtype=torch.float32, device=x.device)
    is_bf16, plan = int(x.dtype == torch.bfloat16), _plan(x)
    lib = _build.load_library()
    # per-tile (count, mean, M2) of each conv output, merged per channel
    tiles = lib.fhpe_branch_chain_part_tiles(b, h, w, is_bf16, plan)
    if tiles <= 0:
        raise RuntimeError(f"branch chain train kernel refused the plan "
                           f"{bf16_plan(b, h, w)} for {tuple(x.shape)}")
    part = torch.empty((3, tiles, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_branch_chain_train(
            x.data_ptr(), outs.data_ptr(), pre.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), stats[2].data_ptr(), part.data_ptr(), nb, b,
            c, h, w, is_bf16, plan, _pointers(weights), _pointers(gammas),
            _pointers(betas), eps, stream)
    _build.check(lib, code, "branch chain train kernel launch")
    branch_chain_train_launches += 1
    return ChainTrain(outs[-1], stats[0], stats[1], stats[2],
                      (x, *outs[:-1].unbind(0)), tuple(pre.unbind(0)))


def _route(x, kernel, plain, *args):
    if x.device.type == "cuda":
        return kernel(x, *args)
    if x.device.type == "cpu":
        if x.dtype not in _CPU_DTYPES:
            raise ValueError(f"branch chain takes {_CPU_DTYPES} on the CPU, "
                             f"got {x.dtype}")
        return plain(x, *args)
    raise ValueError(f"branch chain: unsupported device {x.device}")


def branch_chain_eval(x, weights, gammas, betas, means, variances,
                      eps: float = BN_EPS) -> torch.Tensor:
    """The eval-mode chain (BatchNorm on running statistics) -> y.

    CUDA tensors go to the kernel (float32 or bfloat16, contiguous, BN
    tensors float32, else raises); CPU tensors (float32, bfloat16 or
    float64) to the plain version.
    """
    return _route(x, _eval_kernel, branch_chain_eval_plain, weights, gammas,
                  betas, means, variances, eps)


def branch_chain_train(x, weights, gammas, betas,
                       eps: float = BN_EPS) -> ChainTrain:
    """The train-mode chain (BatchNorm on the batch statistics), forward
    only -> :class:`ChainTrain`.  Routed as :func:`branch_chain_eval`."""
    return _route(x, _train_kernel, branch_chain_train_plain, weights,
                  gammas, betas, eps)


class BranchChainFn(torch.autograd.Function):
    """The train-mode chain with its gradient.

    ``apply(x, eps, *weights, *gammas, *betas)`` (2 nb of each) ->
    ``(y, mean, var)``, mean and var (2 nb, C) not differentiable.  The
    forward is :func:`branch_chain_train`.  The backward walks the blocks
    in reverse: ReLU masks from the saved outputs, BatchNorm's backward
    (``aten.native_batch_norm_backward``) from the saved pre-BN outputs and
    batch statistics, the input gradients through
    ``aten.convolution_backward``, the filter gradients through P4
    (``conv_wgrad.conv3x3_wgrad``), ``a = relu(bn1(u))`` recomputed for
    conv2's.  Each gradient comes back in its input's dtype (a bf16 weight
    copy gets a bf16 gradient, as under autocast).
    """

    @staticmethod
    def forward(ctx, x, eps, *params):
        n = len(params) // 3
        weights, gammas, betas = params[:n], params[n:2 * n], params[2 * n:]
        out = branch_chain_train(x, weights, gammas, betas, eps)
        ctx.eps, ctx.n = eps, n
        ctx.save_for_backward(out.y, out.mean, out.var, out.inv,
                              *out.inputs, *out.pre, *params)
        ctx.mark_non_differentiable(out.mean, out.var)
        return out.y, out.mean, out.var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        n, nb, eps = ctx.n, ctx.n // 2, ctx.eps
        saved = ctx.saved_tensors
        y, mean, var, inv = saved[:4]
        inputs = saved[4:4 + nb]
        pre = saved[4 + nb:4 + nb + n]
        params = saved[4 + nb + n:]
        weights, gammas, betas = params[:n], params[n:2 * n], params[2 * n:]
        outputs = (*inputs[1:], y)
        need_w = ctx.needs_input_grad[2:2 + n]
        need_g = ctx.needs_input_grad[2 + n:2 + 2 * n]
        need_b = ctx.needs_input_grad[2 + 2 * n:]
        dws, dgs, dbs = [None] * n, [None] * n, [None] * n
        aten = torch.ops.aten

        def conv_dx(grad, inp, weight):
            return aten.convolution_backward(
                grad, inp, weight, None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [True, False, False])[0]

        def bn_back(grad, t, i):
            return aten.native_batch_norm_backward(
                grad, t, gammas[i], None, None, mean[i], inv[i], True, eps,
                [True, need_g[i], need_b[i]])

        dy = dy.contiguous()
        with torch.autocast(dy.device.type, enabled=False):
            for k in reversed(range(nb)):
                i1, i2 = 2 * k, 2 * k + 1
                x, u, v = inputs[k], pre[i1], pre[i2]
                dz = aten.threshold_backward(dy, outputs[k], 0)
                dv, dgs[i2], dbs[i2] = bn_back(dz, v, i2)
                a = F.relu(F.batch_norm(u, mean[i1], var[i1], gammas[i1],
                                        betas[i1], False, 0.0, eps))
                da = conv_dx(dv, a, weights[i2])
                if need_w[i2]:
                    dws[i2] = conv_wgrad.conv3x3_wgrad(a, dv).to(
                        weights[i2].dtype)
                du, dgs[i1], dbs[i1] = bn_back(
                    aten.threshold_backward(da, a, 0), u, i1)
                if need_w[i1]:
                    dws[i1] = conv_wgrad.conv3x3_wgrad(x, du).to(
                        weights[i1].dtype)
                dy = dz + conv_dx(du, x, weights[i1])
        return (dy, None, *dws, *dgs, *dbs)
