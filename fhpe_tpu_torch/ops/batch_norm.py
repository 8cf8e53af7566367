"""Train-mode BatchNorm over NCHW, with the ReLU that follows it.

No TPU kernel stands behind this one: ``fhpe_tpu`` leaves BatchNorm to
XLA, which fuses its reductions into the neighbouring ops.  On the card
ATen's native kernels took one CTA per channel for the statistics and for
the whole backward, which left most SMs idle at the students' 32 to 256
channels.  Forms:

* the plain PyTorch versions: :func:`batch_norm_train_plain` (ATen's
  ``native_batch_norm``, what ``F.batch_norm`` runs, then ``F.relu``),
  :func:`batch_norm_apply_plain` and :func:`batch_norm_backward_plain`
  (the backward's formula, with the ReLU's mask recomputed from x);
* the CUDA kernels ``ops/csrc/batch_norm.cu``, one launch per direction:
  each channel's N*H*W values split over a thread block cluster as
  :func:`plan` sets it, held in registers across the cluster's reduction
  and merged in a fixed order (two runs give the same bits); the forward
  moves the running statistics as ``nn.BatchNorm2d`` does.

:func:`batch_norm_train`, :func:`batch_norm_apply` and
:func:`batch_norm_backward` send CUDA tensors to the kernels (they never
fall back) and CPU tensors to the plain versions.  :class:`BatchNormFn`
is the train-mode BatchNorm (+ ReLU) with its gradient
(``models/common.py::BatchNorm2d`` takes it in training on the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

# Train-mode forwards that reached the kernels in this process (one per
# call; a captured step takes back its capture's calls and adds them again
# at each replay, utils/graph.py); a run reads it to show the main path
# went through the kernels.  The backward and the apply pass alone are not
# counted.
batch_norm_launches = 0

_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# The plan (batch_norm.cu's kMaxThreads, kMaxCluster, kHeld): an H100's 132
# SMs; a CTA of at most 256 threads; a cluster of at most 16 CTAs a
# channel, each thread keeping HELD units in registers.  A channel takes
# enough CTAs to hold its units, and at least two per SM in all where 16
# allow it.
SMS = 132
MAX_THREADS = 256
MAX_CLUSTER = 16
HELD = 4
VEC_BYTES = 16


class Plan(NamedTuple):
    """How the kernels cut a call: a channel's N*H*W values into ``units``
    of ``vec`` values (16 bytes, else one value), over a cluster of
    ``cluster`` CTAs of ``threads`` threads."""
    vec: int
    units: int
    cluster: int
    threads: int


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int, hw: int, itemsize: int, aligned: bool = True
         ) -> Plan:
    """The kernels' cut of an (n, c, h*w) call whose tensors all start at
    16-byte boundaries when ``aligned``: 16-byte units where h*w holds a
    whole number of them, else single values; a cluster of as many CTAs
    as hold the channel's units in registers (``HELD`` a thread) and at
    least ``2 * SMS`` CTAs in all, at most ``MAX_CLUSTER`` and no more
    than the channel has units; as many threads as that leaves units, in
    whole warps, up to ``MAX_THREADS``.  A channel past 16 CTAs' registers
    (more than 131,072 bf16 values) is read a second time for the
    output."""
    wide = VEC_BYTES // itemsize
    vec = wide if aligned and hw % wide == 0 else 1
    units = n * hw // vec
    cluster = min(MAX_CLUSTER, units, max(-(-2 * SMS // c),
                                          -(-units // (MAX_THREADS * HELD))))
    threads = min(MAX_THREADS, -(-units // (cluster * HELD * 32)) * 32)
    return Plan(vec, units, cluster, threads)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _ch(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


def _check(x: torch.Tensor, *params: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"BatchNorm takes (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    for t in params:
        if t is not None and (tuple(t.shape) != (c,)
                              or t.device != x.device):
            raise ValueError(f"BatchNorm's per-channel tensors must be "
                             f"({c},) on {x.device}, got {tuple(t.shape)} "
                             f"on {t.device}")
    if x.numel() // max(c, 1) < 2:
        raise ValueError(f"Expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")


def _affine(xc, invstd, weight, bias):
    """The value before the ReLU from ``xc`` = x - mean."""
    scale = invstd if weight is None else weight * invstd
    out = xc * _ch(scale)
    return out if bias is None else out + _ch(bias)


def batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                           momentum: float, eps: float, relu: bool):
    """The plain train-mode forward -> (y, mean, invstd): ATen's
    ``native_batch_norm`` (what ``F.batch_norm`` runs; the running
    statistics move in place), then ``F.relu`` under ``relu``."""
    y, mean, invstd = torch.ops.aten.native_batch_norm(
        x, weight, bias, running_mean, running_var, True, momentum, eps)
    return (F.relu(y) if relu else y), mean, invstd


def batch_norm_apply_plain(x, mean, invstd, weight, bias,
                           relu: bool) -> torch.Tensor:
    """BatchNorm from given mean and invstd (+ ReLU), in x's dtype."""
    y = _affine(x.to(_acc(x.dtype)) - _ch(mean), invstd, weight, bias)
    return (F.relu(y) if relu else y).to(x.dtype)


def batch_norm_backward_plain(dy, x, mean, invstd, weight, bias,
                              relu: bool):
    """The train-mode backward -> (dx in x's dtype, dgamma, dbeta), in
    float32 (float64 for float64 inputs); under ``relu`` dy is zeroed where
    the forward's value, recomputed from x, was <= 0."""
    acc = _acc(x.dtype)
    xc = x.to(acc) - _ch(mean)
    g = dy.to(acc)
    if relu:
        g = g.masked_fill(_affine(xc, invstd, weight, bias) <= 0, 0)
    m = x.numel() // x.shape[1]
    sg = g.sum((0, 2, 3))
    sgx = (g * xc).sum((0, 2, 3))
    scale = invstd if weight is None else weight * invstd
    dx = (g - _ch(sg / m) - xc * _ch(invstd * invstd * sgx / m)) * _ch(scale)
    return dx.to(x.dtype), sgx * invstd, sg


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_plan(x, *tensors) -> Plan:
    if x.dtype not in _CUDA_DTYPES:
        raise ValueError(f"batch norm kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"batch norm kernel: shape {tuple(x.shape)} "
                         f"exceeds 32-bit indexing")
    if x.shape[1] > 65535:
        raise ValueError(f"batch norm kernel takes at most 65535 channels, "
                         f"got {x.shape[1]}")
    n, c, h, w = x.shape
    # The plan depends on the addresses: a captured step bakes it into its
    # graph, whose memory pool gives the tensors the same addresses on
    # every replay.
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, *tensors))
    return plan(n, c, h * w, x.element_size(), aligned)


def _plan_ints(p: Plan):
    return (ctypes.c_int * 3)(p.vec, p.cluster, p.threads)


def _check_float32(*tensors):
    for t in tensors:
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"batch norm kernel takes contiguous float32 "
                             f"per-channel tensors, got {t.dtype}")


def _train_kernel(x, weight, bias, running_mean, running_var, momentum,
                  eps, relu):
    global batch_norm_launches
    _check_float32(weight, bias, running_mean, running_var)
    if (running_mean is None) != (running_var is None):
        raise ValueError("batch norm kernel: running mean and variance "
                         "come together")
    x = x.contiguous()
    y = torch.empty_like(x)
    p = _kernel_plan(x, y)
    n, c, h, w = x.shape
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_batch_norm_train(
            x.data_ptr(), y.data_ptr(), _ptr(weight), _ptr(bias),
            mean.data_ptr(), invstd.data_ptr(), _ptr(running_mean),
            _ptr(running_var), n, c, h * w,
            int(x.dtype == torch.bfloat16), _plan_ints(p), momentum, eps,
            int(relu), stream)
    _build.check(lib, code, "batch norm kernel launch")
    batch_norm_launches += 1
    return y, mean, invstd


def _apply_kernel(x, mean, invstd, weight, bias, relu):
    _check_float32(mean, invstd, weight, bias)
    x = x.contiguous()
    y = torch.empty_like(x)
    p = _kernel_plan(x, y)
    n, c, h, w = x.shape
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_batch_norm_apply(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            _ptr(weight), _ptr(bias), n, c, h * w,
            int(x.dtype == torch.bfloat16), _plan_ints(p), int(relu), stream)
    _build.check(lib, code, "batch norm apply kernel launch")
    return y


def _backward_kernel(dy, x, mean, invstd, weight, bias, relu):
    _check_float32(mean, invstd, weight, bias)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    p = _kernel_plan(x, dy, dx)
    n, c, h, w = x.shape
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_batch_norm_backward(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            _ptr(weight), _ptr(bias), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), n, c, h * w,
            int(x.dtype == torch.bfloat16), _plan_ints(p), int(relu), stream)
    _build.check(lib, code, "batch norm backward kernel launch")
    return dx, dgamma, dbeta


def _route(x, kernel, plain, *args):
    """``kernel(*args)`` for CUDA ``x``, ``plain(*args)`` for CPU ``x``."""
    if x.device.type == "cuda":
        return kernel(*args)
    if x.device.type == "cpu":
        if x.dtype not in _CPU_DTYPES:
            raise ValueError(f"batch norm takes {_CPU_DTYPES} on the CPU, "
                             f"got {x.dtype}")
        return plain(*args)
    raise ValueError(f"batch norm: unsupported device {x.device}")


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float = 0.1, eps: float = 1e-5,
                     relu: bool = False):
    """Train-mode BatchNorm (+ ReLU) of (N, C, H, W) x -> (y in x's dtype,
    batch mean, invstd), the running statistics (or None) moved in place
    by ``momentum``.  CUDA tensors go to the kernels (x float32 or
    bfloat16, per-channel tensors float32, else raises); CPU tensors
    (float32, bfloat16 or float64) to the plain version."""
    _check(x, weight, bias, running_mean, running_var)
    return _route(x, _train_kernel, batch_norm_train_plain, x, weight, bias,
                  running_mean, running_var, float(momentum), float(eps),
                  bool(relu))


def batch_norm_apply(x, mean, invstd, weight, bias,
                     relu: bool = False) -> torch.Tensor:
    """BatchNorm (+ ReLU) of x from given mean and invstd, the forward's
    apply pass alone.  Routed as :func:`batch_norm_train`."""
    _check(x, mean, invstd, weight, bias)
    return _route(x, _apply_kernel, batch_norm_apply_plain, x, mean, invstd,
                  weight, bias, bool(relu))


def batch_norm_backward(dy, x, mean, invstd, weight, bias,
                        relu: bool = False):
    """The train-mode backward -> (dx in x's dtype, dgamma, dbeta) from
    the forward's mean and invstd.  Routed as :func:`batch_norm_train`."""
    _check(x, mean, invstd, weight, bias)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} "
                         f"differ")
    return _route(x, _backward_kernel, batch_norm_backward_plain, dy, x,
                  mean, invstd, weight, bias, bool(relu))


class BatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm (+ ReLU) with its gradient:
    ``apply(x, weight, bias, running_mean, running_var, momentum, eps,
    relu)`` -> y.  Saves x, mean and invstd (not y); the backward
    recomputes the ReLU's mask from x."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, relu):
        y, mean, invstd = batch_norm_train(x, weight, bias, running_mean,
                                           running_var, momentum, eps, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        dx, dgamma, dbeta = batch_norm_backward(dy, x, mean, invstd, weight,
                                                bias, ctx.relu)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, None, None, None, None, None)
