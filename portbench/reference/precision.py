"""Numeric settings of the reference: float32 with TF32 off, and the fp8
rounding of the precision control."""

from __future__ import annotations

import contextlib

import torch

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to the fp8 ``dtype`` with one scale per tensor (its
    largest magnitude maps to the format's largest, as fp8 training
    scales), back in ``t``'s dtype."""
    scale = FP8[dtype] / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


def fake_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 (forward operands); the gradient passes
    through the rounding unchanged."""
    return t + (_round(t.detach(), torch.float8_e4m3fn) - t).detach()


class _GradQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


def grad_quant(t: torch.Tensor) -> torch.Tensor:
    """The identity, whose backward rounds the incoming gradient to e5m2
    (the gradients' fp8 format)."""
    return _GradQuant.apply(t)


@contextlib.contextmanager
def strict_float32():
    """Float32 matmuls and convolutions without TF32, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
