"""Shared building blocks for the pose backbones (NCHW, PyTorch).

Counterpart of ``fhpe_tpu/models/common.py``.  ``nn.BatchNorm2d`` already
has the semantics ``fhpe_tpu``'s ``_TorchBatchNorm`` rebuilds by hand
(biased variance to normalize, Bessel-corrected running variance,
momentum 0.1, eps 1e-5), and ``nn.Conv2d``'s default initialization is
the one ``fhpe_tpu``'s ``torch_conv_kernel_init`` reproduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """2D conv with torch-style symmetric padding ``(kernel - 1) // 2``."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=(kernel - 1) // 2, bias=bias)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (reference ``F.max_pool2d(x, 2, 2)``)."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsample (reference ``F.interpolate(scale_factor)``).

    Runs in ``x``'s dtype: CUDA autocast lists the upsample ops as
    float32, which would turn the hourglass's ``up1 + up2`` and what
    follows into float32 where ``fhpe_tpu`` stays in bf16.  Copying values
    is exact in any dtype.
    """
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=factor, mode="nearest")


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
