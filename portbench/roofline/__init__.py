"""The operations and bytes the work needs, and the card's peaks.

Shares of a roofline and of a peak are counted here, by the benchmark,
from the configuration's shapes, so that whatever implements the work is
held to the same count: a kernel's call reads each input byte once and
writes each output byte once; its operations are two per multiply-add; the
least time is the larger of bytes over the memory rate and operations over
the bf16 tensor rate.  The step's operations come from
``FlopCounterMode`` over the reference networks (convolutions and their
gradients; the elementwise work is not counted).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference import models as ref_models

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

Shape = Tuple[int, int, int, int]


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)


def p4_call(b: int, c: int, h: int, w: int) -> Tuple[float, float]:
    """(bytes, operations) of one 3x3 filter gradient (P4) in bf16: x and
    dy read, dW written in float32."""
    return 2 * 2 * b * c * h * w + 4 * 9 * c * c, 2 * 9 * c * c * b * h * w


def chain_call(b: int, c: int, h: int, w: int, blocks: int,
               train: bool) -> Tuple[float, float]:
    """(bytes, operations) of one branch chain (P5) of ``blocks`` basic
    blocks in bf16: x, the weights and the BatchNorm parameters read; the
    output written, and in training every block's output and every conv's
    output before its BatchNorm (kept for the backward)."""
    act = 2 * b * c * h * w
    written = (3 * blocks if train else 1) * act
    nbytes = act + written + 2 * blocks * (2 * 9 * c * c + 4 * 2 * c)
    return nbytes, 2 * blocks * 18 * c * c * b * h * w


def _meta_model(model_cfg: dict) -> nn.Module:
    with torch.device("meta"):
        return ref_models.build(model_cfg)


def _input(model_cfg: dict, batch: int) -> torch.Tensor:
    w, h = model_cfg["IMAGE_SIZE"]
    return torch.empty((batch, 3, h, w), device="meta")


def conv3x3_shapes(model_cfg: dict, batch: int) -> List[Shape]:
    """(B, C, H, W) of every 3x3 stride-1 C -> C convolution's input in one
    forward: the filter gradients P4 computes in a training step."""
    model = _meta_model(model_cfg)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: shapes.append(tuple(inp[0].shape)))
        for m in model.modules()
        if isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)
        and m.stride == (1, 1) and m.in_channels == m.out_channels]
    model(_input(model_cfg, batch))
    for hook in hooks:
        hook.remove()
    return shapes


def chain_shapes(model_cfg: dict, batch: int) -> List[Tuple[Shape, int]]:
    """((B, C, H, W), blocks) of every HRNet branch whose blocks are basic
    blocks with identity residuals (what P5 runs), in one forward."""
    model = _meta_model(model_cfg)
    out = []
    hooks = []
    for m in model.modules():
        if isinstance(m, ref_models.HRModule):
            for branch in m.branches:
                if all(isinstance(b, ref_models.BasicBlock)
                       and b.downsample is None for b in branch):
                    hooks.append(branch.register_forward_pre_hook(
                        lambda mod, inp: out.append(
                            (tuple(inp[0].shape), len(mod)))))
    model(_input(model_cfg, batch))
    for hook in hooks:
        hook.remove()
    return out


def p4_step_s(model_cfg: dict, batch: int) -> float:
    """Least time of one training step's P4 calls (the student's)."""
    return sum(bound_s(*p4_call(*s)) for s in conv3x3_shapes(model_cfg, batch))


def chain_forward_s(model_cfg: dict, batch: int, train: bool) -> float:
    """Least time of one forward's P5 calls."""
    return sum(bound_s(*chain_call(*s, blocks, train))
               for s, blocks in chain_shapes(model_cfg, batch))


def forward_flop(model_cfg: dict, batch: int = 2) -> float:
    """Operations of one forward, per image."""
    model = _meta_model(model_cfg).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(_input(model_cfg, batch))
    return counter.get_total_flops() / batch


def train_flop(model_cfg: dict, batch: int = 2) -> float:
    """Operations of one training forward and backward, per image (the
    input takes no gradient)."""
    model = _meta_model(model_cfg).train()
    with FlopCounterMode(display=False) as counter:
        out = model(_input(model_cfg, batch))
        outs = out if model.multi_output else [out]
        sum(o.sum() for o in outs).backward()
    return counter.get_total_flops() / batch
