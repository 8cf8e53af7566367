"""ViTPose's operations and bytes: the step's FLOPs from ``FlopCounterMode``
over the reference, and the least time of its attention calls and of its
blocks' linears, at the card's peaks (``roofline/__init__.py``).

Attention, per call of one layer on (B, heads, N, head_dim) in bf16: the
operations ``FlopCounterMode`` counts for the reference's written-out
``softmax(q k^T) v`` (its two matrix products; the backward's four), and
the bytes of q, k, v read and o written once (forward), of q, k, v, o and
dO read and dq, dk, dv written once (backward).  A linear of M tokens,
K inputs and N outputs in bf16: 2 M K N operations for its forward, its
input's gradient and its weight's gradient alike, each reading its two
operands once and writing its result once.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import vit_pose as ref_vit
from . import bound_s

BF16 = 2


def _meta_model(model_cfg: dict):
    with torch.device("meta"):
        return ref_vit.build(model_cfg)


def _input(model_cfg: dict, batch: int) -> torch.Tensor:
    w, h = model_cfg["IMAGE_SIZE"]
    return torch.empty((batch, 3, h, w), device="meta")


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
        model(_input(model_cfg, batch)).sum().backward()
    return counter.get_total_flops() / batch


def tokens(model_cfg: dict) -> int:
    e = model_cfg["EXTRA"]
    w, h = model_cfg["IMAGE_SIZE"]
    p, pad = int(e["PATCH_SIZE"]), int(e["PATCH_PADDING"])
    return ((h + 2 * pad - p) // p + 1) * ((w + 2 * pad - p) // p + 1)


def attention_call(model_cfg: dict, batch: int,
                   backward: bool) -> Tuple[float, float]:
    """(bytes, operations) of one layer's attention, forward or
    backward."""
    e = model_cfg["EXTRA"]
    heads, dim = int(e["NUM_HEADS"]), int(e["EMBED_DIM"])
    n = tokens(model_cfg)
    q, k, v = (torch.empty((batch, heads, n, dim // heads), device="meta",
                           requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        out = ref_vit.attention(q, k, v)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    act = batch * n * dim * BF16
    if backward:
        return 8 * act, bwd.get_total_flops()
    return 4 * act, fwd.get_total_flops()


def linears(model_cfg: dict) -> List[Tuple[int, int]]:
    """(inputs, outputs) of every block linear of one forward: qkv, proj,
    fc1, fc2 per block."""
    e = model_cfg["EXTRA"]
    d = int(e["EMBED_DIM"])
    hidden = int(d * float(e["MLP_RATIO"]))
    return [(d, 3 * d), (d, d), (d, hidden), (hidden, d)] * int(e["DEPTH"])


def gemm_call(m: int, k: int, n: int) -> Tuple[float, float]:
    """(bytes, operations) of one (m x k) by (k x n) product in bf16."""
    return BF16 * (m * k + k * n + m * n), 2.0 * m * k * n


def attention_step_s(teacher: dict, student: dict, batch: int) -> float:
    """Least time of one FPD step's attention calls: the teacher's
    forwards, the student's forwards and backwards."""
    t = bound_s(*attention_call(teacher, batch, False))
    s = (bound_s(*attention_call(student, batch, False))
         + bound_s(*attention_call(student, batch, True)))
    return (int(teacher["EXTRA"]["DEPTH"]) * t
            + int(student["EXTRA"]["DEPTH"]) * s)


def gemm_step_s(teacher: dict, student: dict, batch: int) -> float:
    """Least time of one FPD step's block linears: the teacher's forwards;
    the student's forwards, input gradients and weight gradients."""
    total = 0.0
    for cfg, products in ((teacher, 1), (student, 3)):
        m = batch * tokens(cfg)
        for k, n in linears(cfg):
            total += products * bound_s(*gemm_call(m, k, n))
    return total
