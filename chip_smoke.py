#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fhpe_tpu_torch``) on one GPU.

Drives the port's four paths end to end, through the entry points a
user calls, with random weights from a seed:

* serving the FPD hourglass (MPII 256x256, 16 joints): the student
  (4 stacks x 128 features) and the teacher (8 x 256) at full width,
  ``Predictor.warmup`` / ``Predictor.predict_crops``;
* the COCO path of the FPD student HRNet-W32 (256x192, 17 joints, bf16,
  batch 32, flip test on): ``Predictor.predict_crops`` ->
  ``cli.common.make_evaluate_fn`` (rescore, OKS-NMS on the card through
  the pairwise-OKS and greedy kernels, results JSON, COCO AP);
* FPD training of the hourglass student by the teacher (bf16, batch 32,
  Adam): ``train.create_train_state`` -> ``make_batch_preprocessor`` ->
  ``make_fpd_train_step`` (the 3x3 filter gradients through the P4
  kernel, the PCK argmaxes through the decode kernel), then validation:
  ``make_eval_step`` -> ``make_evaluate_fn`` (MPII PCKh);
* FPD training of HRNet-W32 (``w32_fpd_student.yaml``) by W48
  (``w48_256x192_teacher.yaml``, eval mode) on COCO-shaped batches (bf16,
  batch 32, Adam lr 1e-3), the same entry points: every branch chain
  through P5 (the teacher's and the eval step's in eval mode, the
  student's in train mode, its backward through P4), then validation:
  ``make_eval_step`` -> ``make_evaluate_fn`` (COCO AP);
* PoseResNet-50 on COCO 256x192 (``res50_256x192_d256x3_adam_lr1e-3.yaml``,
  He-scale weights from a seed): serving through ``Predictor``, the plain
  train step (``create_train_state`` -> ``make_batch_preprocessor`` ->
  ``make_train_step``, bf16, batch 32, Adam lr 1e-3), then validation
  (``make_eval_step`` -> ``make_evaluate_fn``, COCO AP); its 13 stride-1
  3x3 convs run their forwards on the conv3x3_fwd kernel (the port of the
  conv probes P1-P3) and their filter gradients on P4.

Phases; any failure raises and exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``fhpe_tpu_torch/ops/csrc/*.cu`` with nvcc, one
   process per source, all started together;
3. decode kernel against its plain PyTorch version on planted edge cases
   (bit-equal), then the device time of both from a profiler trace;
4. NMS kernels against their plain versions on planted cases (equal
   scores, all padding but one, nothing valid, duplicate clusters) at
   N = 128, 256, 1152: the OKS matrix within rtol 1e-5 / atol 1e-6, the
   greedy keep mask bit-equal; then the device time of each and of its
   plain version at the COCO path's N = 128;
5. student serve in bf16: requests of 1, 32 and 45 crops, shape/finite
   checks, decode launches == chunks, kernel vs plain on one chunk's
   heatmaps, the bf16 dtype flow of every conv/BN/block, warm images/s;
6. float32 parity (TF32 off): the student on the card against the same
   port on the CPU;
7. teacher serve: one request of 32 crops with the checks of phase 5;
8. W32 serve (He-scale weights, BN statistics from one batch) with the
   checks of phase 5, and P5's device ms per chunk (profiler);
9. W32 float32 parity, as phase 6;
10. COCO evaluation on synthetic ground truth (64 images of 1-4 people):
    (a) planted detections: per image the keep-list equals the host
    float64 ``oks_nms``'s, AP equals the host-NMS run's and is > 0.5, and
    the OKS and greedy kernels ran once per image; the NMS time per
    image; (b) the W32 Predictor's own outputs on crops at the ground
    truth boxes: decode launches == chunks, NMS launches == images, the
    10 stats finite;
11. P4 (3x3 filter gradient) kernel against its plain version on every
    shape of the three train steps' P4 sets at batch 32, edge and wide
    cases, bf16 and float32, planted inputs: within the bars of
    ``tools/profile_wgrad.py``, two runs bit-equal; tensor-core
    instructions in the bf16 entries' SASS; then the device time of the
    kernel, its plain version and cuDNN's weight gradient
    (``aten.convolution_backward``, timed, never used);
12. the FPD train step at full width (bf16, batch 32, DEAD_BIAS_SKIP as
    bench.py trains): P4 launches == 59 and decode launches == 2 per
    step, finite losses, the loss falling over 20 steps on one batch,
    warm train images/s, and a profile (idle share, device ops per step,
    kernel ms by group), and P4 on each of the three train steps' P4
    shape sets against cuDNN wgrad on the same shapes;
13. float32 train-step parity (TF32 off): one FPD step at full width,
    batch 2, on the card against the same port on the CPU (bars that
    allow a float32 step's chaos), and on the card with P4 against the
    card with cuDNN's filter gradient in its place (tight bars);
14. validation of the trained student: ``make_eval_step`` (flip test,
    a padded last batch; 3 decode launches per batch, no P4) on crops of
    a synthetic MPII set, then PCKh through ``make_evaluate_fn``:
    predictions planted at the ground truth give Mean 100, the step's
    own give finite stats;
15. P5 (the HRNet BasicBlock chain, eval and train entries) against its
    plain versions on every W32 and W48 chain shape at batch 32 and on
    edge cases (B = 1 and 3, C = 8 and 40, 1x1 and 3x130 images), bf16
    and float32, TF32 off: y and the batch statistics within the bars of
    ``tools/profile_chain.py``, two runs bit-equal; HMMA in the bf16
    entries' SASS; then the device time of each entry on the eight shapes
    in turns with the same chain as unfused modules (cuDNN), and its plain
    version;
16. ``BranchChainFn``'s gradients against autograd through the plain
    chain, float32, at one W32 chain shape;
17. the FPD W48 -> W32 train step at full width (bf16, batch 32): per
    step 26 P5e, 26 P5t, 212 P4 and 2 decode launches, finite losses
    falling over 10 steps on one batch, warm train images/s with P5 and
    with every chain unrouted, a profile of each (idle share, device ops
    per step, kernel ms by group, P5's device ms per step) and one step's
    52 chain forwards on P5 against the unfused modules;
18. float32 FPD W48 -> W32 step parity (TF32 off, batch 2): card against
    CPU at phase 13's bars, card with P5 against card with every chain
    unrouted at the bars of ``HRNET_P5_STEP_BARS``;
19. validation of the trained W32: ``make_eval_step`` (flip test, a padded
    last batch) on crops of phase 10's synthetic COCO set, then COCO AP
    through ``make_evaluate_fn``: 52 P5e and 3 decode launches per batch,
    one OKS and one greedy launch per image, 10 finite stats;
20. the conv3x3_fwd kernel against its plain version on the four RN-50
    3x3 shapes at batch 32, the probes' shape, edge cases (B = 1 and 3,
    C = 8 and 40, 1x1 and 3x130 images) and wide cases (W = 200 and 258,
    odd W, C = 12, 20, 24, 72 and 1024), bf16 -> bf16, bf16 -> float32 and
    float32 -> float32, TF32 off, at the bars of
    ``tools/profile_conv.py``; two runs bit-equal; HMMA in the bf16
    entries' SASS; then the device time of the kernel, its plain version
    and ``F.conv2d`` (cuDNN, timed, never used) at the RN-50 and probe
    shapes;
21. RN-50 serve in bf16 with the checks of phase 5 (26 conv3x3_fwd
    launches per chunk), then float32 card-vs-CPU parity at phase 6's bars
    inside a main-path window (the float32-out kernel, 26 per Predictor
    forward pair);
22. the RN-50 plain train step at full width (bf16, batch 32, Adam lr
    1e-3): per step 13 conv3x3_fwd, 13 P4 and 2 decode launches, finite
    losses falling over 10 steps on one batch, warm train images/s in
    turns with the route off (cuDNN forwards), a profile of each route,
    and the kernel on one step's 13 conv shapes against cuDNN's forward;
23. float32 RN-50 step parity (TF32 off, batch 2): card against CPU at
    phase 13's bars, card with the route against card without it at the
    bars of ``RN50_ROUTE_STEP_BARS``;
24. validation of the trained RN-50 as phase 19: 26 conv3x3_fwd and 3
    decode launches per batch, one OKS and one greedy launch per image,
    10 finite stats.

Phases 15, 16 and 20 run right after 11; W32 serving (phases 8 and 10)
also counts 52 P5e launches per chunk.

Each path runs with the launch counts set to 0 just before it and read
just after; comparisons of a kernel with its plain version run outside
those windows.  Then one JSON line with the kernels, and last the
``{"ok": true, ...}`` line.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import copy
import json
import math
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
STUDENT_YAML = REPO / "experiments/mpii/hourglass/hg4_128_student.yaml"
TEACHER_YAML = REPO / "experiments/mpii/hourglass/hg8_256x256_teacher.yaml"
W32_YAML = REPO / "experiments/coco/hrnet/w32_256x192_adam_lr1e-3.yaml"
DECODE_SHAPES = [(32, 16, 64, 64), (32, 17, 64, 48), (3, 5, 7, 9),
                 (1, 1, 1, 1)]
TIMED_SHAPE = (32, 16, 64, 64)
NMS_SIZES = (128, 256, 1152)
NMS_TIMED_N = 128          # every image of the COCO path pads to 128
NMS_THRESH = 0.9           # TEST.OKS_THRE of the W32 config
# K2 against its plain version: the JAX package's own bar for K2 against
# pairwise_oks_jnp (tests/test_native_nms.py:90).
OKS_RTOL, OKS_ATOL = 1e-5, 1e-6
# float32 parity, card (cuDNN, TF32 off) against CPU: the convolutions
# sum in another order, which moves float32 heatmaps by about 1e-6
# relative per layer over ~100 layers.  Tolerance: max|diff| within
# max(PARITY_HM_ATOL, PARITY_HM_RTOL * max|heatmap|).
PARITY_HM_ATOL = 1e-3
PARITY_HM_RTOL = 1e-4
# Joints whose decode decisions all have a margin above twice the heatmap
# tolerance take the same argmax and offsets on both sides, so their
# preds differ only by the float32 affine: within PARITY_PREDS_ATOL px.
PARITY_PREDS_ATOL = 1e-3
COCO_IMAGES = 64
COCO_SET = "val2017"
OKS_MARGIN = 1e-5          # float32 vs float64 OKS-NMS may differ inside it
TRAIN_BATCH = 32
TRAIN_STEPS = 20           # on one repeated batch: the loss must fall
P4_PER_STEP = 59           # 3x3 stride-1 convs of the student (tests pin it)
K1_PER_TRAIN_STEP = 2      # the PCK counts' argmaxes: output and target
K1_PER_EVAL_BATCH = 3      # the decode and the two PCK argmaxes
MPII_PEOPLE = 56           # two eval batches of 32, the last one padded
# float32 train-step parity (one FPD step at full width, batch 2, TF32
# off).  A float32 step is only good to a few percent in its gradients:
# train-mode BatchNorm over two samples amplifies reduction-order
# rounding.  `python3 -m fhpe_tpu_torch.tools.train_parity` on an H100
# measured, against the same step in float64 on the CPU: the CPU's
# float32 step 2.1e-2 and the card's 3.4e-2 relative L2 in Adam's first
# moment (worst tensor 0.22 and 0.28), losses 2e-6, BN running stats 6e-5
# of a tensor's max; card against CPU 3.7e-2 (worst tensor 0.28), and
# 0.61% of the parameters with a live gradient moved apart by more than
# 1% of lr.  Card against CPU is held to bars that allow that chaos:
TRAIN_PARITY_LOSS_RTOL = 1e-5
TRAIN_PARITY_STATS_RTOL = 2e-3
TRAIN_PARITY_MOMENT_L2 = 0.1
TRAIN_PARITY_MOMENT_TENSOR = 0.5
TRAIN_PARITY_PARAMS_OFF = 2e-2   # share of live elements off by > 1% lr
# ... and P4 inside the step is held tightly against cuDNN's filter
# gradient in its place on the card, the rest of the step unchanged
# (measured 4.7e-6 relative L2, worst tensor 2.0e-5, no parameter off;
# losses and BN statistics come before the backward and are equal):
WGRAD_STEP_MOMENT_L2 = 1e-4
WGRAD_STEP_MOMENT_TENSOR = 1e-3
WGRAD_STEP_PARAMS_OFF = 1e-4

# FPD training of HRNet-W32 by W48 (COCO 256x192): each net runs 26 branch
# chains (1 x 2 + 4 x 3 + 3 x 4 in stages 2-4), so 26 P5t launches per
# student step and 26 P5e per teacher forward (52 per flip-test batch);
# P4 gets the chains' 8 x 26 = 208 filter gradients and layer1's 4.
HRNET_CHAINS = 26
HRNET_P4_PER_STEP = 212
HRNET_TRAIN_STEPS = 10     # on one repeated batch: the loss must fall
# float32 FPD W48 -> W32 step parity (full width, batch 2, TF32 off), as
# (loss rtol, BN stats, moments relative L2, worst moment tensor, share of
# live parameters off by > 1% of lr).  Card against CPU at phase 13's bars:
HRNET_PARITY_BARS = (TRAIN_PARITY_LOSS_RTOL, TRAIN_PARITY_STATS_RTOL,
                     TRAIN_PARITY_MOMENT_L2, TRAIN_PARITY_MOMENT_TENSOR,
                     TRAIN_PARITY_PARAMS_OFF)
# ... and the card with P5 against the card with every chain unrouted (its
# blocks as cuDNN convs and BatchNorm modules).  P5 changes the forward, by
# ~1e-6 relative in float32 (phase a), which the step amplifies as it
# amplifies card against CPU (a chain's train-mode BN over two samples):
# measured on an H100 losses 2.3e-7, BN stats 8.2e-7, moments 8.0e-3 and
# 9.3e-3 relative L2 (worst tensor 0.16), 2.3e-4 of the live parameters
# off by > 1% of lr; card against CPU 1.1e-6, 3.5e-6, 1.8e-2 and 2.1e-2
# (worst 0.17), 1.2e-3.  So not P4's tight bars; tighter than card against
# CPU's where the chaos allows (BN stats and parameters 20x, moments 3x):
HRNET_P5_STEP_BARS = (1e-5, 1e-4, 0.03, 0.5, 1e-3)

# PoseResNet-50 (COCO 256x192): 13 stride-1 3x3 convs (3, 3, 5 and 2 in
# layers 1-4), each a conv3x3_fwd launch per forward and a P4 launch per
# train step.
RN50_YAML = REPO / "experiments/coco/resnet/res50_256x192_d256x3_adam_lr1e-3.yaml"
RN50_ROUTED = 13
RN50_TRAIN_STEPS = 10      # on one repeated batch: the loss must fall
# conv3x3_fwd against its plain version: the bars of
# fhpe_tpu_torch/tools/profile_conv.py (REL_TOL).

# float32 RN-50 step parity (full width, batch 2, TF32 off), as (loss
# rtol, BN stats, moments relative L2, worst moment tensor, share of live
# parameters off by > 1% of lr): card with the conv3x3_fwd route against
# the card with cuDNN's forwards in its place.  The route changes the 13
# convs' outputs by float32 rounding (~2e-6 of max|y| on the CUDA cores),
# which train-mode BN over two samples amplifies as it amplifies card against
# CPU; measured on an H100: losses equal, BN stats 7.0e-8, moments 2.5e-4
# and 2.8e-4 relative L2 (worst tensor 6.5e-4), no live parameter off;
# card against CPU 8.3e-7, 7.2e-6, 2.9e-2 and 3.4e-2 (worst 0.20), 0.54%
# off.  About 10x above the route's own numbers:
RN50_ROUTE_STEP_BARS = (1e-6, 1e-6, 3e-3, 1e-2, 1e-4)

# Card peaks for the bound (NVIDIA H100 SXM data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12    # tensor cores, bf16 in, float32 accumulate
# float32 operations K2 does: per (i, j, joint) 2 subtractions, 4
# multiplications, 2 additions and exp (counted as 2); per (i, j) the
# denominator (2 additions, 2 divisions) and the final division.
OKS_OPS_PER_JOINT, OKS_OPS_PER_PAIR = 10, 5

KERNELS = {
    "decode_heatmaps": {"source": "fhpe_tpu_torch/ops/csrc/decode.cu",
                        "replaces": "fhpe_tpu/ops/decode_pallas.py:24"},
    "pairwise_oks": {"source": "fhpe_tpu_torch/ops/csrc/nms.cu",
                     "replaces": "fhpe_tpu/ops/nms_jax.py:75"},
    "greedy_nms_mask": {"source": "fhpe_tpu_torch/ops/csrc/nms.cu",
                        "replaces": "fhpe_tpu/ops/nms_jax.py:126"},
    "conv3x3_wgrad": {"source": "fhpe_tpu_torch/ops/csrc/conv_wgrad.cu",
                      "replaces": "scripts/probe/dw_pallas_probe.py:32"},
    "branch_chain_eval": {
        "source": "fhpe_tpu_torch/ops/csrc/branch_chain.cu",
        "replaces": "scripts/probe/fused_block/fused_block_kernels.py:236"},
    "branch_chain_train": {
        "source": "fhpe_tpu_torch/ops/csrc/branch_chain.cu",
        "replaces": "scripts/probe/fused_block/fused_block_kernels.py:128"},
    # bf16 out: P2 and P3 (pc_test.py:20, pallas_conv_probe2.py:46,77,111)
    "conv3x3_fwd": {"source": "fhpe_tpu_torch/ops/csrc/conv3x3_fwd.cu",
                    "replaces": "scripts/probe/pallas_conv_probe2.py:46"},
    # float32 out: P1 (pallas_conv_probe.py:40,75)
    "conv3x3_fwd_f32": {"source": "fhpe_tpu_torch/ops/csrc/conv3x3_fwd.cu",
                        "replaces": "scripts/probe/pallas_conv_probe.py:40"},
}
# kernel group of P5's launches in tools/profile_serve.py::KERNEL_GROUPS
P5_GROUP = "branch chain kernel (P5)"
# P5 (a whole BasicBlock chain) against its plain version on the card:
# the bars of fhpe_tpu_torch/tools/profile_chain.py (Y_TOL, Y_MEAN_TOL,
# STATS_TOL), timed at its TIMED shape, W32's branch 0 at batch 32.
# BranchChainFn's gradients against autograd through the plain version,
# float32, TF32 off, at one W32 chain shape: relative L2 per tensor.  The
# kernel's forward differs from the plain one by ~1e-6 relative, which
# flips the ReLU mask of the few elements within that of 0; each flip
# moves one gradient element by its own size, so the relative L2 is about
# the square root of the share flipped (measured 2.1e-3 on an H100, worst
# tensor a BN scale; the float64 CPU test holds the backward to 1e-12).
CHAIN_GRAD_SHAPE = (32, 64, 32, 24)
CHAIN_GRAD_REL_L2 = 1e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def on_card(device, n: int) -> int:
    """What a launch count should be: ``n`` on the card; 0 on the CPU,
    where the wrappers run the plain versions (rehearsals)."""
    return n if device.type == "cuda" else 0


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for their type (float32 by default),
    whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# -- launch counts of the main path -----------------------------------------

def _counters():
    from fhpe_tpu_torch.ops import (branch_chain, conv3x3_fwd, conv_wgrad,
                                    decode, nms_torch)
    return {"decode_heatmaps": (decode, "decode_kernel_launches"),
            "pairwise_oks": (nms_torch, "pairwise_oks_launches"),
            "greedy_nms_mask": (nms_torch, "greedy_nms_launches"),
            "conv3x3_wgrad": (conv_wgrad, "conv_wgrad_launches"),
            "branch_chain_eval": (branch_chain,
                                  "branch_chain_eval_launches"),
            "branch_chain_train": (branch_chain,
                                   "branch_chain_train_launches"),
            "conv3x3_fwd": (conv3x3_fwd, "conv3x3_fwd_launches"),
            "conv3x3_fwd_f32": (conv3x3_fwd, "conv3x3_fwd_f32_launches")}


def expected(device, **launches) -> dict:
    """The counts a main-path run should read: ``launches`` of the kernels
    named, 0 of every other (all 0 on the CPU, see :func:`on_card`)."""
    return {name: on_card(device, launches.get(name, 0)) for name in KERNELS}


def fwd_launches(model, dtype, forwards: int) -> dict:
    """conv3x3_fwd launches of ``forwards`` forwards of ``model`` in
    ``dtype``, keyed by the kernel's output type (26 per RN-50 flip-test
    chunk; none for the hourglass or HRNet)."""
    import torch
    from fhpe_tpu_torch.models.common import fwd_kernel_convs
    key = "conv3x3_fwd" if dtype == torch.bfloat16 else "conv3x3_fwd_f32"
    return {key: len(fwd_kernel_convs(model)) * forwards}


def main_path_run(totals: Counter, fn):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; add the counts to ``totals``.  Returns (result, counts)."""
    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    totals.update(counts)
    return out, counts


# -- configs and weights ------------------------------------------------------

def serve_cfg(yaml_path, dtype="bfloat16", root=None):
    from fhpe_tpu_torch.config import load_config
    cfg = load_config(str(yaml_path))
    cfg.defrost()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.SHIFT_HEATMAP = True
    cfg.TEST.POST_PROCESS = True
    if root is not None:
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.TEST_SET = COCO_SET
    cfg.freeze()
    return cfg


def seeded_model(cfg, seed: int):
    """torch-default-initialised weights from a fixed seed."""
    import torch
    from fhpe_tpu_torch.models import get_pose_net
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_pose_net(cfg)


def he_model(cfg, seed: int):
    """He-scale weights with BN statistics from one batch, on the CPU
    (``models.common.he_scale_weights``): the reference init would give
    HRNet heatmaps of ~0 that decode to (0, 0)."""
    from fhpe_tpu_torch.models import get_pose_net
    from fhpe_tpu_torch.models.common import he_scale_weights
    model = get_pose_net(cfg)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    he_scale_weights(model, seed, (h, w))
    return model


def make_requests(cfg, n: int, seed: int):
    rng = np.random.RandomState(seed)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    crops = rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    centers = rng.uniform(100, 400, size=(n, 2))
    scales = rng.uniform(0.8, 2.0, size=(n, 2))
    return crops, centers, scales


# -- kernels against their plain versions ------------------------------------

def phase_kernel_vs_plain(device) -> dict:
    """Decode kernel against plain on planted cases, bit-equal; timings."""
    import torch
    from fhpe_tpu_torch.ops.decode import decode_argmax, decode_argmax_plain
    from fhpe_tpu_torch.ops.decode_cases import planted_heatmaps
    from fhpe_tpu_torch.utils.profiling import device_ms

    cases = []
    for shape in DECODE_SHAPES:
        hm = torch.from_numpy(planted_heatmaps(*shape, seed=11)).to(device)
        cases.append((str(shape), hm))
    # a contiguous tensor whose rows are not 16-byte aligned (scalar path)
    n = int(np.prod(TIMED_SHAPE))
    buf = torch.empty(n + 1, dtype=torch.float32, device=device)
    buf[1:] = torch.from_numpy(planted_heatmaps(*TIMED_SHAPE, seed=12)
                               ).reshape(-1).to(device)
    cases.append((f"{TIMED_SHAPE} unaligned", buf[1:].view(TIMED_SHAPE)))

    max_err = 0.0
    for name, hm in cases:
        for post in (True, False):
            kc, kv = decode_argmax(hm, post)
            pc, pv = decode_argmax_plain(hm, post)
            sync(device)
            err = max((kc - pc).abs().max().item(),
                      (kv - pv).abs().max().item())
            max_err = max(max_err, err)
            if not (torch.equal(kc, pc) and torch.equal(kv, pv)):
                raise AssertionError(f"decode kernel != plain on {name} "
                                     f"post_process={post}: max err {err}")
    log("kernel", f"decode kernel == plain (bit-equal) on {len(cases)} "
        f"planted cases x post_process on/off")

    b, j, h, w = TIMED_SHAPE
    # each heatmap value read once and compared once; (x, y, maxval) out
    lim = bound(4 * b * j * h * w + 12 * b * j, b * j * h * w)
    if device.type != "cuda":
        return {"max_abs_err": max_err, "ms": None, "plain_ms": None, **lim}
    hm = torch.from_numpy(planted_heatmaps(*TIMED_SHAPE, seed=13)).to(device)

    def kernel():
        return decode_argmax(hm, True)

    def plain():
        return decode_argmax_plain(hm, True)

    # in turns: plain, kernel, kernel, plain
    dp1, dk1, dk2, dp2 = (device_ms(f) for f in (plain, kernel, kernel,
                                                 plain))
    log("kernel", f"decode {TIMED_SHAPE} float32, warm L2: device time "
        f"per call (profiler) kernel {dk1:.4f}/{dk2:.4f} ms, plain "
        f"{dp1:.4f}/{dp2:.4f} ms; bound {lim['bound_ms']:.5f} ms "
        f"({lim['bound_by']})")
    return {"max_abs_err": max_err, "ms": (dk1 + dk2) / 2,
            "plain_ms": (dp1 + dp2) / 2, **lim}


def phase_nms_kernels(device) -> dict:
    """OKS kernel within tolerance and greedy kernel bit-equal to their
    plain versions on planted cases; then timings at N = 128."""
    import torch
    from fhpe_tpu_torch.ops.nms_cases import planted_nms_cases
    from fhpe_tpu_torch.ops.nms_torch import (greedy_nms_mask,
                                              greedy_nms_mask_plain,
                                              pairwise_oks,
                                              pairwise_oks_plain)
    from fhpe_tpu_torch.utils.profiling import device_ms

    oks_err, checked = 0.0, 0
    for n in NMS_SIZES:
        for name, *arrays in planted_nms_cases(n, seed=n):
            xs, ys, areas, scores, valid = (torch.from_numpy(a).to(device)
                                            for a in arrays)
            sim = pairwise_oks(xs, ys, areas)
            ref = pairwise_oks_plain(xs, ys, areas)
            sync(device)
            oks_err = max(oks_err, (sim - ref).abs().max().item())
            if not torch.allclose(sim, ref, rtol=OKS_RTOL, atol=OKS_ATOL):
                raise AssertionError(f"OKS kernel != plain beyond rtol "
                                     f"{OKS_RTOL} atol {OKS_ATOL} on {name}"
                                     f" N={n}")
            for s in (sim, ref):
                keep = greedy_nms_mask(s, scores, valid, NMS_THRESH)
                keep_ref = greedy_nms_mask_plain(s, scores, valid,
                                                 NMS_THRESH)
                if not torch.equal(keep, keep_ref):
                    raise AssertionError(f"greedy kernel != plain on {name}"
                                         f" N={n}")
            checked += 1
    log("nms", f"OKS kernel within rtol {OKS_RTOL} / atol {OKS_ATOL} of "
        f"plain (max|diff| {oks_err:.3g}), greedy kernel == plain "
        f"(bit-equal) on {checked} planted cases at N = {NMS_SIZES}")

    _, *arrays = planted_nms_cases(NMS_TIMED_N, seed=21)[0]   # clusters
    xs, ys, areas, scores, valid = (torch.from_numpy(a).to(device)
                                    for a in arrays)
    sim = pairwise_oks(xs, ys, areas)
    kept = int(greedy_nms_mask(sim, scores, valid, NMS_THRESH).sum())
    n, j = xs.shape
    timed = {
        "pairwise_oks": (
            lambda: pairwise_oks(xs, ys, areas),
            lambda: pairwise_oks_plain(xs, ys, areas),
            # xs, ys, areas read once; the (N, N) matrix written once
            bound(4 * (2 * n * j + n + n * n),
                  n * n * (OKS_OPS_PER_JOINT * j + OKS_OPS_PER_PAIR))),
        "greedy_nms_mask": (
            lambda: greedy_nms_mask(sim, scores, valid, NMS_THRESH),
            lambda: greedy_nms_mask_plain(sim, scores, valid, NMS_THRESH),
            # one row of sim per kept detection, scores, valid, keep
            bound(4 * kept * n + 4 * n + 2 * n, kept * n)),
    }
    out = {"pairwise_oks": {"max_abs_err": oks_err},
           "greedy_nms_mask": {"max_abs_err": 0.0}}
    for name, (kernel, plain, lim) in timed.items():
        out[name].update(ms=None, plain_ms=None, **lim)
        if device.type != "cuda":
            continue
        iters = 100 if name == "pairwise_oks" else 20
        dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in
                              (plain, kernel, kernel, plain))
        out[name].update(ms=(dk1 + dk2) / 2, plain_ms=(dp1 + dp2) / 2, **lim)
        log("nms", f"{name} N={n} ({int(valid.sum())} valid, {kept} kept):"
            f" device time per call (profiler) kernel {dk1:.4f}/{dk2:.4f}"
            f" ms, plain {dp1:.4f}/{dp2:.4f} ms; bound "
            f"{lim['bound_ms']:.6f} ms ({lim['bound_by']})")
    return out


# -- serving -------------------------------------------------------------------

def check_outputs(phase, preds, maxvals, n, num_joints):
    if preds.shape != (n, num_joints, 2) or maxvals.shape != (n, num_joints):
        raise AssertionError(f"{phase}: shapes {preds.shape} "
                             f"{maxvals.shape}, expected ({n}, "
                             f"{num_joints}, 2) and ({n}, {num_joints})")
    if not (np.isfinite(preds).all() and np.isfinite(maxvals).all()):
        raise AssertionError(f"{phase}: non-finite outputs")


def check_kernel_path_on_chunk(phase, p, crops, centers, scales):
    """One chunk's merged heatmaps: kernel path == plain path preds."""
    import torch
    from fhpe_tpu_torch.ops.decode import (decode_heatmaps,
                                           make_inverse_transforms)
    b = p.batch_size
    hm = p.merged_heatmaps(torch.from_numpy(crops[:b]).to(p.device))
    inv = torch.from_numpy(make_inverse_transforms(
        centers[:b], scales[:b], p.heatmap_size))
    kp, kv = decode_heatmaps(hm, inv.to(p.device), p.post_process)
    pp, pv = decode_heatmaps(hm.cpu(), inv, p.post_process)
    if not (torch.equal(kp.cpu(), pp) and torch.equal(kv.cpu(), pv)):
        raise AssertionError(f"{phase}: kernel-path preds != plain-path "
                             f"preds on one chunk's merged heatmaps")
    log(phase, f"kernel path == plain path on one chunk of {b} "
        f"(merged heatmaps {tuple(hm.shape)})")


def check_bf16_flow(phase, p, crops):
    """The forward on the card keeps fhpe_tpu's bf16 flow (CUDA autocast
    lists some ops as float32, the CPU tests cannot see that)."""
    import torch
    from fhpe_tpu_torch.models.common import bf16_flow_violations
    from fhpe_tpu_torch.ops.preprocess import normalize_images
    if p.dtype != torch.bfloat16:
        return
    x = normalize_images(torch.from_numpy(crops).to(p.device))
    checked, bad = bf16_flow_violations(p.model, x)
    if bad:
        raise AssertionError(f"{phase}: bf16 flow broken at {len(bad)} of "
                             f"{checked} modules, first {bad[:3]}")
    log(phase, f"bf16 flow as fhpe_tpu's at all {checked} modules checked "
        f"(convs, BNs, blocks: bf16 in and out; heatmaps float32)")


def chains_per_chunk(p) -> int:
    """P5e calls per chunk: every fused chain once per forward, two
    forwards with the flip test (52 for HRNet-W32, 0 for the hourglass)."""
    return len(fused_chains(p.model)) * (2 if p.flip_test else 1)


def phase_serve(phase, cfg, model, device, requests, seed, totals,
                label=""):
    """Serve ``requests`` (crop counts) as one main-path run; returns the
    Predictor."""
    from fhpe_tpu_torch.serve import Predictor

    p = Predictor(cfg, model, device=device)
    t0 = time.perf_counter()
    p.warmup()
    log(phase, f"warmup {time.perf_counter() - t0:.2f} s "
        f"(batch {p.batch_size}, {cfg.TPU.COMPUTE_DTYPE})")

    num_joints = int(cfg.MODEL.NUM_JOINTS)
    data = [make_requests(cfg, n, seed + 1 + i)
            for i, n in enumerate(requests)]
    chunks = sum(-(-n // p.batch_size) for n in requests)
    outs, counts = main_path_run(
        totals, lambda: [p.predict_crops(*d) for d in data])
    for n, (preds, maxvals) in zip(requests, outs):
        check_outputs(phase, preds, maxvals, n, num_joints)
    per_chunk = chains_per_chunk(p)
    forwards = 2 if p.flip_test else 1
    fwd = fwd_launches(p.model, p.dtype, forwards)
    want = expected(device, decode_heatmaps=chunks,
                    branch_chain_eval=per_chunk * chunks,
                    **{k: v * chunks for k, v in fwd.items()})
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts} for {chunks} "
                             f"chunks, want {want}")
    log(phase, f"requests {requests}: shapes and finite ok, "
        f"decode_kernel_launches {counts['decode_heatmaps']} == chunks "
        f"{chunks}" + (f", P5e launches {counts['branch_chain_eval']} "
                       f"({per_chunk} per chunk)" if per_chunk else "")
        + "".join(f", {k} launches {counts[k]} ({v} per chunk)"
                  for k, v in fwd.items() if v))
    check_kernel_path_on_chunk(phase, p, *max(data, key=lambda d: len(d[0])))
    check_bf16_flow(phase, p, data[0][0])

    if label and per_chunk and device.type == "cuda":
        from fhpe_tpu_torch.tools.profile_serve import kernel_group
        from fhpe_tpu_torch.utils.profiling import device_events
        chunk = make_requests(cfg, p.batch_size, seed + 98)
        events = device_events(lambda: p.predict_crops(*chunk), 2)
        p5 = sum(float(e["dur"]) for e in events if e["cat"] == "kernel"
                 and kernel_group(e["name"]) == P5_GROUP) / 2e3
        busy = sum(float(e["dur"]) for e in events) / 2e3
        log(phase, f"P5 device time per chunk of {p.batch_size} crops: "
            f"{p5:.3f} ms of {busy:.3f} ms of device work ({per_chunk} P5e "
            f"calls, flip test on, profiler)")
    if label:
        crops, centers, scales = make_requests(cfg, 8 * p.batch_size,
                                               seed + 99)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            p.predict_crops(crops, centers, scales)
            rates.append(len(crops) / (time.perf_counter() - t0))
        log(phase, f"warm predict_crops {sorted(rates)[1]:.1f} images/s "
            f"(median of 3 x {len(crops)} crops, flip test on, "
            f"{cfg.TPU.COMPUTE_DTYPE}, batch {p.batch_size}) on {label}")
    return p


def phase_f32_parity(phase, cfg, model, device, seed) -> None:
    """float32 on the card (TF32 off) against the port on the CPU, on the
    same weights (``model`` lives on the CPU)."""
    import torch
    from fhpe_tpu_torch.ops.decode_cases import decision_margin
    from fhpe_tpu_torch.serve import Predictor

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        crops, centers, scales = make_requests(cfg, 2, seed + 7)
        gpu = Predictor(cfg, copy.deepcopy(model), batch_size=2,
                        device=device)
        cpu = Predictor(cfg, model, batch_size=2, device="cpu")
        hm_g = gpu.merged_heatmaps(torch.from_numpy(crops).to(device)).cpu()
        hm_c = cpu.merged_heatmaps(torch.from_numpy(crops))
        hm_err = (hm_g - hm_c).abs().max().item()
        hm_max = hm_c.abs().max().item()
        tol = max(PARITY_HM_ATOL, PARITY_HM_RTOL * hm_max)
        if not hm_err <= tol:
            raise AssertionError(f"{phase}: heatmaps differ by {hm_err} > "
                                 f"{tol}")
        preds_g, vals_g = gpu.predict_crops(crops, centers, scales)
        preds_c, vals_c = cpu.predict_crops(crops, centers, scales)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev

    robust = decision_margin(hm_c.numpy()) > 2 * tol
    mismatch = (np.abs(preds_g - preds_c) > PARITY_PREDS_ATOL).any(-1) \
        & robust
    if mismatch.any():
        raise AssertionError(f"{phase}: {int(mismatch.sum())} robust "
                             f"joints decode differently")
    val_err = np.abs(vals_g - vals_c).max()
    if not val_err <= tol:
        raise AssertionError(f"{phase}: maxvals differ by {val_err}")
    log(phase, f"card vs CPU, TF32 off: heatmaps max|diff| {hm_err:.3g} "
        f"(tol {tol:.3g}, max|hm| {hm_max:.3g}); preds within "
        f"{PARITY_PREDS_ATOL} px on {int(robust.sum())}/{robust.size} "
        f"joints with decode margin > {2 * tol:.3g} (max|pred diff| over "
        f"all {np.abs(preds_g - preds_c).max():.3g} px); maxvals max|diff| "
        f"{val_err:.3g}")


# -- COCO evaluation ---------------------------------------------------------

def phase_coco_planted(cfg, gt, device, out_dir, totals) -> None:
    """Planted detections through make_evaluate_fn: keep-lists per image
    against the host float64 oks_nms, AP against the host-NMS run's."""
    from fhpe_tpu_torch.cli.common import make_evaluate_fn
    from fhpe_tpu_torch.data.coco import rescore_and_nms
    from fhpe_tpu_torch.data.coco_synthetic import (oks_margin,
                                                    planted_detections)
    from fhpe_tpu_torch.ops import nms_torch
    from fhpe_tpu_torch.ops.nms import oks_nms

    aspect = cfg.MODEL.IMAGE_SIZE[0] / cfg.MODEL.IMAGE_SIZE[1]
    preds, boxes, paths = planted_detections(gt, cfg.DATASET.ROOT, COCO_SET,
                                             aspect, seed=3)
    images = len(set(paths))
    thresh = cfg.TEST.OKS_THRE
    evaluate = make_evaluate_fn(cfg, device=device)

    # The host-NMS run: the same entry point with the host oks_nms in the
    # device drop-in's place; each image's device keep-list is compared.
    device_nms, lists, skipped = nms_torch.oks_nms_device, [], 0

    def host_nms(kpts_db, oks_thre, sigmas=None, pad_to=128, device="cuda"):
        nonlocal skipped
        host = oks_nms(kpts_db, oks_thre, sigmas)
        if oks_margin(kpts_db, oks_thre) > OKS_MARGIN:
            lists.append((device_nms(kpts_db, oks_thre, sigmas, pad_to,
                                     device), host))
        else:
            skipped += 1
        return host

    with mock.patch.object(nms_torch, "oks_nms_device", host_nms):
        nv_host, _ = evaluate(cfg, preds, str(out_dir / "host"), boxes, paths)
    bad = sum(d != h for d, h in lists)
    if bad or not lists:
        raise AssertionError(f"coco: device keep-lists differ from host "
                             f"oks_nms on {bad} of {len(lists)} images")
    log("coco", f"keep-lists == host oks_nms (float64) on {len(lists)} of "
        f"{images} images ({skipped} with an OKS within {OKS_MARGIN} of "
        f"OKS_THRE {thresh}); {len(preds)} detections, "
        f"{sum(len(h) for _, h in lists)} kept")

    (nv, _), counts = main_path_run(
        totals, lambda: evaluate(cfg, preds, str(out_dir / "device"), boxes,
                                 paths))
    if list(nv.items()) != list(nv_host.items()) or not nv["AP"] > 0.5:
        raise AssertionError(f"coco: device-NMS stats {dict(nv)} != host-"
                             f"NMS stats {dict(nv_host)} or AP <= 0.5")
    if not counts["pairwise_oks"] == counts["greedy_nms_mask"] == \
            on_card(device, images):
        raise AssertionError(f"coco: OKS/greedy launches {counts} for "
                             f"{images} images")
    log("coco", f"planted detections: AP {nv['AP']:.4f} == host-NMS run's "
        f"(all 10 stats equal); pairwise_oks {counts['pairwise_oks']} and "
        f"greedy {counts['greedy_nms_mask']} launches == {images} images")

    # NMS cost per image on the host clock, warm, each call ending in its
    # keep-mask download; against the host float64 oks_nms
    groups = rescore_and_nms(preds, boxes, paths, in_vis_thre=
                             cfg.TEST.IN_VIS_THRE, oks_thre=2.0,
                             device=device)
    per = {"device": [], "host": []}
    for img in groups:
        device_nms(img, thresh, device=device)
        for name, fn in (("device", lambda: device_nms(img, thresh,
                                                       device=device)),
                         ("host", lambda: oks_nms(img, thresh))):
            t0 = time.perf_counter()
            fn()
            per[name].append((time.perf_counter() - t0) * 1e3)
    log("coco", f"NMS per image (host clock, median of {len(groups)} "
        f"images of {min(map(len, groups))}-{max(map(len, groups))} "
        f"detections): oks_nms_device {np.median(per['device']):.4f} ms "
        f"(pack, one upload, two launches, one keep-mask download), host "
        f"float64 oks_nms {np.median(per['host']):.4f} ms")
    if device.type == "cuda":
        from fhpe_tpu_torch.utils.profiling import busy_ms, device_events
        walls = []

        def all_images():
            t0 = time.perf_counter()
            for img in groups:
                device_nms(img, thresh, device=device)
            walls.append((time.perf_counter() - t0) * 1e3)

        events = device_events(all_images)
        busy = busy_ms(events)
        copies = sum(float(e["dur"]) for e in events
                     if e["cat"] == "gpu_memcpy") / 1e3
        log("coco", f"NMS of all {len(groups)} images under the profiler: "
            f"{walls[0]:.3f} ms, device busy {busy:.3f} ms (idle share "
            f"{1 - busy / walls[0]:.3f}), of which memcpy {copies:.3f} ms; "
            f"{len(events) / len(groups):.1f} device ops per image")


def phase_coco_predictor(p, cfg, gt, device, out_dir, totals) -> None:
    """The whole COCO path: W32 predictions on crops at the ground-truth
    boxes, then make_evaluate_fn."""
    from fhpe_tpu_torch.cli.common import make_evaluate_fn
    from fhpe_tpu_torch.data.coco_synthetic import gt_boxes

    aspect = cfg.MODEL.IMAGE_SIZE[0] / cfg.MODEL.IMAGE_SIZE[1]
    boxes, paths = gt_boxes(gt, cfg.DATASET.ROOT, COCO_SET, aspect)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    crops = np.random.RandomState(31).randint(
        0, 256, size=(len(boxes), h, w, 3)).astype(np.uint8)
    evaluate = make_evaluate_fn(cfg, device=device)
    times = {}

    def run():
        t0 = time.perf_counter()
        preds, maxvals = p.predict_crops(crops, boxes[:, :2], boxes[:, 2:4])
        times["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = evaluate(cfg, np.concatenate([preds, maxvals[..., None]], -1),
                       str(out_dir / "w32"), boxes, paths)
        times["evaluate"] = time.perf_counter() - t0
        return out

    (nv, _), counts = main_path_run(totals, run)
    chunks, images = -(-len(boxes) // p.batch_size), len(set(paths))
    if counts["decode_heatmaps"] != on_card(device, chunks) or not \
            counts["pairwise_oks"] == counts["greedy_nms_mask"] == \
            on_card(device, images) or counts["branch_chain_eval"] != \
            on_card(device, chains_per_chunk(p) * chunks):
        raise AssertionError(f"coco-w32: launches {counts} for {chunks} "
                             f"chunks and {images} images")
    if len(nv) != 10 or not all(math.isfinite(v) for v in nv.values()):
        raise AssertionError(f"coco-w32: stats {dict(nv)}")
    log("coco-w32", f"{len(boxes)} crops -> predict_crops "
        f"{times['predict']:.3f} s -> evaluate {times['evaluate']:.3f} s; "
        f"launches {counts} ({chunks} chunks, {images} images); 10 stats "
        f"finite: " + ", ".join(f"{k} {v:.4f}" for k, v in nv.items()))


# -- training -----------------------------------------------------------------

def phase_wgrad_kernel(device) -> dict:
    """P4 against its plain version on planted cases at every shape of the
    three train steps' sets (batch 32), edge and wide cases, bf16 and
    float32; two runs bit-equal; the bf16 entries' SASS holds tensor-core
    instructions; timings at ``profile_wgrad.TIMED`` in bf16
    (``fhpe_tpu_torch/tools/profile_wgrad.py``)."""
    from fhpe_tpu_torch.tools import profile_wgrad
    from fhpe_tpu_torch.utils.profiling import tensor_core_counts

    chk = profile_wgrad.check_cases(device)
    log("wgrad", f"P4 kernel within {profile_wgrad.REL_TOL} of max|dW| of "
        f"its plain version on {chk['cases']} cases, bf16 and float32 "
        f"(worst bf16 {chk['bf16']:.3g}, "
        f"float32 {chk['float32']:.3g}; bf16 against float64 "
        f"{chk['bf16 vs float64']:.3g}, the plain version "
        f"{chk['plain vs float64']:.3g}), two runs bit-equal")

    bound_ms, bound_by = profile_wgrad.bound_ms([profile_wgrad.TIMED])
    out = {"max_abs_err": chk["max_abs_err"], "ms": None, "plain_ms": None,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    if device.type != "cuda":
        return out
    mma = tensor_core_counts("wgrad")
    bf16 = {k: v for k, v in mma.items() if "wgrad_bf16" in k}
    if mma and not all(sum(v) > 0 for v in bf16.values()):
        raise AssertionError(f"wgrad: bf16 entries without tensor-core "
                             f"instructions: {bf16}")
    log("wgrad", f"SASS (HMMA, HGMMA) per bf16 entry: "
        f"{bf16 or 'no cuobjdump'}")
    t = profile_wgrad.time_one(device)
    out.update(ms=sum(t["ms"]) / 2, plain_ms=sum(t["plain_ms"]) / 2,
               library_ms=t["library_ms"])
    log("wgrad", f"P4 {profile_wgrad.TIMED} bf16: device time per call "
        f"(profiler) kernel {t['ms'][0]:.4f}/{t['ms'][1]:.4f} ms, plain "
        f"{t['plain_ms'][0]:.4f}/{t['plain_ms'][1]:.4f} ms, cuDNN wgrad "
        f"{t['library_ms']:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}); "
        f"kernel at {t['tflops']:.2f} TFLOP/s")
    return out


def check_finite(phase, metrics, keys=("loss", "pose_loss", "kd_loss")):
    vals = {k: float(metrics[k]) for k in keys}
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{phase}: non-finite {vals}")
    return vals


def phase_fpd_train(device, totals, label):
    """The FPD train step at full width; returns (state, step shapes of
    P4, stats for the kernels line)."""
    import torch
    from fhpe_tpu_torch.models.common import Conv3x3
    from fhpe_tpu_torch.tools.profile_serve import kernel_group
    from fhpe_tpu_torch.tools.train_parity import (STUDENT_YAML, fpd_cfgs,
                                                   train_batch)
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)
    from fhpe_tpu_torch.utils.profiling import busy_ms, device_events

    scfg, tcfg = fpd_cfgs()
    state = create_train_state(scfg, seeded_model(scfg, 0), device=device)
    teacher = seeded_model(tcfg, 100).to(device)
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg))
    batch = train_batch(scfg, TRAIN_BATCH, seed=7, device=device)

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
        for m in state.model.modules() if isinstance(m, Conv3x3)]
    t0 = time.perf_counter()
    step(state, batch)      # cuDNN algorithm choice; the kernels load
    sync(device)
    for hk in hooks:
        hk.remove()
    log("train", f"first step {time.perf_counter() - t0:.2f} s (student "
        f"{STUDENT_YAML.name}, teacher {TEACHER_YAML.name}, bf16, batch "
        f"{TRAIN_BATCH}); {len(shapes)} 3x3 stride-1 convs in the student")

    losses = []

    def run():
        for _ in range(TRAIN_STEPS):
            losses.append(step(state, batch)[1])

    _, counts = main_path_run(totals, run)
    want = expected(device, conv3x3_wgrad=P4_PER_STEP * TRAIN_STEPS,
                    decode_heatmaps=K1_PER_TRAIN_STEP * TRAIN_STEPS)
    if counts != want or len(shapes) != P4_PER_STEP:
        raise AssertionError(f"train: launches {counts} for {TRAIN_STEPS} "
                             f"steps, want {want}; {len(shapes)} convs")
    first = check_finite("train", losses[0])
    last = check_finite("train", losses[-1])
    if not last["loss"] < first["loss"]:
        raise AssertionError(f"train: loss {first['loss']} -> "
                             f"{last['loss']} over {TRAIN_STEPS} steps")
    log("train", f"{TRAIN_STEPS} steps on one batch: loss {first['loss']:.6f}"
        f" -> {last['loss']:.6f} (pose {first['pose_loss']:.6f} -> "
        f"{last['pose_loss']:.6f}, kd {first['kd_loss']:.6f} -> "
        f"{last['kd_loss']:.6f}); launches per step: P4 "
        f"{counts['conv3x3_wgrad'] / TRAIN_STEPS:g}, decode "
        f"{counts['decode_heatmaps'] / TRAIN_STEPS:g}")

    rates = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, batch)
        sync(device)
        rates.append(5 * TRAIN_BATCH / (time.perf_counter() - t0))
    log("train", f"warm FPD train step {sorted(rates)[1]:.1f} images/s "
        f"(median of 3 x 5 steps, batch {TRAIN_BATCH}, bf16; teacher "
        f"forward, student forward and backward, Adam) on {label}")
    if device.type != "cuda":
        return state, shapes

    walls = []

    def profiled():
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    events = device_events(profiled)
    busy = busy_ms(events)
    groups = Counter()
    for e in events:
        groups[kernel_group(e["name"]) if e["cat"] == "kernel"
               else e["cat"]] += float(e["dur"]) / 1e3 / 3
    log("train", f"3 steps under the profiler: {walls[0]:.1f} ms, device "
        f"busy {busy:.1f} ms (idle share {1 - busy / walls[0]:.3f}); "
        f"{len(events) / 3:.1f} device ops per step; ms per step by group: "
        + ", ".join(f"{g} {v:.2f}" for g, v in groups.most_common()))
    return state, shapes


def phase_wgrad_step_shapes(device, shapes) -> None:
    """The P4 shapes recorded in one student step are the hourglass set of
    ``conv_wgrad_cases.STEP_SHAPES``; then P4 on each of the three train
    steps' sets against cuDNN wgrad on the same shapes and inputs (bf16),
    device time under the profiler, in turns."""
    from fhpe_tpu_torch.ops.conv_wgrad_cases import STEP_SHAPES
    from fhpe_tpu_torch.tools import profile_wgrad
    want = {(TRAIN_BATCH, *s[1:]): n
            for s, n in STEP_SHAPES["hourglass"].items()}
    if dict(Counter(shapes)) != want:
        raise AssertionError(f"wgrad: the student step's P4 shapes "
                             f"{dict(Counter(shapes))}, want {want}")
    if device.type != "cuda":
        return
    for name, r in profile_wgrad.time_step_sets(device).items():
        log("wgrad", f"the {r['calls']} P4 shapes of one {name} step "
            f"({r['gflop']:.1f} GFLOP): P4 {r['p4_ms'][0]:.3f}/"
            f"{r['p4_ms'][1]:.3f} ms ({r['p4_tflops']:.1f} TFLOP/s), cuDNN "
            f"wgrad {r['cudnn_ms'][0]:.3f}/{r['cudnn_ms'][1]:.3f} ms device "
            f"time; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def phase_f32_train_parity(device) -> None:
    """One float32 FPD step at full width, batch 2, from the same weights:
    on the card (TF32 off) against the same port on the CPU, and on the
    card with P4 against the card with cuDNN's filter gradient in its
    place (``tools/train_parity.py`` runs the same steps and the float64
    reference)."""
    import torch
    from fhpe_tpu_torch.tools.train_parity import (cudnn_in_p4s_place,
                                                   describe, fpd_cfgs,
                                                   one_fpd_step, step_diff,
                                                   tf32_off, train_batch)

    scfg, tcfg = fpd_cfgs("float32")
    student, teacher = seeded_model(scfg, 0), seeded_model(tcfg, 100)
    batch = train_batch(scfg, 2, seed=9, device="cpu")
    with tf32_off():
        card = one_fpd_step(scfg, tcfg, student, teacher, batch, device)
        cpu = one_fpd_step(scfg, tcfg, student, teacher, batch, "cpu")
        card_cudnn = (one_fpd_step(scfg, tcfg, student, teacher, batch,
                                   device, cudnn_in_p4s_place)
                      if device.type == "cuda" else card)
    for run in (card, cpu):
        check_finite("train-f32", run[1])

    bad = []
    for what, (a, b), (loss_tol, stats_tol, l2_tol, worst_tol, off_tol) in (
            ("card vs CPU", (card, cpu),
             (TRAIN_PARITY_LOSS_RTOL, TRAIN_PARITY_STATS_RTOL,
              TRAIN_PARITY_MOMENT_L2, TRAIN_PARITY_MOMENT_TENSOR,
              TRAIN_PARITY_PARAMS_OFF)),
            ("P4 vs cuDNN wgrad in the step", (card, card_cudnn),
             (0.0, 0.0, WGRAD_STEP_MOMENT_L2, WGRAD_STEP_MOMENT_TENSOR,
              WGRAD_STEP_PARAMS_OFF))):
        diff = step_diff(a, b)
        loss, stats, moments, off, live = diff
        if (loss > loss_tol or stats > stats_tol or off > off_tol * live
                or any(l2 > l2_tol or worst > worst_tol
                       for l2, worst in moments.values())):
            bad.append(what)
        log("train-f32", f"{what} (one FPD step, float32, TF32 off, batch "
            f"2): {describe(*diff)}")
    if bad:
        raise AssertionError(f"train-f32: beyond the bars: {bad}")


# -- HRNet training: P5 ---------------------------------------------------------

def phase_chain_kernels(device) -> dict:
    """P5e and P5t against their plain versions on every W32/W48 chain
    shape at batch 32 and on edge cases, bf16 and float32, TF32 off; two
    runs bit-equal; HMMA in the bf16 entries' SASS; then device times of
    each entry against the unfused module chain (cuDNN) on the eight
    shapes, and its plain version (``fhpe_tpu_torch/tools/
    profile_chain.py``)."""
    from fhpe_tpu_torch.ops.branch_chain_cases import W32_SHAPES, W48_SHAPES
    from fhpe_tpu_torch.tools import profile_chain as pc
    from fhpe_tpu_torch.utils.profiling import tensor_core_counts

    chk = pc.check_cases(device)
    for key, (mx, mean, stats, _) in chk["worst"].items():
        entry, name = key.split()
        log("chain", f"P5 {entry} {name} against plain on {chk['cases']} "
            f"chains: max|diff| {mx:.3g} of max|y| (bar "
            f"{pc.Y_TOL[name]:.3g}), mean|diff| {mean:.3g} (bar "
            f"{pc.Y_MEAN_TOL[name]:.3g})"
            + (f", batch stats {stats:.3g} (bar {pc.STATS_TOL[name]:.3g})"
               if entry == "train" else ""))
    log("chain", "P5 eval and train: two runs bit-equal on every case")

    out = {}
    for entry in pc.ENTRIES:
        err = max(v[3] for k, v in chk["worst"].items()
                  if k.startswith(entry))
        out[f"branch_chain_{entry}"] = {
            "max_abs_err": err, "ms": None, "plain_ms": None,
            "library_ms": None,
            **pc.chain_bound([pc.TIMED], entry == "train")}
    if device.type != "cuda":
        return out
    mma = tensor_core_counts("chain_conv3x3_bf16")
    if mma and not all(v[0] > 0 for v in mma.values()):
        raise AssertionError(f"chain: bf16 entries without HMMA: {mma}")
    log("chain", f"SASS (HMMA, HGMMA) per bf16 entry: "
        f"{list(mma.values()) or 'no cuobjdump'}")
    for k, shape in enumerate(W32_SHAPES + W48_SHAPES):
        timed = pc.time_shape(device, shape, 60 + k)
        if shape == pc.TIMED:
            for entry, t in timed.items():
                out[f"branch_chain_{entry}"].update(
                    ms=sum(t["ms"]) / 2, plain_ms=t["plain_ms"],
                    library_ms=sum(t["library_ms"]) / 2)
        log("chain", f"P5 {shape} x {pc.BLOCKS} blocks bf16, device time "
            f"per call (profiler, in turns): " + "; ".join(
                f"{entry} kernel {t['ms'][0]:.4f}/{t['ms'][1]:.4f} ms "
                f"({t['tflops']:.1f} TFLOP/s), unfused modules "
                f"{t['library_ms'][0]:.4f}/{t['library_ms'][1]:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})" for entry, t in timed.items()))
    return out


def phase_chain_grad(device) -> None:
    """BranchChainFn's gradients (BN backward, cuDNN input gradients, P4
    filter gradients) against autograd through the plain version, float32,
    TF32 off, at one W32 chain shape."""
    import torch
    from fhpe_tpu_torch.ops import branch_chain as bc
    from fhpe_tpu_torch.ops.branch_chain_cases import BLOCKS
    from fhpe_tpu_torch.tools.profile_chain import chain_tensors
    from fhpe_tpu_torch.tools.train_parity import tf32_off

    x, ws, gs, bs = chain_tensors(CHAIN_GRAD_SHAPE, BLOCKS, 7, device)
    params = [x, *ws, *gs, *bs]
    for t in params:
        t.requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(3)
    with tf32_off():
        y, _, _ = bc.BranchChainFn.apply(x, bc.BN_EPS, *ws, *gs, *bs)
        dy = torch.randn(y.shape, generator=gen, device=device)
        got = torch.autograd.grad(y, params, dy)
        ref = torch.autograd.grad(
            bc.branch_chain_train_plain(x, ws, gs, bs).y, params, dy)
    rel = [((g - r).norm() / r.norm()).item() for g, r in zip(got, ref)]
    names = ["x"] + [f"{k}{i}" for k in ("w", "gamma", "beta")
                     for i in range(2 * BLOCKS)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    log("chain-grad", f"BranchChainFn vs autograd through the plain chain "
        f"{CHAIN_GRAD_SHAPE} x {BLOCKS} blocks float32: relative L2 per "
        f"tensor max {rel[worst]:.3g} ({names[worst]}), dx {rel[0]:.3g}")
    if not rel[worst] <= CHAIN_GRAD_REL_L2:
        raise AssertionError(f"chain-grad: {names[worst]} off by "
                             f"{rel[worst]} > {CHAIN_GRAD_REL_L2}")


def fused_chains(model):
    from fhpe_tpu_torch.models.pose_hrnet import BranchChain
    return [m for m in model.modules()
            if isinstance(m, BranchChain) and m.fused]


def phase_hrnet_fpd_train(device, totals, label):
    """The FPD W48 -> W32 train step at full width (bf16, batch 32):
    launches per step, finite and falling losses, warm images/s, and a
    profile with P5 against the unfused module chains on the same shapes.
    Returns the trained state."""
    import torch
    from fhpe_tpu_torch.tools.profile_serve import kernel_group
    from fhpe_tpu_torch.tools.train_parity import (HRNET_STUDENT_YAML,
                                                   HRNET_TEACHER_YAML,
                                                   hrnet_fpd_cfgs,
                                                   pair_weights, train_batch)
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)
    from fhpe_tpu_torch.utils.dtype import autocast
    from fhpe_tpu_torch.utils.profiling import (busy_ms, device_events,
                                                device_ms)

    scfg, tcfg = hrnet_fpd_cfgs()
    t0 = time.perf_counter()
    student, teacher = pair_weights(scfg, tcfg)
    log("hrnet-train", f"He-scale W32 student and W48 teacher on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    state = create_train_state(scfg, student, device=device)
    teacher = teacher.to(device)
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg))
    batch = train_batch(scfg, TRAIN_BATCH, seed=17, device=device)
    chains = {"student": fused_chains(state.model),
              "teacher": fused_chains(teacher)}
    shapes = {k: [] for k in chains}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, k=k: shapes[k].append(tuple(inp[0].shape)))
        for k, ms in chains.items() for m in ms]
    t0 = time.perf_counter()
    step(state, batch)      # cuDNN algorithm choice; the kernels load
    sync(device)
    for hk in hooks:
        hk.remove()
    if not len(shapes["student"]) == len(shapes["teacher"]) == \
            HRNET_CHAINS:
        raise AssertionError(f"hrnet-train: chains run {shapes}")
    log("hrnet-train", f"first step {time.perf_counter() - t0:.2f} s "
        f"(student {HRNET_STUDENT_YAML.name}, teacher "
        f"{HRNET_TEACHER_YAML.name}, bf16, batch {TRAIN_BATCH}); "
        f"{HRNET_CHAINS} branch chains in each net")

    losses = []

    def run():
        for _ in range(HRNET_TRAIN_STEPS):
            losses.append(step(state, batch)[1])

    _, counts = main_path_run(totals, run)
    per_step = {"branch_chain_eval": HRNET_CHAINS,
                "branch_chain_train": HRNET_CHAINS,
                "conv3x3_wgrad": HRNET_P4_PER_STEP,
                "decode_heatmaps": K1_PER_TRAIN_STEP}
    want = expected(device, **{k: v * HRNET_TRAIN_STEPS
                               for k, v in per_step.items()})
    if counts != want:
        raise AssertionError(f"hrnet-train: launches {counts} for "
                             f"{HRNET_TRAIN_STEPS} steps, want {want}")
    first = check_finite("hrnet-train", losses[0])
    last = check_finite("hrnet-train", losses[-1])
    if not last["loss"] < first["loss"]:
        raise AssertionError(f"hrnet-train: loss {first['loss']} -> "
                             f"{last['loss']} over {HRNET_TRAIN_STEPS} "
                             f"steps")
    log("hrnet-train", f"{HRNET_TRAIN_STEPS} steps on one batch: loss "
        f"{first['loss']:.6f} -> {last['loss']:.6f} (pose "
        f"{first['pose_loss']:.6f} -> {last['pose_loss']:.6f}, kd "
        f"{first['kd_loss']:.6f} -> {last['kd_loss']:.6f}); launches per "
        f"step: " + ", ".join(f"{k} {counts[k] / HRNET_TRAIN_STEPS:g}"
                              for k in per_step if per_step[k]))

    def route(fused):
        for m in (*chains["student"], *chains["teacher"]):
            m.fused = fused

    def rate(fused):
        route(fused)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        sync(device)
        return 3 * TRAIN_BATCH / (time.perf_counter() - t0)

    # in turns with every chain unrouted (its blocks as modules: cuDNN
    # convs, BatchNorm; P4 keeps their filter gradients): what P5 costs
    # or saves end to end
    rates = {True: [], False: []}
    for fused in (True, False, False, True, True, False):
        rates[fused].append(rate(fused))
    route(True)
    log("hrnet-train", f"warm FPD W48->W32 train step "
        f"{sorted(rates[True])[1]:.1f} images/s with P5, "
        f"{sorted(rates[False])[1]:.1f} with every chain unrouted (medians "
        f"of 3 x 3 steps in turns, batch {TRAIN_BATCH}, bf16; teacher "
        f"forward, student forward and backward, Adam) on {label}")
    if device.type != "cuda":
        return state

    walls = []

    def profiled():
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    # both routes: where the step's time goes with and without P5
    for fused in (True, False):
        route(fused)
        walls.clear()
        events = device_events(profiled)
        busy = busy_ms(events)
        groups = Counter()
        for e in events:
            groups[kernel_group(e["name"]) if e["cat"] == "kernel"
                   else e["cat"]] += float(e["dur"]) / 1e3 / 2
        log("hrnet-train", f"2 steps under the profiler, "
            f"{'with P5' if fused else 'every chain unrouted'}: "
            f"{walls[0]:.1f} ms, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / walls[0]:.3f}); {len(events) / 2:.1f} device ops "
            f"per step; ms per step by group: "
            + ", ".join(f"{g} {v:.2f}" for g, v in groups.most_common()))
        if fused:
            log("hrnet-train", f"P5 device time per step: "
                f"{groups[P5_GROUP]:.3f} ms ({HRNET_CHAINS} P5e + "
                f"{HRNET_CHAINS} P5t calls)")
    route(True)

    # P5 on one step's chain calls against the same chains run as modules
    # (cuDNN), forward only, on random inputs of the step's shapes; copies
    # of the student's chains, whose running statistics move
    gen = torch.Generator(device=device).manual_seed(5)
    calls = []
    for k, train in (("teacher", False), ("student", True)):
        for m, s in zip(chains[k], shapes[k]):
            m = copy.deepcopy(m).train(train)
            x = torch.randn(s, generator=gen, device=device).relu()
            calls.append((m, x.to(torch.bfloat16)))

    def run_chains(fused):
        def fn():
            for m, x in calls:
                m.fused = fused
                with torch.no_grad(), autocast(torch.bfloat16, device):
                    m(x)
        return fn

    p1, u1, u2, p2 = (device_ms(run_chains(f), 3)
                      for f in (True, False, False, True))
    log("hrnet-train", f"one step's {len(calls)} chain forwards "
        f"({HRNET_CHAINS} W48 eval, {HRNET_CHAINS} W32 train): P5 "
        f"{p1:.3f}/{p2:.3f} ms, unfused modules "
        f"(cuDNN) {u1:.3f}/{u2:.3f} ms device time")
    return state


def phase_hrnet_f32_parity(device) -> None:
    """One float32 FPD W48 -> W32 step at full width, batch 2, from the same
    weights: on the card (TF32 off) against the same port on the CPU, and
    on the card with P5 against the card with every chain unrouted (its
    blocks as modules)."""
    from fhpe_tpu_torch.tools.train_parity import (describe, hrnet_fpd_cfgs,
                                                   one_fpd_step, pair_weights,
                                                   step_diff, tf32_off,
                                                   train_batch)

    scfg, tcfg = hrnet_fpd_cfgs("float32")
    student, teacher = pair_weights(scfg, tcfg)
    batch = train_batch(scfg, 2, seed=9, device="cpu")
    with tf32_off():
        card = one_fpd_step(scfg, tcfg, student, teacher, batch, device)
        cpu = one_fpd_step(scfg, tcfg, student, teacher, batch, "cpu")
        unrouted = (one_fpd_step(scfg, tcfg, student, teacher, batch,
                                 device, fused=False)
                    if device.type == "cuda" else card)
    for run in (card, cpu, unrouted):
        check_finite("hrnet-f32", run[1])
    bad = []
    for what, (a, b), bars in (
            ("card vs CPU", (card, cpu), HRNET_PARITY_BARS),
            ("P5 vs unrouted on the card", (card, unrouted),
             HRNET_P5_STEP_BARS)):
        diff = step_diff(a, b)
        loss, stats, moments, off, live = diff
        loss_tol, stats_tol, l2_tol, worst_tol, off_tol = bars
        if (loss > loss_tol or stats > stats_tol or off > off_tol * live
                or any(l2 > l2_tol or worst > worst_tol
                       for l2, worst in moments.values())):
            bad.append(what)
        log("hrnet-f32", f"{what} (one FPD W48->W32 step, float32, TF32 "
            f"off, batch 2): {describe(*diff)}")
    if bad:
        raise AssertionError(f"hrnet-f32: beyond the bars: {bad}")


def coco_eval_batches(cfg, gt, device):
    """Crops at the synthetic COCO people's boxes: (batches, all_boxes,
    img_paths).  Each crop is noise; its targets are the ground-truth
    keypoints mapped into it by the crop's affine; the last batch is
    padded (valid 0)."""
    import torch
    from fhpe_tpu_torch.data.coco_synthetic import gt_boxes
    from fhpe_tpu_torch.geometry.affine import (affine_transform,
                                                get_affine_transform)
    from fhpe_tpu_torch.ops.decode import make_inverse_transforms
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    boxes, paths = gt_boxes(gt, cfg.DATASET.ROOT, COCO_SET, w / h)
    kps = np.asarray([a["keypoints"] for a in gt["annotations"]]
                     ).reshape(len(boxes), -1, 3)
    n, j = kps.shape[:2]
    joints = np.zeros((n, j, 2), np.float32)
    for i in range(n):
        t = get_affine_transform(boxes[i, :2], boxes[i, 2:4], 0, [w, h])
        joints[i] = [affine_transform(p, t) for p in kps[i, :, :2]]
    vis = (kps[:, :, 2] > 0).astype(np.float32)
    inv = make_inverse_transforms(boxes[:, :2], boxes[:, 2:4],
                                  [int(v) for v in cfg.MODEL.HEATMAP_SIZE])
    rng = np.random.RandomState(8)
    b = int(cfg.TEST.BATCH_SIZE_PER_GPU)
    batches = []
    for lo in range(0, n, b):
        idx = np.arange(lo, lo + b) % n
        batch = {"image": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
                 "joints": joints[idx], "joints_vis": vis[idx],
                 "inv_trans": inv[idx],
                 "valid": (np.arange(lo, lo + b) < n).astype(np.float32)}
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()})
    return batches, boxes, paths


def phase_eval_coco(phase, cfg, model, device, out_dir, totals) -> None:
    """Validation of a trained COCO model (``cfg``: W32 or RN-50):
    make_eval_step (flip test, a padded last batch) on crops of the
    synthetic COCO set, then COCO AP through make_evaluate_fn (rescore,
    OKS-NMS on the card)."""
    import torch
    from fhpe_tpu_torch.cli.common import make_evaluate_fn
    from fhpe_tpu_torch.data import COCO_FLIP_PAIRS
    from fhpe_tpu_torch.data.coco_synthetic import (synthetic_coco_gt,
                                                    write_coco_gt)
    from fhpe_tpu_torch.geometry.flip import flip_pair_permutation
    from fhpe_tpu_torch.train import make_batch_preprocessor, make_eval_step
    from fhpe_tpu_torch.utils.dtype import compute_dtype

    cfg = cfg.clone()
    cfg.defrost()
    cfg.DATASET.ROOT = str(out_dir)
    cfg.DATASET.TEST_SET = COCO_SET
    cfg.freeze()
    gt = synthetic_coco_gt(COCO_IMAGES, seed=0)
    write_coco_gt(str(out_dir), COCO_SET, gt)
    batches, boxes, paths = coco_eval_batches(cfg, gt, device)
    step = make_eval_step(cfg, flip_pair_permutation(
        int(cfg.MODEL.NUM_JOINTS), COCO_FLIP_PAIRS),
        prepare=make_batch_preprocessor(cfg))
    step(model, batches[0])     # warm
    evaluate = make_evaluate_fn(cfg, device=device)
    people, images = len(boxes), len(set(paths))

    def run():
        outs = [step(model, b) for b in batches]
        preds = torch.cat([torch.cat([o["preds"], o["maxvals"][..., None]],
                                     -1) for o in outs])[:people]
        nv, _ = evaluate(cfg, preds.cpu().numpy(), str(out_dir), boxes,
                         paths)
        return outs, nv

    (outs, nv), counts = main_path_run(totals, run)
    n = len(batches)
    per_batch = {"branch_chain_eval": 2 * len(fused_chains(model)),
                 "decode_heatmaps": K1_PER_EVAL_BATCH,
                 **fwd_launches(model, compute_dtype(cfg, device), 2)}
    want = expected(device, pairwise_oks=images, greedy_nms_mask=images,
                    **{k: v * n for k, v in per_batch.items()})
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, want {want}")
    losses = [o["loss"].item() for o in outs]
    if len(nv) != 10 or not all(math.isfinite(v) for v in nv.values()) \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: stats {dict(nv)}, losses {losses}")
    hits = int(sum(o["hits"] for o in outs).sum())
    valids = int(sum(o["valids"] for o in outs).sum())
    log(phase, f"{n} batches of {len(batches[0]['valid'])} ({people} "
        f"people, {images} images, flip test on): launches per batch "
        + ", ".join(f"{k} {v}" for k, v in per_batch.items() if v)
        + f"; OKS/greedy {counts['pairwise_oks']}/"
        f"{counts['greedy_nms_mask']}; loss {np.mean(losses):.6f}, PCK "
        f"hits/valids {hits}/{valids}; 10 stats finite: "
        + ", ".join(f"{k} {v:.4f}" for k, v in nv.items()))


def mpii_eval_batches(cfg, gt, device):
    """Crops of the synthetic MPII people: (batches, centers, scales).
    Each crop is noise; its targets are the ground-truth joints mapped
    into it by the crop's affine; the last batch is padded (valid 0)."""
    import torch
    from fhpe_tpu_torch.geometry.affine import (affine_transform,
                                                get_affine_transform)
    from fhpe_tpu_torch.ops.decode import make_inverse_transforms
    xy = np.transpose(gt["pos_gt_src"], (2, 0, 1)) - 1.0      # (N, J, 2)
    vis = 1.0 - gt["jnt_missing"].T
    n, j, _ = xy.shape
    centers = (xy.min(1) + xy.max(1)) / 2
    scales = np.repeat((xy.max(1) - xy.min(1)).max(1, keepdims=True)
                       * 1.25 / 200.0, 2, axis=1)
    image_size = [int(v) for v in cfg.MODEL.IMAGE_SIZE]
    joints = np.zeros((n, j, 2), np.float32)
    for i in range(n):
        t = get_affine_transform(centers[i], scales[i], 0, image_size)
        joints[i] = [affine_transform(p, t) for p in xy[i]]
    inv = make_inverse_transforms(centers, scales,
                                  [int(v) for v in cfg.MODEL.HEATMAP_SIZE])
    rng = np.random.RandomState(3)
    b = int(cfg.TEST.BATCH_SIZE_PER_GPU)
    batches = []
    for lo in range(0, n, b):
        idx = np.arange(lo, lo + b) % n
        batch = {"image": rng.randint(0, 256, (b, image_size[1],
                                               image_size[0], 3)
                                      ).astype(np.uint8),
                 "joints": joints[idx], "joints_vis":
                 vis[idx].astype(np.float32), "inv_trans": inv[idx],
                 "valid": (np.arange(lo, lo + b) < n).astype(np.float32)}
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()})
    return batches


def phase_eval_mpii(model, device, out_dir, totals) -> None:
    """Validation of the trained student: make_eval_step on synthetic MPII
    crops, then PCKh through make_evaluate_fn."""
    import torch
    from fhpe_tpu_torch.cli.common import make_evaluate_fn
    from fhpe_tpu_torch.data import MPII_FLIP_PAIRS
    from fhpe_tpu_torch.data.mpii_synthetic import (preds_at_gt,
                                                    synthetic_mpii_gt,
                                                    write_mpii_gt)
    from fhpe_tpu_torch.geometry.flip import flip_pair_permutation
    from fhpe_tpu_torch.tools.train_parity import fpd_cfgs
    from fhpe_tpu_torch.train import make_batch_preprocessor, make_eval_step

    cfg, _ = fpd_cfgs()
    cfg.defrost()
    cfg.DATASET.ROOT = str(out_dir)
    cfg.freeze()
    gt = synthetic_mpii_gt(MPII_PEOPLE, seed=5)
    write_mpii_gt(str(out_dir), cfg.DATASET.TEST_SET, gt)
    batches = mpii_eval_batches(cfg, gt, device)
    step = make_eval_step(cfg, flip_pair_permutation(
        int(cfg.MODEL.NUM_JOINTS), MPII_FLIP_PAIRS),
        prepare=make_batch_preprocessor(cfg))
    step(model, batches[0])     # warm

    outs, counts = main_path_run(totals, lambda: [step(model, b)
                                                  for b in batches])
    want = expected(device, decode_heatmaps=K1_PER_EVAL_BATCH * len(batches))
    if counts != want:
        raise AssertionError(f"eval: launches {counts}, want {want}")
    preds = torch.cat([torch.cat([o["preds"], o["maxvals"][..., None]], -1)
                       for o in outs])[:MPII_PEOPLE].cpu().numpy()
    hits = sum(o["hits"] for o in outs).cpu().numpy()
    valids = sum(o["valids"] for o in outs).cpu().numpy()
    losses = [o["loss"].item() for o in outs]
    if preds.shape != (MPII_PEOPLE, 16, 3) or not np.isfinite(preds).all() \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"eval: preds {preds.shape}, losses {losses}")

    evaluate = make_evaluate_fn(cfg, device=device)
    planted, _ = evaluate(cfg, preds_at_gt(gt), str(out_dir), None, None)
    nv, perf = evaluate(cfg, preds, str(out_dir), None, None)
    if planted["Mean"] != 100.0 or not all(math.isfinite(float(v))
                                           for v in nv.values()):
        raise AssertionError(f"eval: PCKh planted {dict(planted)}, "
                             f"step's {dict(nv)}")
    log("eval", f"{len(batches)} batches of {len(batches[0]['valid'])} "
        f"({MPII_PEOPLE} people, flip test on): decode launches "
        f"{counts['decode_heatmaps']} (3 per batch), P4 0; loss "
        f"{np.mean(losses):.6f}, PCK hits/valids {int(hits.sum())}/"
        f"{int(valids.sum())}; PCKh: planted at the ground truth Mean "
        f"{planted['Mean']:.1f}, the step's preds "
        + ", ".join(f"{k} {float(v):.2f}" for k, v in nv.items()))


# -- PoseResNet-50: conv3x3_fwd ----------------------------------------------

def phase_conv_kernel(device) -> dict:
    """conv3x3_fwd against its plain version on planted cases at the RN-50
    shapes, the probes' shape, edge and wide cases, in its three modes,
    TF32 off; two runs bit-equal; HMMA in the bf16 entries' SASS; then
    device times of the kernel, its plain version and ``F.conv2d`` at the
    RN-50 and probe shapes (``fhpe_tpu_torch/tools/profile_conv.py``)."""
    import torch
    from fhpe_tpu_torch.ops.conv3x3_fwd_cases import PROBE_SHAPE, RN50_SHAPES
    from fhpe_tpu_torch.tools import profile_conv
    from fhpe_tpu_torch.utils.profiling import tensor_core_counts

    chk = profile_conv.check_cases(device)
    for mode, w in chk["modes"].items():
        log("conv", f"conv3x3_fwd {mode} against plain: max|diff| "
            f"{w['max_abs_err']:.3g} ({w['rel']:.3g} of max|y|; bar "
            f"{profile_conv.REL_TOL:g}"
            + (f" over one bf16 ulp; at most {w['beyond_ulp']:.2g} of a "
               f"case's values beyond one ulp" if mode == "bf16 -> bf16"
               else "") + ")")
    log("conv", f"conv3x3_fwd: {chk['cases']} cases within the bars, two "
        f"runs bit-equal on every one; bf16 inputs against a float64 plain "
        f"version {chk['bf16 vs float64']['kernel']:.3g} of max|y| (the "
        f"plain float32 version {chk['bf16 vs float64']['plain']:.3g})")

    worst = {key: max(chk["modes"][m]["max_abs_err"] for m in mds)
             for key, mds in (("conv3x3_fwd", ["bf16 -> bf16"]),
                              ("conv3x3_fwd_f32", ["bf16 -> f32",
                                                   "f32 -> f32"]))}
    out = {key: {"max_abs_err": worst[key], "ms": None, "plain_ms": None,
                 "library_ms": None,
                 **profile_conv.conv_bound([PROBE_SHAPE], nbytes)}
           for key, nbytes in (("conv3x3_fwd", 2), ("conv3x3_fwd_f32", 4))}
    if device.type != "cuda":
        return out
    mma = tensor_core_counts("conv3x3_fwd")
    bf16 = {k: v for k, v in mma.items() if "conv3x3_fwd_bf16" in k}
    if mma and not (bf16 and all(v[0] > 0 for v in bf16.values())):
        raise AssertionError(f"conv: bf16 entries without HMMA: {mma}")
    log("conv", f"SASS (HMMA, HGMMA) per bf16 entry: "
        f"{bf16 or 'no cuobjdump'}")
    for shape in RN50_SHAPES + [PROBE_SHAPE]:
        kinds = [("conv3x3_fwd", None)]
        if shape == PROBE_SHAPE:
            kinds.append(("conv3x3_fwd_f32", torch.float32))
        for key, dout in kinds:
            t = profile_conv.time_one(device, shape, dout)
            if shape == PROBE_SHAPE:
                out[key].update(ms=sum(t["ms"]) / 2,
                                plain_ms=sum(t["plain_ms"]) / 2,
                                library_ms=t["library_ms"])
            log("conv", f"{key} {shape} bf16 -> "
                f"{'bf16' if dout is None else 'f32'}: device time per call "
                f"(profiler) kernel {t['ms'][0]:.4f}/{t['ms'][1]:.4f} ms "
                f"({t['tflops']:.1f} TFLOP/s), plain "
                f"{t['plain_ms'][0]:.4f}/{t['plain_ms'][1]:.4f} ms, F.conv2d "
                f"(cuDNN) {t['library_ms']:.4f} ms; bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    return out


def phase_rn50_f32_serve_parity(device, totals) -> None:
    """Phase 6 on RN-50, inside a main-path window: its float32 forwards
    on the card take the float32-out kernel."""
    import torch
    cfg = serve_cfg(RN50_YAML, "float32")
    model = he_model(cfg, 300)
    _, counts = main_path_run(totals, lambda: phase_f32_parity(
        "rn50-f32-parity", cfg, model, device, seed=300))
    # merged_heatmaps and one predict_crops chunk: two flip-test forward
    # pairs on the card, one decode
    want = expected(device, decode_heatmaps=1,
                    **fwd_launches(model, torch.float32, 4))
    if counts != want:
        raise AssertionError(f"rn50-f32-parity: launches {counts}, want "
                             f"{want}")
    log("rn50-f32-parity", f"launches {counts['conv3x3_fwd_f32']} "
        f"conv3x3_fwd_f32 (float32 out), {counts['decode_heatmaps']} decode")


def phase_rn50_train(device, totals, label):
    """The RN-50 plain train step at full width (bf16, batch 32): launches
    per step, finite and falling losses, warm images/s with the route and
    without (cuDNN forwards), a profile of each, and conv3x3_fwd on one
    step's conv shapes against cuDNN's forward.  Returns the state."""
    import torch
    import torch.nn.functional as F
    from fhpe_tpu_torch.models.common import fwd_kernel_convs
    from fhpe_tpu_torch.ops.conv3x3_fwd import conv3x3_fwd
    from fhpe_tpu_torch.tools.profile_serve import kernel_group
    from fhpe_tpu_torch.tools.train_parity import rn50_cfg, train_batch
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_train_step)
    from fhpe_tpu_torch.utils.profiling import (busy_ms, device_events,
                                                device_ms)

    cfg = rn50_cfg()
    state = create_train_state(cfg, he_model(cfg, 300), device=device)
    step = make_train_step(cfg, prepare=make_batch_preprocessor(cfg))
    batch = train_batch(cfg, TRAIN_BATCH, seed=27, device=device)
    routed = fwd_kernel_convs(state.model)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
        for m in routed]
    t0 = time.perf_counter()
    step(state, batch)      # cuDNN algorithm choice; the kernels load
    sync(device)
    for hk in hooks:
        hk.remove()
    if not len(routed) == len(shapes) == RN50_ROUTED:
        raise AssertionError(f"rn50-train: {len(routed)} routed convs, "
                             f"{len(shapes)} ran")
    log("rn50-train", f"first step {time.perf_counter() - t0:.2f} s "
        f"({RN50_YAML.name}, bf16, batch {TRAIN_BATCH}); {len(routed)} "
        f"3x3 stride-1 convs on conv3x3_fwd")

    losses = []

    def run():
        for _ in range(RN50_TRAIN_STEPS):
            losses.append(step(state, batch)[1])

    _, counts = main_path_run(totals, run)
    per_step = {"conv3x3_fwd": RN50_ROUTED, "conv3x3_wgrad": RN50_ROUTED,
                "decode_heatmaps": K1_PER_TRAIN_STEP}
    want = expected(device, **{k: v * RN50_TRAIN_STEPS
                               for k, v in per_step.items()})
    if counts != want:
        raise AssertionError(f"rn50-train: launches {counts} for "
                             f"{RN50_TRAIN_STEPS} steps, want {want}")
    first = check_finite("rn50-train", losses[0], ("loss",))
    last = check_finite("rn50-train", losses[-1], ("loss",))
    if not last["loss"] < first["loss"]:
        raise AssertionError(f"rn50-train: loss {first['loss']} -> "
                             f"{last['loss']} over {RN50_TRAIN_STEPS} steps")
    log("rn50-train", f"{RN50_TRAIN_STEPS} steps on one batch: loss "
        f"{first['loss']:.6f} -> {last['loss']:.6f}; launches per step: "
        + ", ".join(f"{k} {counts[k] / RN50_TRAIN_STEPS:g}"
                    for k in per_step))

    def route(on):
        for m in routed:
            m.fwd_kernel = on

    def rate(on):
        route(on)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        sync(device)
        return 3 * TRAIN_BATCH / (time.perf_counter() - t0)

    rates = {True: [], False: []}
    for on in (True, False, False, True, True, False):
        rates[on].append(rate(on))
    route(True)
    log("rn50-train", f"warm RN-50 train step {sorted(rates[True])[1]:.1f} "
        f"images/s with conv3x3_fwd, {sorted(rates[False])[1]:.1f} with "
        f"cuDNN forwards (medians of 3 x 3 steps in turns, batch "
        f"{TRAIN_BATCH}, bf16; forward, backward, Adam) on {label}")
    if device.type != "cuda":
        return state

    walls = []

    def profiled():
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    for on in (True, False):
        route(on)
        walls.clear()
        events = device_events(profiled)
        busy = busy_ms(events)
        groups = Counter()
        for e in events:
            groups[kernel_group(e["name"]) if e["cat"] == "kernel"
                   else e["cat"]] += float(e["dur"]) / 1e3 / 2
        log("rn50-train", f"2 steps under the profiler, "
            f"{'with conv3x3_fwd' if on else 'cuDNN forwards'}: "
            f"{walls[0]:.1f} ms, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / walls[0]:.3f}); {len(events) / 2:.1f} device ops "
            f"per step; ms per step by group: "
            + ", ".join(f"{g} {v:.2f}" for g, v in groups.most_common()))
    route(True)

    # the kernel on one step's 13 conv inputs against cuDNN's forward on
    # the same shapes (random ReLU outputs, He-scale weights, bf16)
    gen = torch.Generator(device=device).manual_seed(5)
    inputs = [(torch.randn(s, generator=gen, device=device).relu()
               .to(torch.bfloat16),
               (torch.randn((s[1], s[1], 3, 3), generator=gen, device=device)
                * math.sqrt(2.0 / (9 * s[1]))).to(torch.bfloat16))
              for s in shapes]

    def kernel():
        for x, w in inputs:
            conv3x3_fwd(x, w)

    def library():
        for x, w in inputs:
            F.conv2d(x, w, padding=1)

    k1, l1, l2, k2 = (device_ms(f, 5) for f in (kernel, library, library,
                                                kernel))
    flop = sum(18 * s[1] ** 2 * s[0] * s[2] * s[3] for s in shapes)
    log("rn50-train", f"one step's {len(shapes)} conv3x3_fwd shapes "
        f"({flop / 1e9:.1f} GFLOP): kernel {k1:.3f}/{k2:.3f} ms, cuDNN "
        f"forward {l1:.3f}/{l2:.3f} ms device time; bound "
        f"{flop / BF16_OPS_PER_S * 1e3:.4f} ms at the bf16 peak")
    return state


def phase_rn50_f32_parity(device) -> None:
    """One float32 RN-50 train step at full width, batch 2, from the same
    weights: on the card (TF32 off) against the same port on the CPU, and
    on the card with the conv3x3_fwd route against the card with cuDNN's
    forwards in its place."""
    from fhpe_tpu_torch.tools.train_parity import (describe, one_train_step,
                                                   rn50_cfg, step_diff,
                                                   tf32_off, train_batch)

    cfg = rn50_cfg("float32")
    model = he_model(cfg, 300)
    batch = train_batch(cfg, 2, seed=9, device="cpu")
    with tf32_off():
        card = one_train_step(cfg, model, batch, device)
        cpu = one_train_step(cfg, model, batch, "cpu")
        unrouted = (one_train_step(cfg, model, batch, device,
                                   fwd_kernel=False)
                    if device.type == "cuda" else card)
    for run in (card, cpu, unrouted):
        check_finite("rn50-f32", run[1], ("loss",))
    bad = []
    for what, (a, b), bars in (
            ("card vs CPU", (card, cpu), HRNET_PARITY_BARS),
            ("conv3x3_fwd vs cuDNN forwards on the card", (card, unrouted),
             RN50_ROUTE_STEP_BARS)):
        diff = step_diff(a, b)
        loss, stats, moments, off, live = diff
        loss_tol, stats_tol, l2_tol, worst_tol, off_tol = bars
        if (loss > loss_tol or stats > stats_tol or off > off_tol * live
                or any(l2 > l2_tol or worst > worst_tol
                       for l2, worst in moments.values())):
            bad.append(what)
        log("rn50-f32", f"{what} (one RN-50 train step, float32, TF32 off, "
            f"batch 2): {describe(*diff)}")
    if bad:
        raise AssertionError(f"rn50-f32: beyond the bars: {bad}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fhpe_tpu_torch.data.coco_synthetic import (synthetic_coco_gt,
                                                    write_coco_gt)
    from fhpe_tpu_torch.ops import _build
    from fhpe_tpu_torch.tools.train_parity import hrnet_fpd_cfgs, rn50_cfg
    from fhpe_tpu_torch.utils.profiling import card_label

    device = torch.device("cuda", 0)
    label = card_label()
    log("device", f"{label} ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log("build", f"{lib_path.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")

    stats = {"decode_heatmaps": phase_kernel_vs_plain(device),
             **phase_nms_kernels(device),
             "conv3x3_wgrad": phase_wgrad_kernel(device),
             **phase_chain_kernels(device),
             **phase_conv_kernel(device)}
    phase_chain_grad(device)
    totals = Counter()

    student = serve_cfg(STUDENT_YAML)
    phase_serve("student", student, seeded_model(student, 0), device,
                [1, 32, 45], seed=0, totals=totals, label=label)
    f32 = serve_cfg(STUDENT_YAML, "float32")
    phase_f32_parity("f32-parity", f32, seeded_model(f32, 0), device, seed=0)
    teacher = serve_cfg(TEACHER_YAML)
    phase_serve("teacher", teacher, seeded_model(teacher, 100), device, [32],
                seed=100, totals=totals)

    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root = Path(tmp)
        gt = synthetic_coco_gt(COCO_IMAGES, seed=0)
        write_coco_gt(str(root), COCO_SET, gt)
        w32 = serve_cfg(W32_YAML, root=root)
        p = phase_serve("w32", w32, he_model(w32, 200), device, [1, 32, 45],
                        seed=200, totals=totals, label=label)
        w32_f32 = serve_cfg(W32_YAML, "float32")
        phase_f32_parity("w32-f32-parity", w32_f32, he_model(w32_f32, 200),
                         device, seed=200)
        phase_coco_planted(w32, gt, device, root, totals)
        phase_coco_predictor(p, w32, gt, device, root, totals)

    state, shapes = phase_fpd_train(device, totals, label)
    phase_wgrad_step_shapes(device, shapes)
    phase_f32_train_parity(device)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_eval_mpii(state.model, device, Path(tmp), totals)

    state = phase_hrnet_fpd_train(device, totals, label)
    phase_hrnet_f32_parity(device)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_eval_coco("coco-eval", hrnet_fpd_cfgs()[0], state.model,
                        device, Path(tmp), totals)

    rn50 = serve_cfg(RN50_YAML)
    phase_serve("rn50", rn50, he_model(rn50, 300), device, [1, 32, 45],
                seed=300, totals=totals, label=label)
    phase_rn50_f32_serve_parity(device, totals)
    state = phase_rn50_train(device, totals, label)
    phase_rn50_f32_parity(device)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_eval_coco("rn50-eval", rn50_cfg(), state.model, device,
                        Path(tmp), totals)

    for name in KERNELS:
        if totals[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": totals[name], "max_abs_err": s["max_abs_err"],
         "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": s["bound_by"], "library_ms": s.get("library_ms")}
        for name, s in stats.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
