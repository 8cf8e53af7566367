#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fhpe_tpu_torch``) on one GPU.

Drives the port's paths end to end, through the entry points a
user calls, with random weights from a seed.  On the card those entry
points replay captured CUDA graphs (``utils/graph.py``): the Predictor,
``make_eval_step``, the train steps the CLIs and phase 14b run; phases
12, 17 and 22 time the steps' eager bodies (``step.eager``), and phase 27
holds each captured step against its body:

* serving the FPD hourglass (MPII 256x256, 16 joints): the student
  (4 stacks x 128 features) and the teacher (8 x 256) at full width,
  ``Predictor.warmup`` / ``Predictor.predict_crops``;
* the COCO path of the FPD student HRNet-W32 (256x192, 17 joints, bf16,
  batch 32, flip test on): ``Predictor.predict_crops`` ->
  ``cli.common.make_evaluate_fn`` (rescore, OKS-NMS on the card in one
  launch of the segmented OKS-NMS kernel, results JSON, COCO AP); from
  full frames, ``Predictor.predict(image, boxes)``; over two replicas
  (the machine has one GPU, so both on it); and from a ``.msgpack`` in
  ``fhpe_tpu``'s ``final_state`` layout through
  ``Predictor.from_checkpoint``;
* FPD training of the hourglass student by the teacher (bf16, batch 32,
  Adam): ``train.create_train_state`` -> ``make_batch_preprocessor`` ->
  ``make_fpd_train_step`` (the 3x3 filter gradients through the P4
  kernel, the PCK argmaxes through the decode kernel), then validation:
  ``make_eval_step`` -> ``make_evaluate_fn`` (MPII PCKh); then both fed by
  the port's host data path: ``data.make_synthetic_mpii`` writes JPEGs
  through the image library, ``cli.common.build_loaders`` ->
  ``BatchLoader`` decodes, augments and warps them, ``device_batch``
  uploads; and with ``TPU.DEVICE_WARP``, letterbox canvases that the
  step warps on the card;
* FPD training of HRNet-W32 (``w32_fpd_student.yaml``) by W48
  (``w48_256x192_teacher.yaml``, eval mode) on COCO-shaped batches (bf16,
  batch 32, Adam lr 1e-3), the same entry points: every branch chain
  through P5 (the teacher's and the eval step's in eval mode, the
  student's in train mode, its backward through P4), then validation:
  ``make_eval_step`` -> ``make_evaluate_fn`` (COCO AP);
* the command-line entry points a user runs, in this process through
  their ``main(argv)``: ``cli.fpd_train`` on the hourglass pair (2
  epochs, a resume to a third, checkpoints) and ``cli.train`` on
  PoseResNet-50 COCO (one epoch to AP), each followed by ``cli.test``
  on its ``final_state.pth``; and ``cli.fpd_train`` on the HRNet pair
  with the debug images and the model summary, then ``cli.test``;
* data-parallel training, one process per GPU: the hourglass FPD step in
  a NCCL process group (``parallel.initialize``) with its collectives
  inside the captured graph, and ``torchrun --nproc_per_node 1 -m
  fhpe_tpu_torch.cli.fpd_train`` with a resume (the machine has one GPU,
  so the world size is 1);
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
   process per source, all started together, and beside them the host
   image library ``fhpe_tpu_torch/ops/cpp`` with g++ (its JPEG route,
   ``libjpeg`` or ``nvjpeg``, is printed);
3. decode kernel against its plain PyTorch version on planted edge cases
   (bit-equal), then the device time of both from a profiler trace;
4. NMS kernels against their plain versions on planted cases (equal
   scores, all padding but one, nothing valid, duplicate clusters) at
   N = 128, 256, 1152: the OKS matrix (K2) within rtol 1e-5 / atol 1e-6,
   the greedy keep mask bit-equal (N = 1152 on the scratch path), the
   segmented OKS-NMS kernel on each case's valid rows bit-equal to K2 ->
   greedy on the card and to its plain version, and on one ragged pack
   (every planted image, empty images, NaN and -inf scores, images above
   the shared-memory cap) and on one of 5 joints; then device times at N = 128 (K2, greedy, the
   two together, the segmented kernel on the same image and on one of 128
   detections) and of the segmented kernel on 64 images of a COCO-sized
   set, against its plain version; then (4b) that set at COCO val2017's
   scale, 5,000 images: keep-lists against the host float64 ``oks_nms``,
   the kernel's device time and bound, the drop-in's host time per image
   split into pack, copy, kernel and lists, the host ``oks_nms`` per
   image, the idle share;
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
    the segmented OKS-NMS kernel ran once for the set (no K2 or greedy
    launch); the NMS time per image, batched and one image at a time;
    (b) the W32 Predictor's own outputs on crops at the ground truth
    boxes: decode launches == chunks, one segmented NMS launch, the 10
    stats finite;
11. P4 (3x3 filter gradient) kernel against its plain version on every
    shape of the three train steps' P4 sets at batch 32, edge and wide
    cases, bf16 and float32, planted inputs: within the bars of
    ``tools/profile_wgrad.py``, two runs bit-equal; tensor-core
    instructions in the bf16 entries' SASS; then the device time of the
    kernel, its plain version and cuDNN's weight gradient
    (``aten.convolution_backward``, timed, never used);
12. the FPD train step's eager body at full width (bf16, batch 32,
    DEAD_BIAS_SKIP as bench.py trains): P4 launches == 59 and decode
    launches == 2 per
    step, finite losses, the loss falling over 10 steps on one batch,
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
14b. the host data path: the image library's route and its JPEG round
    trip (max and mean difference from the pixels encoded, host ms per
    encode and decode); ``write_mpii_sets`` writes 64 train and 56
    validation JPEGs at 256x256 under one ``DATASET.ROOT`` (phase 25
    reads them again); the train loader alone (images/s per epoch,
    ``WORKERS`` threads, nproc); 4 FPD steps fed by ``BatchLoader``
    batches (P4 59 and decode 2 launches per step, finite losses); the
    validation loader through ``cli.common.validate`` (flip test, a padded
    last batch, 3 decode launches per batch) to PCKh (finite); then one
    batch's upload and its copy into the graph's inputs, and the captured
    step's images/s and idle share fed by the loader against the same
    step on one batch already on the device, in turns;
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
17. the FPD W48 -> W32 train step's eager body at full width (bf16,
    batch 32): per
    step 26 P5e, 26 P5t, 212 P4 and 2 decode launches, finite losses
    falling over 5 steps on one batch, warm train images/s with P5 and
    with every chain unrouted, a profile of each (idle share, device ops
    per step, kernel ms by group, P5's device ms per step) and one step's
    52 chain forwards on P5 against the unfused modules;
18. float32 FPD W48 -> W32 step parity (TF32 off, batch 2): card against
    CPU at phase 13's bars, card with P5 against card with every chain
    unrouted at the bars of ``HRNET_P5_STEP_BARS``;
19. validation of the trained W32: ``make_eval_step`` (flip test, a padded
    last batch) on crops of phase 10's synthetic COCO set, then COCO AP
    through ``make_evaluate_fn``: 52 P5e and 3 decode launches per batch,
    one segmented OKS-NMS launch per evaluated set, 10 finite stats;
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
22. the RN-50 plain train step's eager body at full width (bf16, batch
    32, Adam lr 1e-3): per step 13 conv3x3_fwd, 13 P4 and 2 decode
    launches, finite
    losses falling over 5 steps on one batch, warm train images/s in
    turns with the route off (cuDNN forwards), a profile of each route,
    and the kernel on one step's 13 conv shapes against cuDNN's forward;
23. float32 RN-50 step parity (TF32 off, batch 2): card against CPU at
    phase 13's bars, card with the route against card without it at the
    bars of ``RN50_ROUTE_STEP_BARS``;
24. validation of the trained RN-50 as phase 19: 26 conv3x3_fwd and 3
    decode launches per batch, one segmented OKS-NMS launch per evaluated
    set, 10 finite stats;
25. the FPD CLI (``cli.fpd_train.main``, in this process): phase 12's
    hourglass pair at full width (bf16, batch 32), the teacher from a
    seeded ``.pth`` as ``KD.TEACHER``, over phase 14b's synthetic MPII
    JPEGs in one ``DATASET.ROOT``: both pre-training validations, 2
    epochs of 2 steps, a validation after each, ``checkpoint.pth``,
    ``model_best.pth`` and ``final_state.pth``; P4 59 and decode 2
    launches per step, decode 3 per eval batch; then a rerun to
    ``END_EPOCH`` 3 resumes from epoch 2 (logged) and trains one epoch,
    its Adam steps going on from 4; then ``cli.test.main`` on its
    ``final_state.pth`` gives the last validation's predictions and PCKh
    Mean exactly; each run's epoch wall time (start-up included: 2 steps
    per epoch), logged ``Speed`` and validation samples/s;
26. the train CLI (``cli.train.main``) on PoseResNet-50 COCO
    (``DEBUG.DEBUG False``, bf16, batch 32, a ``MODEL.PRETRAINED`` that
    is not there: its warning is logged) over synthetic COCO JPEGs
    (``make_synthetic_coco``, 64 train, 64 validation images): one epoch
    to COCO AP with conv3x3_fwd 13 per step and 26 per eval batch, P4 13
    per step, one segmented OKS-NMS launch per evaluated set; then
    ``cli.test.main`` on ``final_state.pth`` gives the same predictions
    and AP;
27. the captured steps against their eager bodies (full width and
    depth, bf16, batch 32, seeded weights): the hourglass FPD step, MPII
    eval of the hourglass student, the W48 -> W32 FPD step, W32 serving
    and the RN-50 plain step.  Launches per replay as per eager call;
    eval and serve replays bit-equal to the body; the train steps after
    5 steps from one state bit-equal wherever the body is bit-equal to a
    second run of itself, elsewhere within ``GRAPH_SPREAD_FACTOR`` of
    that run's distance (both printed); ``set_lr(0)`` then one replay
    leaves every parameter; capturable against torch's default Adam over
    one eager step; images/s of both in turns; one profiled replay and
    one eager call (device ops the host launched, kernels, kernel ms,
    idle share);
28. full-frame serving, ``Predictor.predict(image, boxes)``, W32 as in
    phase 8 (bf16, batch 32, flip test): 8 synthetic 720x1280 frames of 12
    person boxes each, some across the borders, then a frame with none,
    (0, 17, 3); per chunk 1 decode and 52 P5e launches; each frame's
    keypoints bit-equal to ``predict_crops`` of ``Predictor.crop``'s crops
    and to a serial yardstick (a copy of the loop ``predict_crops`` ran
    before its pipeline), and all the crops in one request (3 chunks)
    bit-equal to the yardstick; then persons/s of ``predict``, the
    pipelined ``predict_crops``, the yardstick and the step alone on
    resident chunks, in turns, host ms per crop, and the idle share of one
    profiled ``predict_crops`` and yardstick call;
29. ``TPU.DEVICE_WARP``: phase 14b's hourglass pair fed letterbox canvases
    (512x512) of 64 synthetic 480x640 MPII JPEGs, ``build_loaders`` ->
    ``BatchLoader`` -> ``device_batch`` -> the captured FPD step (a graph
    of its own for the canvas batch): 6 steps, then 6 on one batch, P4
    59 and decode 2 per step, finite losses, falling on the one batch
    (phase 12's check); one batch's crops warped on the card
    against the CPU ``warp_affine`` of the same canvases
    (``CANVAS_WARP_ATOL``) and against the host-warped crops of the same
    augmentation draws (mean and median bars of
    ``tests/test_device_warp.py``); then, in turns with the host-warp feed
    of the same files: the loader alone, the step fed by it, its idle
    share, the upload's host ms and MB per batch;
30. data-parallel training at world size 1 (the machine's one GPU):
    (a) phase 12's hourglass FPD pair (bf16, batch 32, Adam) in a NCCL
    process group joined by ``parallel.initialize`` (a loopback
    ``MASTER_PORT``): 3 captured distributed steps bit-equal to 3
    captured single-device steps from the same state and batches, and to
    the distributed eager body (parameters, BN buffers, Adam's moments
    and steps, each step's metrics); P4 59 and decode 2 launches per
    step; the collectives the body issues (3 all-reduces, 1 broadcast),
    the NCCL version, one profiled replay of each graph (kernels, NCCL's
    kernels and their time, copies; NCCL's average kernel must be in the
    distributed replay), images/s of both graphs in turns; the group is
    destroyed after; (b) ``torchrun --standalone --nproc_per_node 1 -m
    fhpe_tpu_torch.cli.fpd_train`` on phase 25's settings over phase
    14b's synthetic MPII JPEGs (written again): 2 epochs of 2 steps, its
    log naming world size 1 and backend ``nccl``, then a second launch
    resumes to a third epoch (checkpoint and Adam at step 6), then
    ``cli.test.main`` in this process on its ``final_state.pth`` gives the
    last validation's predictions (its ``pred.mat``) and PCKh Mean
    exactly; each launch's wall time and where it went;
31. the rest of serving, W32 as in phase 8 (bf16, batch 32 per replica,
    flip test): (a) a Predictor on ``[cuda:0, cuda:0]`` (two replicas,
    global batch 64) and one on ``cuda:0`` serve 45 crops
    (``predict_crops``) and a 12-box 720p frame (``predict``) bit-equal,
    per chunk and replica 1 decode and 52 P5e launches, the decode kernel
    against its plain version on replica 1's merged heatmaps, persons/s
    of both in turns over 512 crops and the host µs of the storage
    fingerprint each replica's step takes per chunk; (b) the W32 weights
    written by ``convert.variables_from_state_dict`` and
    ``utils/msgpack.packb`` in ``fhpe_tpu``'s ``final_state`` layout:
    ``Predictor.from_checkpoint`` on that file serves keypoints bit-equal
    to the Predictor built from the state_dict (the file's MB and
    ``load_model_weights``' time printed);
32. HRNet FPD through the CLIs with ``DEBUG.DEBUG`` on: ``cli.fpd_train``
    on ``w32_fpd_student.yaml`` by ``w48_256x192_teacher.yaml`` (a ``.pth``
    of phase 17's He-scale teacher as ``KD.TEACHER``) over phase 26's
    synthetic COCO JPEGs (bf16, batch 32, one epoch of 2 steps,
    ``PRINT_FREQ`` 1, every ``DEBUG.SAVE_*`` flag on): launches as
    reckoned (per step 26 P5e, 26 P5t, 212 P4, 2 decode; per validation
    batch 52 P5e and 3 decode; one segmented OKS-NMS per validation, 3
    validations); every ``train_0_{i}_*`` and ``val_{i}_*`` dump decodes
    through the image library at its grid's shape; the TensorBoard events
    hold the grids; the Student and Teacher summaries' parameters equal
    the CLI's models' and their FLOPs are there (the count's seconds
    printed); then ``cli.test`` on its ``final_state.pth`` with ``DEBUG``
    on gives the same predictions and AP and writes its ``val_{i}`` dumps
    again; last, the W48 -> W32 FPD step captured with ``debug_outputs``
    against the step captured without, from copies of one state on one
    batch: equal launches, losses and parameters bit-equal where two plain
    runs are (elsewhere within phase 27's spread);
33. the stall watchdog and AUTO_RESUME on phase 25's pair and settings
    over phase 14b's synthetic MPII JPEGs (written again): (a) ``torchrun
    --standalone --nproc_per_node 1 --max-restarts 1`` runs a worker script
    that this script writes under ``build/``, which runs ``cli.fpd_train`` (2
    epochs of 2 steps, ``AUTO_RESUME``, a pinned ``FHPE_RUN_TAG``,
    ``TPU.STALL_TIMEOUT_S 10``); in attempt 0 it enqueues a 45 s device
    spin (``torch.cuda._sleep``) on the step's stream after epoch 1's
    first step: attempt 0 exits 86 within timeout + poll + callback budget
    of its last beat, its log has the ``STALL WATCHDOG`` line, its stderr
    the thread dump with the main thread in a CUDA wait; attempt 1 finds
    epoch 1's ``checkpoint.pth`` whole, logs ``auto-resumed from epoch 1``
    with that checkpoint's parameter sum, trains epoch 1 and writes
    ``final_state.pth``; ``cli.test`` in this process reproduces its last
    validation; the seconds from the last beat to the exit, from the exit
    to the card answering attempt 1, and the restart's wall time; (b) that
    epoch-1 state written by ``convert.checkpoint_tree_from_state`` and
    ``utils/msgpack.packb`` as ``fhpe_tpu``'s ``checkpoint.msgpack`` (the
    weights, BN statistics, Adam's moments and count, epoch 1, perf):
    AUTO_RESUME restores it bit-equal (float32), ``cli.fpd_train``
    resumes from it in this process, trains epoch 1 and writes
    ``checkpoint.pth`` beside it, which a second resume reads.

Phases 15, 20, 4b and 16 run right after 11, in that order; W32 serving
(phases 8 and 10) also counts 52 P5e launches per chunk.

Each path runs with the launch counts set to 0 just before it and read
just after; comparisons of a kernel with its plain version run outside
those windows.  Then one JSON line with the kernels, and last the
``{"ok": true, ...}`` line.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import json
import logging
import math
import os
import re
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
START = time.perf_counter()
STUDENT_YAML = REPO / "experiments/mpii/hourglass/hg4_128_student.yaml"
TEACHER_YAML = REPO / "experiments/mpii/hourglass/hg8_256x256_teacher.yaml"
W32_YAML = REPO / "experiments/coco/hrnet/w32_256x192_adam_lr1e-3.yaml"
DECODE_SHAPES = [(32, 16, 64, 64), (32, 17, 64, 48), (3, 5, 7, 9),
                 (1, 1, 1, 1)]
TIMED_SHAPE = (32, 16, 64, 64)
NMS_SIZES = (128, 256, 1152)
NMS_TIMED_N = 128          # every image of the COCO path pads to 128
NMS_THRESH = 0.9           # TEST.OKS_THRE of the W32 config
NMS_SCALE_IMAGES = 5000    # COCO val2017's image count, ~20 detections each
NMS_HOST_IMAGES = 500      # of them timed through the host float64 oks_nms
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
TRAIN_STEPS = 10           # on one repeated batch: the loss must fall
P4_PER_STEP = 59           # 3x3 stride-1 convs of the student (tests pin it)
K1_PER_TRAIN_STEP = 2      # the PCK counts' argmaxes: output and target
K1_PER_EVAL_BATCH = 3      # the decode and the two PCK argmaxes
MPII_PEOPLE = 56           # two eval batches of 32, the last one padded
# phase 14b, the FPD step and MPII validation fed by the port's BatchLoader
# from JPEGs its synthetic writer put on disk (256x256, the model's input)
LOADER_TRAIN_IMAGES = 64   # two train batches of 32 per epoch
LOADER_EPOCHS = 2          # 4 train steps on the main path
LOADER_TIMED_EPOCHS = 2    # per timing: 4 steps, or 2 epochs of the loader
LOADER_ROUND_TRIP_IMAGES = 16
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
HRNET_TRAIN_STEPS = 5      # on one repeated batch: the loss must fall
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
RN50_TRAIN_STEPS = 5       # on one repeated batch: the loss must fall
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

# phases 25-26, the port's CLIs through main(argv), in this process: the
# run dirs end in CLI_RUN_TAG (FHPE_RUN_TAG), so a rerun resumes.  Each
# train set is 64 JPEGs (two steps of 32 per epoch); the MPII validation
# set is phase 14b's 56 people (two eval batches, the last padded), the
# COCO one 64 images of one person each.
CLI_RUN_TAG = "chip_smoke"
CLI_FPD_EPOCHS = 2         # then a resume to a third
CLI_COCO_VALID = 64

# phase 27, each captured step against its eager body from one state:
# after GRAPH_CHECK_STEPS steps the graph must be bit-equal to eager
# wherever eager is bit-equal to a second eager run, and elsewhere within
# GRAPH_SPREAD_FACTOR times that run's relative L2 distance (the two
# distances are draws of one spread: the same kernels on the same data,
# apart from the order of atomic sums); timings of GRAPH_TIMED_STEPS steps.
GRAPH_CHECK_STEPS = 5
GRAPH_SPREAD_FACTOR = 3.0
GRAPH_TIMED_STEPS = 5

# phase 28, full-frame serving: W32 (phase 8's config and weights) on
# synthetic 720p frames of 12 person boxes each (one chunk of 32 per
# frame, padded), then one frame without boxes; the timings also run 8
# chunks of crops through predict_crops, the serial yardstick and the
# step alone
FRAME_HW = (720, 1280)
FRAMES = 8
BOXES_PER_FRAME = 12
FRAME_TIMED_CHUNKS = 8

# phase 29, the canvas-fed FPD step: phase 14b's hourglass pair over 64
# synthetic MPII training JPEGs at 480x640, wider than the 512x512 canvas,
# so the letterbox resize shrinks as it does for real MPII frames
CANVAS_IMAGE_HW = (480, 640)
CANVAS_SIZE = (512, 512)
CANVAS_EPOCHS = 3          # 6 loader-fed steps on the main path
CANVAS_REPEATS = 6         # then steps on one batch: the loss must fall
# the crops the card warps from one batch's canvases against the CPU's
# warp_affine of the same canvases: float32, the same operations in the
# same order (a floor that differed would move a pixel by a whole tap)
CANVAS_WARP_ATOL = 1e-3
# against the host-warped crops of the same augmentation draws: one more
# bilinear resample (the bars of tests/test_device_warp.py:56-58)
HOST_WARP_MEAN, HOST_WARP_MEDIAN = 6.0, 3.0

# phase 30: the data-parallel FPD step and CLI, one process per device (the
# card's machine has one GPU: world size 1)
DDP_STEPS = 3
DDP_CLI_EPOCHS = 2         # then a resume to a third
DDP_CLI_TIMEOUT_S = 300    # per torchrun launch
DDP_RUN_TAG = "chip_smoke_ddp"

# phase 31, the rest of serving: W32 (phase 8's config and weights) on two
# replicas that share the machine's one GPU against one replica, on 45 crops
# (one chunk of the global batch 64, two of 32) and one frame of 12 boxes;
# then from a .msgpack of fhpe_tpu's final_state layout
REPLICA_CROPS = 45
REPLICA_TIMED_CROPS = 512  # per rate: 8 chunks of 64, 16 of 32
FINGERPRINT_CALLS = 200

# phase 32, HRNet FPD through the CLIs with the debug images and the model
# summary: W32 by W48 (phases 17-19's pair, the teacher from a .pth of
# their He-scale weights) over phase 26's synthetic COCO JPEGs, one epoch
# of two steps, PRINT_FREQ 1, every DEBUG.* flag on; then cli.test on its
# final_state.pth, DEBUG on too
DEBUG_OPTS = ["DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
              "DEBUG.SAVE_BATCH_IMAGES_PRED", "True",
              "DEBUG.SAVE_HEATMAPS_GT", "True", "DEBUG.SAVE_HEATMAPS_PRED",
              "True"]
DUMPS = ("gt", "pred", "hm_gt", "hm_pred")
SUMMARY_LINE = re.compile(r"Forward GFLOPs \(batch=1, FlopCounterMode on a "
                          r"CPU copy, ([\d.]+) s\): ([\d.]+)")

# phase 33, the stall watchdog and AUTO_RESUME: phase 25's pair and
# settings under torchrun --max-restarts 1 with TPU.STALL_TIMEOUT_S; attempt
# 0 gets a device spin of STALL_SPIN_S seconds in epoch 1; then the
# epoch-1 checkpoint written as fhpe_tpu's checkpoint.msgpack and resumed
STALL_TIMEOUT_S = 10
STALL_SPIN_S = 45.0
STALL_RUN_TAG = "chip_smoke_stall"
STALL_LAUNCH_TIMEOUT_S = 300
# where a stalled host may wait on the card: a window read, the upload of
# the next batch, the epoch's synchronize
CUDA_WAITS = ("drain", "device_batch", "synchronize")

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
    # K2 and the greedy selection in one launch per evaluated set; their
    # standalone kernels (pairwise_oks, greedy_nms_mask) are off the main
    # path and held to their plain versions in phase 4
    "oks_nms_segments": {"source": "fhpe_tpu_torch/ops/csrc/nms.cu",
                         "replaces": "fhpe_tpu/ops/nms_jax.py:75",
                         "replaces_also": "fhpe_tpu/ops/nms_jax.py:126"},
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
    """One line of a phase, stamped with the seconds since the start."""
    print(f"[{phase} {time.perf_counter() - START:.1f}s] {msg}", flush=True)


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
    from fhpe_tpu_torch.utils.graph import launch_counters
    return launch_counters()


def expected(device, **launches) -> dict:
    """The counts a main-path run should read: ``launches`` of the kernels
    named, 0 of every other counted one (all 0 on the CPU, see
    :func:`on_card`)."""
    return {name: on_card(device, launches.get(name, 0))
            for name in _counters()}


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


_CPU_WEIGHTS = {}


def once(key, build):
    """A copy of ``build()``, built on the first call for ``key``: He-scale
    weights take seconds on the CPU, and several phases use the same."""
    if key not in _CPU_WEIGHTS:
        _CPU_WEIGHTS[key] = build()
    return copy.deepcopy(_CPU_WEIGHTS[key])


def he_model(cfg, seed: int):
    """He-scale weights with BN statistics from one batch, on the CPU
    (``models.common.he_scale_weights``): the reference init would give
    HRNet heatmaps of ~0 that decode to (0, 0)."""
    from fhpe_tpu_torch.models import get_pose_net
    from fhpe_tpu_torch.models.common import he_scale_weights

    def build():
        model = get_pose_net(cfg)
        w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
        he_scale_weights(model, seed, (h, w))
        return model
    return once((str(cfg.MODEL), seed), build)


def hrnet_pair(scfg, tcfg):
    """``train_parity.pair_weights`` of the HRNet FPD pair, built once."""
    from fhpe_tpu_torch.tools.train_parity import pair_weights
    return once((str(scfg.MODEL), str(tcfg.MODEL)),
                lambda: pair_weights(scfg, tcfg))


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


def _segment_pack(images, device):
    """[(name, xs, ys, areas, scores)] numpy images -> the CSR pack on
    ``device`` (xs, ys, areas, scores, int32 offsets) and the offsets."""
    import torch
    offsets = np.concatenate([[0], np.cumsum([len(im[4]) for im in images])])
    pack = [torch.from_numpy(np.concatenate([im[k] for im in images])
                             ).to(device) for k in range(1, 5)]
    pack.append(torch.from_numpy(offsets.astype(np.int32)).to(device))
    return pack, offsets


def nms_pairs(sizes) -> int:
    """The OKS values a hard OKS-NMS of images of ``sizes`` detections
    needs: OKS is symmetric and a detection never suppresses itself, so
    sum n_g (n_g - 1) / 2 pairs."""
    sizes = np.asarray(sizes, np.int64)
    return int((sizes * (sizes - 1) // 2).sum())


def segment_bound(offsets, joints: int) -> dict:
    """The segmented OKS-NMS's least time: xs, ys, areas, scores and the
    offsets read once and keep written once; K2's operations per pair
    over :func:`nms_pairs`."""
    sizes = np.diff(offsets)
    t = int(sizes.sum())
    return bound(4 * (2 * t * joints + 2 * t + len(offsets)) + t,
                 nms_pairs(sizes)
                 * (OKS_OPS_PER_JOINT * joints + OKS_OPS_PER_PAIR))


def traced_nms(fn, calls: int = 5) -> str:
    """``calls`` calls of ``fn`` (the batched drop-in) under one profiler
    trace: host time per call, the device's busy time and idle share.  A
    trace of a single call has been seen to lose its kernel; one that holds
    no kernel is taken again, up to ``profiling.TRACES`` in all, then the
    share is "not measured"."""
    from fhpe_tpu_torch.utils.profiling import TRACES, busy_ms, device_events
    for _ in range(TRACES):
        walls = []

        def timed():
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)

        events = device_events(timed, calls)
        if any(e["cat"] == "kernel" for e in events):
            wall, busy = sum(walls), busy_ms(events)
            copies = sum(float(e["dur"]) for e in events
                         if e["cat"] == "gpu_memcpy") / 1e3
            return (f"{wall / calls:.3f} ms per call, device busy "
                    f"{busy / calls:.4f} ms (idle share {1 - busy / wall:.4f})"
                    f", of which memcpy {copies / calls:.4f} ms; "
                    f"{len(events) / calls:.1f} device ops per call "
                    f"({calls} calls)")
    return f"idle share not measured (no kernel in {TRACES} traces)"


def phase_nms_kernels(device) -> dict:
    """OKS kernel within tolerance, greedy and segmented kernels bit-equal
    to their plain versions and to each other on planted cases; then
    timings at N = 128 and on a COCO-sized set."""
    import torch
    from fhpe_tpu_torch.ops.nms import COCO_SIGMAS
    from fhpe_tpu_torch.ops.nms_cases import (coco_scale_groups,
                                              planted_nms_cases,
                                              ragged_nms_images)
    from fhpe_tpu_torch.ops.nms_torch import (greedy_nms_mask,
                                              greedy_nms_mask_plain,
                                              oks_nms_segments,
                                              oks_nms_segments_plain,
                                              pack_groups, packed_views,
                                              pairwise_oks,
                                              pairwise_oks_plain)
    from fhpe_tpu_torch.utils.profiling import device_ms

    oks_err, checked, images = 0.0, 0, []
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
            keeps = []
            for s in (sim, ref):
                keeps.append(greedy_nms_mask(s, scores, valid, NMS_THRESH))
                keep_ref = greedy_nms_mask_plain(s, scores, valid,
                                                 NMS_THRESH)
                if not torch.equal(keeps[-1], keep_ref):
                    raise AssertionError(f"greedy kernel != plain on {name}"
                                         f" N={n}")
            # the same image as the COCO path packs it: its valid rows
            v = arrays[4]
            image = (f"{name} N={n}", *(a[v] for a in arrays[:4]))
            (pxs, pys, pareas, pscores, poff), off = _segment_pack([image],
                                                                   device)
            seg = oks_nms_segments(pxs, pys, pareas, pscores, poff,
                                   NMS_THRESH, host_offsets=off)
            if not (torch.equal(seg, keeps[0][valid]) and torch.equal(
                    seg, oks_nms_segments_plain(pxs, pys, pareas, pscores,
                                                off, NMS_THRESH))):
                raise AssertionError(f"segmented kernel != K2 -> greedy or "
                                     f"plain on {name} N={n}")
            images.append(image)
            checked += 1
    log("nms", f"OKS kernel within rtol {OKS_RTOL} / atol {OKS_ATOL} of "
        f"plain (max|diff| {oks_err:.3g}), greedy kernel == plain "
        f"(bit-equal), segmented kernel == K2 -> greedy on the card == plain "
        f"(bit-equal) on {checked} planted cases at N = {NMS_SIZES}")

    # one ragged pack: every planted image, empty images, NaN and -inf
    # scores, images above the shared-memory cap (the scratch path)
    images += ragged_nms_images(seed=17)
    pack, off = _segment_pack(images, device)
    seg = oks_nms_segments(*pack, NMS_THRESH, host_offsets=off)
    if not torch.equal(seg, oks_nms_segments_plain(*pack[:4], off,
                                                   NMS_THRESH)):
        raise AssertionError("segmented kernel != plain on the ragged pack")
    for (name, *arrays), lo, hi in zip(images, off[:-1], off[1:]):
        xs, ys, areas, scores = (torch.from_numpy(a).to(device)
                                 for a in arrays)
        if hi > lo and not torch.equal(seg[lo:hi], greedy_nms_mask(
                pairwise_oks(xs, ys, areas), scores,
                torch.ones(hi - lo, dtype=torch.bool, device=device),
                NMS_THRESH)):
            raise AssertionError(f"segmented kernel != K2 -> greedy on "
                                 f"{name} in the ragged pack")
    sizes = np.diff(off)
    # a joint count other than COCO's 17: the kernel's generic joint loop
    sigmas = COCO_SIGMAS[:5]
    pack5, off5 = _segment_pack(ragged_nms_images(seed=19, joints=5), device)
    if not torch.equal(
            oks_nms_segments(*pack5, NMS_THRESH, sigmas, host_offsets=off5),
            oks_nms_segments_plain(*pack5[:4], off5, NMS_THRESH, sigmas)):
        raise AssertionError("segmented kernel != plain with 5 joints")
    log("nms", f"segmented kernel == plain == K2 -> greedy per image "
        f"(bit-equal) on one ragged pack of {len(images)} images "
        f"({int((sizes == 0).sum())} empty, {int((sizes > 512).sum())} above "
        f"the shared-memory cap, {int(seg.sum())} of {int(sizes.sum())} "
        f"kept); == plain on a ragged pack of 5 joints")

    _, *arrays = planted_nms_cases(NMS_TIMED_N, seed=21)[0]   # clusters
    xs, ys, areas, scores, valid = (torch.from_numpy(a).to(device)
                                    for a in arrays)
    sim = pairwise_oks(xs, ys, areas)
    kept = int(greedy_nms_mask(sim, scores, valid, NMS_THRESH).sum())
    n, j = xs.shape
    one, one_off = _segment_pack([("", *(a[arrays[4]] for a in arrays[:4]))],
                                 device)
    _, *arrays = planted_nms_cases(2 * NMS_TIMED_N, seed=21)[0]
    full, full_off = _segment_pack(
        [("", *(a[arrays[4]] for a in arrays[:4]))], device)
    # the JSON line's figures: the first COCO_IMAGES images of the
    # COCO-sized set, as one evaluated set of the main path packs them
    buf, set_off, t = pack_groups(coco_scale_groups(COCO_IMAGES, seed=41), j)
    coco64 = packed_views(torch.from_numpy(buf).to(device), t, j)
    if not torch.equal(oks_nms_segments(*coco64, NMS_THRESH,
                                        host_offsets=set_off),
                       oks_nms_segments_plain(*coco64[:4], set_off,
                                              NMS_THRESH)):
        raise AssertionError("segmented kernel != plain on the 64 images")
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
        "K2 -> greedy": (
            lambda: greedy_nms_mask(pairwise_oks(xs, ys, areas), scores,
                                    valid, NMS_THRESH),
            # the inputs of the padded image; the OKS of its valid pairs
            None, bound(4 * (2 * n * j + 3 * n) + n,
                        nms_pairs([int(valid.sum())])
                        * (OKS_OPS_PER_JOINT * j + OKS_OPS_PER_PAIR))),
        f"segmented, the same image ({int(valid.sum())} detections)": (
            lambda: oks_nms_segments(*one, NMS_THRESH, host_offsets=one_off),
            None, segment_bound(one_off, j)),
        f"segmented, one image of {int(np.diff(full_off)[0])} detections": (
            lambda: oks_nms_segments(*full, NMS_THRESH,
                                     host_offsets=full_off),
            None, segment_bound(full_off, j)),
        "oks_nms_segments": (
            lambda: oks_nms_segments(*coco64, NMS_THRESH,
                                     host_offsets=set_off),
            lambda: oks_nms_segments_plain(*coco64[:4], set_off, NMS_THRESH),
            segment_bound(set_off, j)),
    }
    out = {"oks_nms_segments": {"max_abs_err": 0.0, "ms": None,
                                "plain_ms": None,
                                **segment_bound(set_off, j)}}
    if device.type != "cuda":
        return out
    for name, (kernel, plain, lim) in timed.items():
        iters = 5 if name == "oks_nms_segments" else 50
        if plain is None:
            dk1, dk2 = device_ms(kernel, iters), device_ms(kernel, iters)
            dp1 = dp2 = None
        else:
            dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in
                                  (plain, kernel, kernel, plain))
        where = (f"{COCO_IMAGES} images of {np.diff(set_off).min()}-"
                 f"{np.diff(set_off).max()} ({t}) detections"
                 if name == "oks_nms_segments" else
                 f"N={n} ({int(valid.sum())} valid, {kept} kept)")
        log("nms", f"{name}, {where}: device time per call (profiler) "
            f"kernel {dk1:.4f}/{dk2:.4f} ms"
            + ("" if plain is None else
               f", plain {dp1:.4f}/{dp2:.4f} ms")
            + f"; bound {lim['bound_ms']:.6f} ms ({lim['bound_by']})")
        if name == "oks_nms_segments":
            out[name].update(ms=(dk1 + dk2) / 2, plain_ms=(dp1 + dp2) / 2)
    return out


def phase_nms_coco_scale(device) -> None:
    """The batched device OKS-NMS on a synthetic set at COCO val2017's
    scale (``NMS_SCALE_IMAGES`` images, ~20 detections each): keep-lists
    against the host float64 ``oks_nms`` on the first
    ``NMS_HOST_IMAGES``; the segmented kernel's device time and bound; the
    drop-in's host-clock time per image split into pack, copy, kernel and
    lists; the host ``oks_nms`` per image; the idle share."""
    import torch
    from fhpe_tpu_torch.data.coco_synthetic import oks_margin
    from fhpe_tpu_torch.ops.nms import oks_nms
    from fhpe_tpu_torch.ops.nms_cases import coco_scale_groups
    from fhpe_tpu_torch.ops.nms_torch import (keep_lists,
                                              oks_nms_device_batched,
                                              oks_nms_segments, pack_groups,
                                              packed_views)
    from fhpe_tpu_torch.utils.profiling import device_ms

    groups = coco_scale_groups(NMS_SCALE_IMAGES, seed=41)
    images, j = len(groups), 17
    lists = oks_nms_device_batched(groups, NMS_THRESH, device=device)
    head = groups[:NMS_HOST_IMAGES]
    t0 = time.perf_counter()
    host = [oks_nms(g, NMS_THRESH) for g in head]
    host_ms = (time.perf_counter() - t0) * 1e3 / len(head)
    checked = [i for i, g in enumerate(head)
               if oks_margin(g, NMS_THRESH) > OKS_MARGIN]
    bad = sum(lists[i] != host[i] for i in checked)
    if bad or not checked:
        raise AssertionError(f"nms-scale: device keep-lists != host oks_nms "
                             f"on {bad} of {len(checked)} images")

    parts = {k: [] for k in ("pack", "copy", "kernel", "lists", "total")}
    for _ in range(5):
        sync(device)
        t0 = time.perf_counter()
        buf, off, t = pack_groups(groups, j)
        t1 = time.perf_counter()
        dev = torch.from_numpy(buf).to(device)
        sync(device)
        t2 = time.perf_counter()
        keep = oks_nms_segments(*packed_views(dev, t, j), NMS_THRESH,
                                host_offsets=off)
        sync(device)
        t3 = time.perf_counter()
        got = keep_lists(keep.cpu().numpy(),
                         buf[2 * t * j + t:2 * t * j + 2 * t].view(
                             np.float32), off)
        t4 = time.perf_counter()
        oks_nms_device_batched(groups, NMS_THRESH, device=device)
        sync(device)
        t5 = time.perf_counter()
        for k, a, b in (("pack", t0, t1), ("copy", t1, t2),
                        ("kernel", t2, t3), ("lists", t3, t4),
                        ("total", t4, t5)):
            parts[k].append((b - a) * 1e3 / images)
    if got != lists:
        raise AssertionError("nms-scale: the split run's lists differ")
    med = {k: float(np.median(v)) for k, v in parts.items()}
    sizes = np.diff(off)
    lim = segment_bound(off, j)
    log("nms-scale", f"{images} images, {t} detections ({sizes.mean():.2f} "
        f"per image, max {sizes.max()}, {int((sizes == 0).sum())} empty), "
        f"{sum(map(len, lists))} kept; keep-lists == host float64 oks_nms on "
        f"{len(checked)} of the first {len(head)} images")
    log("nms-scale", "oks_nms_device_batched per image (host clock, median "
        f"of 5): {med['total'] * 1e3:.3f} us; split: pack "
        f"{med['pack'] * 1e3:.3f}, copy {med['copy'] * 1e3:.3f}, kernel "
        f"(launch to synchronise) {med['kernel'] * 1e3:.3f}, download + "
        f"lists {med['lists'] * 1e3:.3f} us; host float64 oks_nms "
        f"{host_ms * 1e3:.3f} us per image (first {len(head)} images)")
    if device.type != "cuda":
        return
    xs, ys, areas, scores, d_off = packed_views(dev, t, j)
    k1, k2 = (device_ms(lambda: oks_nms_segments(
        xs, ys, areas, scores, d_off, NMS_THRESH, host_offsets=off), 5)
        for _ in range(2))
    log("nms-scale", f"segmented kernel, one launch for the {images} "
        f"images: device time {k1:.4f}/{k2:.4f} ms (profiler); bound "
        f"{lim['bound_ms']:.6f} ms ({lim['bound_by']}; {nms_pairs(sizes)} "
        f"pairs, sum n (n - 1) / 2); the drop-in under the "
        f"profiler: " + traced_nms(lambda: oks_nms_device_batched(
            groups, NMS_THRESH, device=device)))


# -- serving -------------------------------------------------------------------

def check_outputs(phase, preds, maxvals, n, num_joints):
    if preds.shape != (n, num_joints, 2) or maxvals.shape != (n, num_joints):
        raise AssertionError(f"{phase}: shapes {preds.shape} "
                             f"{maxvals.shape}, expected ({n}, "
                             f"{num_joints}, 2) and ({n}, {num_joints})")
    if not (np.isfinite(preds).all() and np.isfinite(maxvals).all()):
        raise AssertionError(f"{phase}: non-finite outputs")


def check_kernel_path_on_chunk(phase, p, crops, centers, scales,
                               replica=0):
    """One chunk's merged heatmaps on one replica: kernel path == plain
    path preds."""
    import torch
    from fhpe_tpu_torch.ops.decode import (decode_heatmaps,
                                           make_inverse_transforms)
    b = p.batch_size // len(p.devices)
    dev = p.devices[replica]
    hm = p.merged_heatmaps(torch.from_numpy(crops[:b]).to(dev),
                           p.models[replica])
    inv = torch.from_numpy(make_inverse_transforms(
        centers[:b], scales[:b], p.heatmap_size))
    kp, kv = decode_heatmaps(hm, inv.to(dev), p.post_process)
    pp, pv = decode_heatmaps(hm.cpu(), inv, p.post_process)
    if not (torch.equal(kp.cpu(), pp) and torch.equal(kv.cpu(), pv)):
        raise AssertionError(f"{phase}: kernel-path preds != plain-path "
                             f"preds on one chunk's merged heatmaps")
    log(phase, f"kernel path == plain path on one chunk of {b} "
        f"(merged heatmaps {tuple(hm.shape)}"
        + (f", replica {replica} of {len(p.devices)})" if replica else ")"))


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
    # batched drop-in's place; each image's device keep-list is compared.
    batched, lists, skipped = nms_torch.oks_nms_device_batched, [], 0

    def host_nms(groups, oks_thre, sigmas=None, device="cuda"):
        nonlocal skipped
        hosts = [oks_nms(g, oks_thre, sigmas) for g in groups]
        for g, dev, host in zip(groups, batched(groups, oks_thre, sigmas,
                                                device), hosts):
            if oks_margin(g, oks_thre) > OKS_MARGIN:
                lists.append((dev, host))
            else:
                skipped += 1
        return hosts

    with mock.patch.object(nms_torch, "oks_nms_device_batched", host_nms):
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
    if counts != expected(device, oks_nms_segments=1):
        raise AssertionError(f"coco: launches {counts} for one evaluated "
                             f"set of {images} images")
    log("coco", f"planted detections: AP {nv['AP']:.4f} == host-NMS run's "
        f"(all 10 stats equal); oks_nms_segments "
        f"{counts['oks_nms_segments']} launch for {images} images, "
        f"pairwise_oks {counts['pairwise_oks']}, greedy "
        f"{counts['greedy_nms_mask']}")

    # NMS cost per image on the host clock, warm, each call ending in its
    # keep-mask download: the batched drop-in over the set, its one-image
    # case per image, and the host float64 oks_nms
    groups = rescore_and_nms(preds, boxes, paths, in_vis_thre=
                             cfg.TEST.IN_VIS_THRE, oks_thre=2.0,
                             device=device)
    per = {"batched": [], "one image": [], "host": []}
    batched(groups, thresh, device=device)
    for _ in range(5):
        t0 = time.perf_counter()
        batched(groups, thresh, device=device)
        per["batched"].append((time.perf_counter() - t0) * 1e3 / len(groups))
    for img in groups:
        for name, fn in (("one image", lambda: nms_torch.oks_nms_device(
                img, thresh, device=device)),
                         ("host", lambda: oks_nms(img, thresh))):
            t0 = time.perf_counter()
            fn()
            per[name].append((time.perf_counter() - t0) * 1e3)
    log("coco", f"NMS per image (host clock, {len(groups)} images of "
        f"{min(map(len, groups))}-{max(map(len, groups))} detections): "
        f"oks_nms_device_batched over the set {np.median(per['batched']):.4f}"
        f" ms (median of 5; one pack, upload, launch and download), "
        f"oks_nms_device per image {np.median(per['one image']):.4f} ms "
        f"(median), host float64 oks_nms {np.median(per['host']):.4f} ms "
        f"(median)")
    if device.type == "cuda":
        log("coco", f"batched NMS of all {len(groups)} images under the "
            f"profiler: " + traced_nms(lambda: batched(groups, thresh,
                                                       device=device)))


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
    if counts != expected(device, decode_heatmaps=chunks,
                          oks_nms_segments=1,
                          branch_chain_eval=chains_per_chunk(p) * chunks):
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
    # the eager body: phase 27 holds the captured step against it
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg)).eager
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
                                                   train_batch)
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)
    from fhpe_tpu_torch.utils.dtype import autocast
    from fhpe_tpu_torch.utils.profiling import (busy_ms, device_events,
                                                device_ms)

    scfg, tcfg = hrnet_fpd_cfgs()
    t0 = time.perf_counter()
    student, teacher = hrnet_pair(scfg, tcfg)
    log("hrnet-train", f"He-scale W32 student and W48 teacher on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    state = create_train_state(scfg, student, device=device)
    teacher = teacher.to(device)
    # the eager body (its routes are toggled below; phase 27 holds the
    # captured step against it)
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg)).eager
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
                                                   one_fpd_step,
                                                   step_diff, tf32_off,
                                                   train_batch)

    scfg, tcfg = hrnet_fpd_cfgs("float32")
    student, teacher = hrnet_pair(scfg, tcfg)
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
    want = expected(device, oks_nms_segments=1,
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
        + f"; oks_nms_segments {counts['oks_nms_segments']} for {images} "
        f"images, OKS/greedy {counts['pairwise_oks']}/"
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
    # one graph serves every batch, the padded last one too
    captures = step.captured.captures
    if counts != want or captures != on_card(device, 1):
        raise AssertionError(f"eval: launches {counts}, want {want}; "
                             f"{captures} captures")
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


# -- the host data path: BatchLoader feeds the FPD step and validation ---------

def loader_cfgs(root: Path):
    """The FPD configs of phase 12 (``fpd_cfgs``) on the synthetic MPII
    sets ``write_mpii_sets`` put under ``root``: train set ``train``
    (batch ``TRAIN_BATCH``), validation set ``valid``, no db cache.
    Returns (student cfg, teacher cfg)."""
    from fhpe_tpu_torch.tools.train_parity import fpd_cfgs
    scfg, tcfg = fpd_cfgs()
    scfg.defrost()
    scfg.DATASET.ROOT = str(root)
    scfg.DATASET.TRAIN_SET = "train"
    scfg.DATASET.TEST_SET = "valid"
    scfg.DATASET.CACHE_ROOT = ""
    scfg.TRAIN.BATCH_SIZE_PER_GPU = TRAIN_BATCH
    scfg.freeze()
    return scfg, tcfg


def feed_rates(feeds: dict, turns, n_img: int, device) -> dict:
    """{name: [images/s of each turn]} of ``feeds`` (each a no-argument
    run of ``n_img`` images) run in the order ``turns``, timed by the host
    clock ended by a synchronise."""
    rates = {name: [] for name in feeds}
    for name in turns:
        sync(device)
        t0 = time.perf_counter()
        feeds[name]()
        sync(device)
        rates[name].append(n_img / (time.perf_counter() - t0))
    return rates


def idle_shares(feeds: dict, device) -> dict:
    """{name: the idle share of one profiled run of the feed, as text}:
    1 - device busy time (the union of the trace's device events) / the
    run's wall time; empty off the card."""
    import torch
    from fhpe_tpu_torch.utils.profiling import busy_ms, device_events
    idle = {}
    if device.type != "cuda":
        return idle
    for name, fn in feeds.items():
        walls = []

        def timed(fn=fn, walls=walls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

        busy = busy_ms(device_events(timed))
        idle[name] = f"{1 - busy / walls[0]:.3f}"
    return idle


def upload_ms(cfg, host: dict, device, reps: int = 5):
    """``device_batch``'s upload of the host batch ``host`` (on the card
    through its pinned staging ring), each ended by a synchronise:
    (median host ms of ``reps``, MB, the device batch)."""
    from fhpe_tpu_torch.cli.common import device_batch
    walls = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        dev = device_batch(cfg, host, device)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    mb = sum(v.numel() * v.element_size() for v in dev.values()) / 1e6
    return sorted(walls)[reps // 2], mb, dev


def phase_loader(state, device, totals, label, root: Path) -> None:
    """The FPD train step and MPII validation fed by the port's own host
    data path: ``write_mpii_sets`` writes JPEGs through the image library
    under ``root`` (kept for phase 25), ``build_loaders`` ->
    ``BatchLoader`` decodes, augments and warps them in ``WORKERS``
    threads, ``device_batch`` uploads."""
    import os

    import torch
    from fhpe_tpu_torch.cli.common import (build_loaders, device_batch,
                                           make_evaluate_fn, validate)
    from fhpe_tpu_torch.ops import native_image
    from fhpe_tpu_torch.tools import jpeg_route
    from fhpe_tpu_torch.train import (make_batch_preprocessor,
                                      make_fpd_train_step)

    scfg, tcfg = loader_cfgs(root)
    w, h = (int(v) for v in scfg.MODEL.IMAGE_SIZE)
    rt = jpeg_route.round_trip(jpeg_route.draw_images(
        LOADER_ROUND_TRIP_IMAGES, w))[0]
    log("loader", f"image library route {native_image.route()}: "
        f"{LOADER_ROUND_TRIP_IMAGES} {w}x{w} images encoded at quality "
        f"95 and decoded differ from the pixels encoded by max "
        f"{rt['vs_encoded']['max_abs']}, mean "
        f"{rt['vs_encoded']['mean_abs']:.4f}; host encode "
        f"{rt['encode_ms']:.3f} ms, decode {rt['decode_ms']:.3f} ms per "
        f"image; {label}")

    t0 = time.perf_counter()
    write_mpii_sets(root, (h, w))
    write_s = time.perf_counter() - t0
    train_loader, val_loader, meta = build_loaders(scfg)
    threads = max(2, int(scfg.WORKERS))
    rates = []
    for _ in range(LOADER_TIMED_EPOCHS):
        t0 = time.perf_counter()
        n = sum(len(b["valid"]) for b in train_loader)
        rates.append(n / (time.perf_counter() - t0))
    log("loader", f"wrote {LOADER_TRAIN_IMAGES} + {MPII_PEOPLE} "
        f"{w}x{h} JPEGs in {write_s:.2f} s; the train loader alone "
        f"(decode, augment, warp, collate; {threads} threads, nproc "
        f"{os.cpu_count()}) {', '.join(f'{r:.1f}' for r in rates)} "
        f"images/s per epoch of {n} on {label}")

    teacher = seeded_model(tcfg, 100).to(device)
    step = make_fpd_train_step(scfg, teacher, tcfg,
                               prepare=make_batch_preprocessor(scfg))

    def train():
        return [step(state, device_batch(scfg, batch, device))[1]
                for _ in range(LOADER_EPOCHS) for batch in train_loader]

    losses, counts = main_path_run(totals, train)
    steps = len(losses)
    want = expected(device, conv3x3_wgrad=P4_PER_STEP * steps,
                    decode_heatmaps=K1_PER_TRAIN_STEP * steps)
    if steps < 4 or counts != want:
        raise AssertionError(f"loader: {steps} steps, launches {counts},"
                             f" want {want}")
    vals = [check_finite("loader", m) for m in losses]
    log("loader", f"{steps} FPD steps on loader batches: loss "
        + ", ".join(f"{v['loss']:.6f}" for v in vals) + "; launches "
        f"per step: P4 {counts['conv3x3_wgrad'] / steps:g}, decode "
        f"{counts['decode_heatmaps'] / steps:g}")

    evaluate_fn = make_evaluate_fn(scfg, device=device)
    (_, nv, preds, _, _), counts = main_path_run(totals, lambda: validate(
        scfg, state.model, val_loader, meta, None, evaluate_fn,
        output_dir=str(root.parent)))
    batches = len(val_loader)
    want = expected(device, decode_heatmaps=K1_PER_EVAL_BATCH * batches)
    if counts != want:
        raise AssertionError(f"loader eval: launches {counts}, want "
                             f"{want}")
    if preds.shape != (MPII_PEOPLE, 16, 3) or not np.isfinite(
            preds).all() or not all(math.isfinite(float(v))
                                    for v in nv.values()):
        raise AssertionError(f"loader eval: preds {preds.shape}, PCKh "
                             f"{dict(nv)}")
    log("loader", f"cli.common.validate through the loader: {batches} "
        f"batches of {scfg.TEST.BATCH_SIZE_PER_GPU} ({MPII_PEOPLE} people, "
        f"flip test on), decode launches {counts['decode_heatmaps']}; PCKh "
        + ", ".join(f"{k} {float(v):.2f}" for k, v in nv.items())
        + f" on {label}")

    resident = device_batch(scfg, next(iter(train_loader)), device)

    def fed_by_loader():
        for _ in range(LOADER_TIMED_EPOCHS):
            for batch in train_loader:
                step(state, device_batch(scfg, batch, device))

    def fed_resident():
        for _ in range(LOADER_TIMED_EPOCHS * len(train_loader)):
            step(state, resident)

    n_img = LOADER_TIMED_EPOCHS * len(train_loader) * TRAIN_BATCH
    feeds = {"loader": fed_by_loader, "resident": fed_resident}
    rates = feed_rates(feeds, ("loader", "resident", "resident", "loader"),
                       n_img, device)
    idle = idle_shares(feeds, device)
    # the upload device_batch makes (pinned staging, then non-blocking
    # copies, timed to their end), and the captured step's copy of it into its static inputs (device to
    # device), by CUDA events
    host = next(iter(train_loader))
    up_ms, up_mb, dev = upload_ms(scfg, host, device)
    copy_in = "not measured"
    if device.type == "cuda":
        static = {k: torch.empty_like(v) for k, v in dev.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            for k, v in dev.items():
                static[k].copy_(v, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        copy_in = f"{start.elapsed_time(end) / 20:.3f} ms"
    log("loader", f"one batch's upload (device_batch, {len(dev)} tensors, "
        f"{up_mb:.2f} MB) {up_ms:.3f} ms host (median of 5), its copy "
        f"into the graph's static inputs {copy_in} on the device")
    log("loader", "warm captured FPD step (bf16, batch "
        f"{TRAIN_BATCH}, {n_img} images per run, in turns) fed by the "
        "loader "
        + ", ".join(f"{r:.1f}" for r in rates["loader"])
        + " images/s (idle share " + idle.get("loader", "not measured")
        + "), by one batch already on the device "
        + ", ".join(f"{r:.1f}" for r in rates["resident"])
        + " images/s (idle share " + idle.get("resident", "not measured")
        + f"); nproc {os.cpu_count()}, {threads} loader threads; {label}")
    train_loader.close()
    val_loader.close()


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
    # the eager body (its route is toggled below; phase 27 holds the
    # captured step against it)
    step = make_train_step(cfg, prepare=make_batch_preprocessor(cfg)).eager
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


# -- the CLIs: FPD of the hourglass with a resume, RN-50 on COCO ----------------

class LogTap(logging.Handler):
    """The messages the CLIs log to the root logger, kept in order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def write_mpii_sets(root: Path, hw) -> None:
    """Phase 14b's synthetic MPII sets under one ``DATASET.ROOT``: 64
    train and ``MPII_PEOPLE`` validation JPEGs.  The writer names images
    by index, so the validation set is written beside and moved under
    ``images/valid/``, its annotations renamed to match."""
    from fhpe_tpu_torch.data import make_synthetic_mpii
    make_synthetic_mpii(str(root), "train", LOADER_TRAIN_IMAGES, hw, seed=0)
    side = root.parent / "mpii_valid"
    make_synthetic_mpii(str(side), "valid", MPII_PEOPLE, hw, seed=1)
    (root / "images" / "valid").mkdir()
    for f in (side / "images").iterdir():
        f.rename(root / "images" / "valid" / f.name)
    anno = json.loads((side / "annot" / "valid.json").read_text())
    for a in anno:
        a["image"] = "valid/" + a["image"]
    (root / "annot" / "valid.json").write_text(json.dumps(anno))
    (side / "annot" / "gt_valid.mat").rename(root / "annot" / "gt_valid.mat")


def cli_run(module, argv, totals, step_factory=None) -> dict:
    """``module.main(argv)`` inside a main-path window, with its
    validations and train steps counted and its log tapped.  Returns
    {"result", "counts", "vals" (each validation's return), "steps",
    "lines", "wall"}."""
    vals, steps = [], [0]
    orig_validate = module.validate

    def validate(*a, **k):
        vals.append(orig_validate(*a, **k))
        return vals[-1]

    def counted_factory(*a, **k):
        step = orig_factory(*a, **k)

        def counted(state, batch):
            steps[0] += 1
            return step(state, batch)
        return counted

    tap = LogTap()
    root_logger = logging.getLogger()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(module, "validate", validate))
        stack.enter_context(mock.patch.dict(os.environ,
                                            FHPE_RUN_TAG=CLI_RUN_TAG))
        if step_factory:
            orig_factory = getattr(module, step_factory)
            stack.enter_context(mock.patch.object(module, step_factory,
                                                  counted_factory))
        root_logger.addHandler(tap)
        stack.callback(root_logger.removeHandler, tap)
        t0 = time.perf_counter()
        result, counts = main_path_run(totals, lambda: module.main(argv))
        wall = time.perf_counter() - t0
    return {"result": result, "counts": counts, "vals": vals,
            "steps": steps[0], "lines": tap.lines, "wall": wall}


def cli_speeds(lines) -> str:
    """What a CLI's meters and epochs logged: each epoch's wall time (an
    epoch of 2 steps: the loader's start-up included, no steady rate),
    the ``Speed`` of every logged step, the validations' samples/s."""
    epochs = [m.groups() for m in (re.search(
        r"Epoch: \[(\d+)\] (\d+) steps in ([\d.]+) s", ln)
        for ln in lines) if m]
    speeds = [m.group(1) for m in (re.search(r"Speed ([\d.]+) samples/s", ln)
                                   for ln in lines) if m]
    evals = [m.group(1) for m in (re.search(
        r"overall PCK [\d.]+, ([\d.]+) samples/s", ln) for ln in lines) if m]
    parts = []
    if epochs:
        parts.append("epoch wall times, start-up included " + ", ".join(
            f"[{e}] {n} steps {t} s" for e, n, t in epochs))
    if speeds:
        parts.append(f"Speed per logged step {', '.join(speeds)} samples/s")
    parts.append(f"validation {', '.join(evals)} samples/s")
    return "; ".join(parts)


def check_cli(phase, run, want_counts, vals, steps) -> None:
    if (run["counts"], len(run["vals"]), run["steps"]) != (want_counts, vals,
                                                          steps):
        raise AssertionError(
            f"{phase}: launches {run['counts']}, {len(run['vals'])} "
            f"validations, {run['steps']} steps; want {want_counts}, {vals}, "
            f"{steps}")


def same_perf(phase, test, last) -> str:
    """The test CLI's validation against the train CLI's last one (each
    ``validate``'s return): the same weights through the same eval step
    and cuDNN's default (deterministic) forwards, so every prediction and
    the perf are equal.  The predictions carry the check: a perf of 0
    (RN-50 after one epoch from random init) would not tell the weights
    apart."""
    a, b = float(test[0]), float(last[0])
    diff = np.abs(test[2] - last[2]).max()
    if not np.array_equal(test[2], last[2]) or a != b:
        raise AssertionError(f"{phase}: test CLI perf {a}, last "
                             f"validation's {b}; predictions max |diff| "
                             f"{diff:.3g}")
    return f"equal, and all {test[2].shape[0]} people's predictions"


def phase_fpd_cli(device, totals, label, mpii: Path) -> None:
    """Phase 25: ``cli.fpd_train`` on phase 12's hourglass pair (student
    4x128, teacher 8x256 from a seeded ``.pth``, 256x256, bf16, batch 32,
    Adam) over phase 14b's synthetic MPII JPEGs under ``mpii``: 2 epochs,
    a resume to a third, then ``cli.test`` on the result."""
    import torch
    from fhpe_tpu_torch.cli import fpd_train as fpd_cli
    from fhpe_tpu_torch.cli import test as test_cli
    from fhpe_tpu_torch.config import load_config
    from fhpe_tpu_torch.tools.train_parity import STUDENT_YAML as FPD_YAML
    from fhpe_tpu_torch.train import state as train_state
    from fhpe_tpu_torch.utils import checkpoint as ck

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        opts = ["OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
                "DATASET.ROOT", str(mpii), "DATASET.CACHE_ROOT", "",
                "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.DEAD_BIAS_SKIP", "True",
                "TRAIN.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "PRINT_FREQ", "1", "AUTO_RESUME", "True"]
        # the teacher's config as the CLI builds it: the student's, the
        # teacher file merged over it (reference fpd_train.py:128-131)
        tcfg = load_config(str(FPD_YAML), opts)
        tcfg.defrost()
        tcfg.merge_from_file(str(TEACHER_YAML))
        teacher_pth = root / "teacher.pth"
        ck.save_weights(str(teacher_pth), seeded_model(tcfg, 100))
        argv = ["--cfg", str(FPD_YAML), "--tcfg", str(TEACHER_YAML),
                "--device", str(device), *opts, "KD.TEACHER",
                str(teacher_pth)]
        per_batch = math.ceil(MPII_PEOPLE / TRAIN_BATCH)   # eval batches

        def want(steps, vals):
            return expected(device, conv3x3_wgrad=P4_PER_STEP * steps,
                            decode_heatmaps=K1_PER_TRAIN_STEP * steps
                            + K1_PER_EVAL_BATCH * per_batch * vals)

        steps = 2 * CLI_FPD_EPOCHS
        run = cli_run(fpd_cli, argv + ["TRAIN.END_EPOCH",
                                       str(CLI_FPD_EPOCHS)],
                      totals, "make_fpd_train_step")
        check_cli("fpd-cli", run, want(steps, 2 + CLI_FPD_EPOCHS),
                  2 + CLI_FPD_EPOCHS, steps)
        run_dir = (root / "out" / "mpii" / "hourglass"
                   / f"{FPD_YAML.stem}_{CLI_RUN_TAG}")
        for name in (ck.CKPT_NAME, ck.BEST_NAME, ck.FINAL_NAME):
            if not (run_dir / name).exists():
                raise AssertionError(f"fpd-cli: no {name} in {run_dir}")
        tperf, sperf = (v[0] for v in run["vals"][:2])
        log("fpd-cli", f"{FPD_YAML.name} by {TEACHER_YAML.name} (teacher "
            f"from a seeded .pth), {LOADER_TRAIN_IMAGES} + {MPII_PEOPLE} "
            f"JPEGs: {run['wall']:.2f} s for main(); pre-training PCKh "
            f"Mean teacher {tperf:.2f}, student "
            f"{sperf:.2f}, after each epoch "
            + ", ".join(f"{v[0]:.2f}" for v in run["vals"][2:])
            + f"; {run['steps']} steps; launches per step: P4 "
            f"{run['counts']['conv3x3_wgrad'] / steps:g}, decode "
            f"{K1_PER_TRAIN_STEP} and {K1_PER_EVAL_BATCH} per eval batch "
            f"({run['counts']['decode_heatmaps']} in all)")
        log("fpd-cli", cli_speeds(run["lines"]) + f"; {label}")

        resumed = cli_run(fpd_cli, argv + ["TRAIN.END_EPOCH",
                                           str(CLI_FPD_EPOCHS + 1)],
                          totals, "make_fpd_train_step")
        check_cli("fpd-cli resume", resumed, want(2, 3), 3, 2)
        if not any(f"auto-resumed from epoch {CLI_FPD_EPOCHS}" in ln
                   for ln in resumed["lines"]):
            raise AssertionError("fpd-cli resume: no resume from epoch "
                                 f"{CLI_FPD_EPOCHS} logged")
        saved = ck.load_checkpoint_file(str(run_dir / ck.CKPT_NAME))
        adam = {int(s["step"]) for s in saved["optimizer"]["state"].values()}
        if (saved["epoch"], saved["step"], adam) != (
                CLI_FPD_EPOCHS + 1, steps + 2, {steps + 2}):
            raise AssertionError(f"fpd-cli resume: checkpoint epoch "
                                 f"{saved['epoch']}, step {saved['step']}, "
                                 f"Adam steps {adam}")
        log("fpd-cli", f"resumed from epoch {CLI_FPD_EPOCHS} in "
            f"{resumed['wall']:.2f} s: 1 epoch, {resumed['steps']} steps, "
            f"Adam and the state at step {saved['step']} (from "
            f"{steps}); PCKh Mean {resumed['vals'][-1][0]:.2f}; "
            + cli_speeds(resumed["lines"]))

        test = cli_run(test_cli, ["--cfg", str(FPD_YAML), "--device",
                                  str(device), *opts, "TEST.MODEL_FILE",
                                  str(run_dir / ck.FINAL_NAME)], totals)
        check_cli("fpd-cli test", test, want(0, 1), 1, 0)
        last = resumed["vals"][-1]
        verdict = same_perf("fpd-cli test", test["vals"][0], last)
        log("fpd-cli", f"cli.test on final_state.pth: PCKh Mean "
            f"{test['result']:.4f}, the last validation's {last[0]:.4f}: "
            f"{verdict}; " + cli_speeds(test["lines"]) + f"; {label}")

        # the first run again with torch's default Adam and the eager step
        # (PR 13's route): where its PCKh differs, capturable Adam's
        # float32 bias correction made it (phase 27 holds graph against
        # eager with the same Adam bit-equal)
        def default_adam(cfg, params):
            return torch.optim.Adam(list(params), lr=float(cfg.TRAIN.LR),
                                    betas=(0.9, 0.999), eps=1e-8)

        eager_step = fpd_cli.make_fpd_train_step
        plain_argv = [a.replace(str(root / "out"), str(root / "plain"))
                      for a in argv]
        with mock.patch.object(train_state, "make_optimizer",
                               default_adam), mock.patch.object(
                fpd_cli, "make_fpd_train_step",
                lambda *a, **k: eager_step(*a, **k).eager):
            plain = cli_run(fpd_cli, plain_argv + [
                "TRAIN.END_EPOCH", str(CLI_FPD_EPOCHS)], Counter())
        log("fpd-cli", "PCKh Mean after each epoch, captured steps with "
            "capturable Adam " + ", ".join(f"{v[0]:.4f}" for v in
                                           run["vals"][2:])
            + "; eager steps with torch's default Adam "
            + ", ".join(f"{v[0]:.4f}" for v in plain["vals"][2:]))


def phase_rn50_cli(device, totals, label) -> None:
    """Phase 26: ``cli.train`` on PoseResNet-50 COCO
    (``res50_256x192_d256x3_adam_lr1e-3.yaml``, ``DEBUG.DEBUG False``,
    bf16, batch 32, a ``MODEL.PRETRAINED`` that is not there) over
    synthetic COCO JPEGs: one epoch to COCO AP, then ``cli.test`` on
    ``final_state.pth``."""
    from fhpe_tpu_torch.cli import test as test_cli
    from fhpe_tpu_torch.cli import train as train_cli
    from fhpe_tpu_torch.data import make_synthetic_coco
    from fhpe_tpu_torch.utils import checkpoint as ck

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        make_synthetic_coco(str(root / "coco"), "train2017",
                            LOADER_TRAIN_IMAGES, seed=0)
        make_synthetic_coco(str(root / "coco"), COCO_SET, CLI_COCO_VALID,
                            seed=1)
        missing = root / "resnet50-imagenet.pth"
        opts = ["OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
                "DATASET.ROOT", str(root / "coco"), "DATASET.TRAIN_SET",
                "train2017", "DATASET.TEST_SET", COCO_SET,
                "DATASET.CACHE_ROOT", "", "DEBUG.DEBUG", "False",
                "TPU.COMPUTE_DTYPE", "bfloat16",
                "TRAIN.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "MODEL.PRETRAINED", str(missing), "PRINT_FREQ", "1"]
        batches = math.ceil(CLI_COCO_VALID / TRAIN_BATCH)
        steps = LOADER_TRAIN_IMAGES // TRAIN_BATCH

        def want(steps, vals):
            return expected(
                device, conv3x3_fwd=RN50_ROUTED * (steps + 2 * batches * vals),
                conv3x3_wgrad=RN50_ROUTED * steps,
                decode_heatmaps=K1_PER_TRAIN_STEP * steps
                + K1_PER_EVAL_BATCH * batches * vals,
                oks_nms_segments=vals)

        run = cli_run(train_cli, ["--cfg", str(RN50_YAML), "--device",
                                  str(device), *opts, "TRAIN.END_EPOCH", "1"],
                      totals, "make_train_step")
        check_cli("rn50-cli", run, want(steps, 1), 1, steps)
        if not any("MODEL.PRETRAINED" in ln and "not found" in ln
                   for ln in run["lines"]):
            raise AssertionError("rn50-cli: no MODEL.PRETRAINED warning")
        ap, nv = run["vals"][-1][:2]
        if len(nv) != 10 or not all(math.isfinite(float(v))
                                    for v in nv.values()):
            raise AssertionError(f"rn50-cli: COCO stats {dict(nv)}")
        log("rn50-cli", f"{RN50_YAML.name} (DEBUG.DEBUG False, the "
            f"MODEL.PRETRAINED warning logged, random init) on "
            f"{LOADER_TRAIN_IMAGES} + {CLI_COCO_VALID} synthetic COCO "
            f"JPEGs: {run['wall']:.2f} s for main(), 1 epoch of "
            f"{run['steps']} steps, AP {ap:.4f}; launches "
            + ", ".join(f"{k} {v}" for k, v in run["counts"].items() if v))
        log("rn50-cli", cli_speeds(run["lines"]) + f"; {label}")

        run_dir = (root / "out" / "coco" / "pose_resnet"
                   / f"{RN50_YAML.stem}_{CLI_RUN_TAG}")
        test = cli_run(test_cli, ["--cfg", str(RN50_YAML), "--device",
                                  str(device), *opts, "TEST.MODEL_FILE",
                                  str(run_dir / ck.FINAL_NAME)], totals)
        check_cli("rn50-cli test", test, want(0, 1), 1, 0)
        verdict = same_perf("rn50-cli test", test["vals"][0],
                            run["vals"][-1])
        log("rn50-cli", f"cli.test on final_state.pth: AP "
            f"{test['result']:.6f}, the last validation's {ap:.6f}: "
            f"{verdict}; " + cli_speeds(test["lines"]) + f"; {label}")


# -- phase 27: the captured steps against their eager bodies -----------------

def state_tensors(state) -> dict:
    """{group: {name: tensor}} of a train state: parameters, buffers and
    Adam's moments."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    groups = {"params": dict(state.model.named_parameters()),
              "buffers": dict(state.model.named_buffers()),
              "exp_avg": {}, "exp_avg_sq": {}}
    for p, st in state.optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            groups[key][names[id(p)]] = st[key]
    return groups


def graph_agreement(graph: dict, eager: dict, eager2: dict) -> dict:
    """Graph against eager per group of tensors ({group: {name: tensor}},
    or {"outputs": {...}}), beside the eager body against itself (a second
    run from the same state): where eager is bit-equal to itself the graph
    must be bit-equal to it; elsewhere its relative L2 distance from eager
    must stay within ``GRAPH_SPREAD_FACTOR`` times eager's own.  Returns
    {group: (tensors, self-equal, graph-equal of those, graph relL2,
    eager relL2)}; raises beyond the bars."""
    import torch
    out, bad = {}, []
    for group, tensors in eager.items():
        n_self = n_equal = 0
        sq = {"g": 0.0, "e": 0.0, "ref": 0.0}
        for name, a in tensors.items():
            b, g = eager2[group][name], graph[group][name]
            if torch.equal(a, b):
                n_self += 1
                n_equal += torch.equal(g, a)
                if not torch.equal(g, a):
                    bad.append(f"{group}:{name}")
                continue
            a64 = a.detach().double()
            sq["g"] += float(((g.detach().double() - a64) ** 2).sum())
            sq["e"] += float(((b.detach().double() - a64) ** 2).sum())
            sq["ref"] += float((a64 ** 2).sum())
        ref = math.sqrt(sq["ref"]) or 1.0
        rg, re_ = math.sqrt(sq["g"]) / ref, math.sqrt(sq["e"]) / ref
        if rg > GRAPH_SPREAD_FACTOR * re_:
            bad.append(f"{group}: relative L2 {rg:.3g} against eager's own "
                       f"{re_:.3g}")
        out[group] = (len(tensors), n_self, n_equal, rg, re_)
    if bad:
        raise AssertionError(f"graph against eager: {bad[:5]} "
                             f"({len(bad)} in all); {out}")
    return out


def agreement_text(agree: dict) -> str:
    return "; ".join(
        f"{g} {n_self}/{n} tensors eager-deterministic, graph bit-equal on "
        f"{n_eq}" + (f", the rest relative L2 graph {rg:.3g} vs eager's own "
                     f"{re_:.3g}" if n_self < n else "")
        for g, (n, n_self, n_eq, rg, re_) in agree.items())


def in_turns(fns: dict, n_items: int, device) -> dict:
    """{name: images/s, median of 3} of ``fns`` (each N steps), timed by the
    host clock ended by a synchronise, in turns (a, b, b, a, a, b)."""
    names = list(fns)
    walls = {k: [] for k in names}
    for name in (names[0], names[1], names[1], names[0], names[0],
                 names[1]):
        sync(device)
        t0 = time.perf_counter()
        fns[name]()
        sync(device)
        walls[name].append(time.perf_counter() - t0)
    return {k: n_items / sorted(v)[1] for k, v in walls.items()}


def one_call_profile(fn) -> dict:
    """One warm call of ``fn`` under the profiler: the device ops the host
    launched (a graph launch counts once), the kernels the device ran,
    kernel ms, device busy ms, wall ms and the idle share."""
    import torch
    from fhpe_tpu_torch.utils.profiling import (DEVICE_CATEGORIES, busy_ms,
                                                host_launches, trace_events)
    walls = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    events = trace_events(timed)
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    busy = busy_ms(dev)
    return {"host_launches": host_launches(events),
            "kernels": sum(e["cat"] == "kernel" for e in dev),
            "kernel_ms": sum(float(e["dur"]) for e in dev
                             if e["cat"] == "kernel") / 1e3,
            "busy_ms": busy, "wall_ms": walls[0],
            "idle": 1 - busy / walls[0]}


def profile_text(prof: dict) -> str:
    return (f"{prof['host_launches']} device ops launched by the host, "
            f"{prof['kernels']} kernels run, kernel {prof['kernel_ms']:.2f} "
            f"ms, busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
            f"(idle share {prof['idle']:.3f})")


def graph_vs_eager_train(phase, make_state, make_step, batch, modules,
                         per_step, totals, label):
    """A captured train step against its eager body on the card (both
    with capturable Adam), from one state: agreement after
    ``GRAPH_CHECK_STEPS`` steps with the eager body's own spread beside
    it, ``set_lr(0)`` then one replay leaving the parameters unchanged,
    capturable against non-capturable Adam over one eager step, images/s
    in turns and a profile of one replay and one eager step.  Returns
    {"graph", "eager"} images/s."""
    import torch
    from fhpe_tpu_torch.train import set_lr
    from fhpe_tpu_torch.utils.graph import storage_fingerprint

    base = make_state()
    runs = {}
    for tag in ("graph", "eager", "eager2"):
        st = copy.deepcopy(base)
        step = make_step()
        fn = step if tag == "graph" else step.eager
        t0 = time.perf_counter()

        def run(st=st, fn=fn):
            return [fn(st, batch)[1] for _ in range(GRAPH_CHECK_STEPS)]

        if tag == "graph":
            metrics, counts = main_path_run(totals, run)
            want = expected(batch["image"].device, **{
                k: v * GRAPH_CHECK_STEPS for k, v in per_step.items()})
            if counts != want:
                raise AssertionError(f"{phase}: graph launches {counts} for "
                                     f"{GRAPH_CHECK_STEPS} steps, want "
                                     f"{want}")
        else:
            metrics = run()
        sync(batch["image"].device)
        runs[tag] = (st, metrics, step, time.perf_counter() - t0)
    g_state, g_metrics, g_step, g_wall = runs["graph"]
    e_state, e_metrics, e_step, _ = runs["eager"]

    def grouped(tag):
        st, ms = runs[tag][:2]
        groups = state_tensors(st)
        groups["metrics"] = {f"{k}@{i}": v for i, m in enumerate(ms)
                             for k, v in m.items()}
        return groups

    agree = graph_agreement(grouped("graph"), grouped("eager"),
                            grouped("eager2"))
    log(phase, f"{GRAPH_CHECK_STEPS} steps from one state (bf16, batch "
        f"{TRAIN_BATCH}; the graph's first call eager, "
        f"{g_step.captured.captures} capture, {GRAPH_CHECK_STEPS - 1} "
        f"replays in {g_wall:.2f} s): "
        + agreement_text(agree))

    # set_lr reaches the captured Adam: rate 0 leaves the parameters
    lr = float(g_state.optimizer.param_groups[0]["lr"])
    before = [p.detach().clone() for p in g_state.model.parameters()]
    set_lr(g_state, 0.0)
    g_step(g_state, batch)
    same = all(torch.equal(a, p) for a, p in
               zip(before, g_state.model.parameters()))
    set_lr(g_state, lr)
    g_step(g_state, batch)
    moved = sum(not torch.equal(a, p) for a, p in
                zip(before, g_state.model.parameters()))
    if not same or not moved:
        raise AssertionError(f"{phase}: after set_lr(0) one replay left "
                             f"the parameters {'un' if same else ''}changed;"
                             f" at lr {lr} it moved {moved} tensors")

    # capturable Adam (device float32 bias correction) against torch's
    # default Adam over one eager step from the same state
    cap, plain = copy.deepcopy(base), copy.deepcopy(base)
    group = plain.optimizer.param_groups[0]
    plain.optimizer = torch.optim.Adam(
        plain.model.parameters(), lr=float(group["lr"]), betas=group["betas"],
        eps=group["eps"])
    e_step.eager(cap, batch)
    e_step.eager(plain, batch)
    ups = [(a.detach().double() - b.detach().double()).abs().max().item()
           / lr for a, b in zip(cap.model.parameters(),
                                plain.model.parameters())]
    n_off = sum(int((a != b).sum()) for a, b in
                zip(cap.model.parameters(), plain.model.parameters()))
    n_all = sum(p.numel() for p in cap.model.parameters())
    del cap, plain
    t0 = time.perf_counter()
    for _ in range(20):
        storage_fingerprint((g_state.model, *modules), g_state.optimizer)
    fp_us = (time.perf_counter() - t0) / 20 * 1e6
    log(phase, f"set_lr(0): one replay left every parameter bit-equal, "
        f"at lr {lr:g} the next moved {moved} tensors; capturable Adam "
        f"against the default after one eager step: {n_off} of {n_all} "
        f"parameters differ, by at most {max(ups):.3g} x lr; storage "
        f"fingerprint {fp_us:.0f} us per call (host)")

    def graph_steps():
        for _ in range(GRAPH_TIMED_STEPS):
            g_step(g_state, batch)

    def eager_steps():
        for _ in range(GRAPH_TIMED_STEPS):
            e_step.eager(e_state, batch)

    rates = in_turns({"graph": graph_steps, "eager": eager_steps},
                     GRAPH_TIMED_STEPS * TRAIN_BATCH, batch["image"].device)
    log(phase, f"graph {rates['graph']:.1f} images/s, eager "
        f"{rates['eager']:.1f} (medians of 3 x {GRAPH_TIMED_STEPS} steps in "
        f"turns); {label}")
    if batch["image"].is_cuda:
        log(phase, "one replay: " + profile_text(one_call_profile(
            lambda: g_step(g_state, batch))) + "; one eager step: "
            + profile_text(one_call_profile(
                lambda: e_step.eager(e_state, batch))))
    return rates


def graph_vs_eager_forward(phase, step, owner, batches, per_call, totals,
                           label):
    """A captured forward-only step (eval or serve) against its eager
    body: bit-equal outputs on a batch after the capture, images/s in
    turns, a profile of one replay and one eager call."""
    import torch
    step(owner, batches[0])                 # eager, then the capture
    graph, counts = main_path_run(totals, lambda: step(owner, batches[1]))
    want = expected(batches[1]["image"].device, **per_call)
    if counts != want:
        raise AssertionError(f"{phase}: launches per replay {counts}, want "
                             f"{want}")
    eager = step.eager(owner, batches[1])
    diff = [k for k in eager if not torch.equal(graph[k], eager[k])]
    if diff:
        raise AssertionError(f"{phase}: graph != eager in {diff}")
    b = len(batches[1]["image"])
    rates = in_turns(
        {"graph": lambda: [step(owner, batches[1])
                           for _ in range(GRAPH_TIMED_STEPS)],
         "eager": lambda: [step.eager(owner, batches[1])
                           for _ in range(GRAPH_TIMED_STEPS)]},
        GRAPH_TIMED_STEPS * b, batches[1]["image"].device)
    log(phase, f"replay bit-equal to the eager body in all of "
        f"{sorted(eager)}; graph {rates['graph']:.1f} images/s, eager "
        f"{rates['eager']:.1f} (medians of 3 x {GRAPH_TIMED_STEPS} calls in "
        f"turns, batch {b}); {label}")
    if batches[1]["image"].is_cuda:
        log(phase, "one replay: " + profile_text(one_call_profile(
            lambda: step(owner, batches[1]))) + "; one eager call: "
            + profile_text(one_call_profile(
                lambda: step.eager(owner, batches[1]))))
    return rates


def phase_graphs(device, totals, label) -> None:
    """Phase 27: each captured step (the hourglass FPD step, W48 -> W32
    FPD, the RN-50 plain step, MPII eval of the hourglass student, W32
    serving; full width and depth, bf16, batch 32, seeded weights) against
    its eager body on the card."""
    import torch
    from fhpe_tpu_torch.data import MPII_FLIP_PAIRS
    from fhpe_tpu_torch.geometry.flip import flip_pair_permutation
    from fhpe_tpu_torch.serve import Predictor
    from fhpe_tpu_torch.tools.train_parity import (fpd_cfgs, hrnet_fpd_cfgs,
                                                   rn50_cfg, train_batch)
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_eval_step, make_fpd_train_step,
                                      make_train_step)

    # the hourglass FPD step (phase 12's pair)
    scfg, tcfg = fpd_cfgs()
    teacher = seeded_model(tcfg, 100).to(device)
    graph_vs_eager_train(
        "graph-fpd-hg",
        lambda: create_train_state(scfg, seeded_model(scfg, 0),
                                   device=device),
        lambda: make_fpd_train_step(scfg, teacher, tcfg,
                                    prepare=make_batch_preprocessor(scfg)),
        train_batch(scfg, TRAIN_BATCH, seed=7, device=device), (teacher,),
        {"conv3x3_wgrad": P4_PER_STEP, "decode_heatmaps": K1_PER_TRAIN_STEP},
        totals, label)

    # MPII eval of the hourglass student (phase 14's step), two batches
    eval_step = make_eval_step(scfg, flip_pair_permutation(
        int(scfg.MODEL.NUM_JOINTS), MPII_FLIP_PAIRS),
        prepare=make_batch_preprocessor(scfg))
    student = seeded_model(scfg, 0).to(device)
    batches = []
    for seed in (31, 32):
        b = train_batch(scfg, TRAIN_BATCH, seed=seed, device=device)
        b["inv_trans"] = torch.tensor(
            [[4.0, 0.0, 10.0], [0.0, 4.0, 20.0]],
            device=device).expand(TRAIN_BATCH, 2, 3).contiguous()
        b["valid"] = torch.ones(TRAIN_BATCH, device=device)
        batches.append(b)
    graph_vs_eager_forward("graph-eval-hg", eval_step, student, batches,
                           {"decode_heatmaps": K1_PER_EVAL_BATCH}, totals,
                           label)
    del teacher, student, eval_step
    torch.cuda.empty_cache()

    # the W48 -> W32 FPD step (phase 17's pair)
    scfg, tcfg = hrnet_fpd_cfgs()
    student_cpu, teacher = hrnet_pair(scfg, tcfg)
    teacher = teacher.to(device)
    graph_vs_eager_train(
        "graph-fpd-hrnet",
        lambda: create_train_state(scfg, copy.deepcopy(student_cpu),
                                   device=device),
        lambda: make_fpd_train_step(scfg, teacher, tcfg,
                                    prepare=make_batch_preprocessor(scfg)),
        train_batch(scfg, TRAIN_BATCH, seed=17, device=device), (teacher,),
        {"branch_chain_eval": HRNET_CHAINS,
         "branch_chain_train": HRNET_CHAINS,
         "conv3x3_wgrad": HRNET_P4_PER_STEP,
         "decode_heatmaps": K1_PER_TRAIN_STEP}, totals, label)
    del teacher, student_cpu
    torch.cuda.empty_cache()

    # W32 serving (phase 8's Predictor)
    w32 = serve_cfg(W32_YAML)
    p = Predictor(w32, he_model(w32, 200), device=device)
    crops, _, _ = make_requests(w32, 2 * p.batch_size, 201)
    inv = torch.tensor([[4.0, 0.0, 10.0], [0.0, 4.0, 20.0]],
                       device=device).expand(p.batch_size, 2, 3).contiguous()
    batches = [{"image": torch.from_numpy(c).to(device), "inv_trans": inv}
               for c in (crops[:p.batch_size], crops[p.batch_size:])]
    graph_vs_eager_forward("graph-serve-w32", p.step, p.model, batches,
                           {"decode_heatmaps": 1,
                            "branch_chain_eval": chains_per_chunk(p)},
                           totals, label)
    del p
    torch.cuda.empty_cache()

    # the RN-50 plain step (phase 22's)
    cfg = rn50_cfg()
    model = he_model(cfg, 300)
    graph_vs_eager_train(
        "graph-rn50",
        lambda: create_train_state(cfg, copy.deepcopy(model), device=device),
        lambda: make_train_step(cfg, prepare=make_batch_preprocessor(cfg)),
        train_batch(cfg, TRAIN_BATCH, seed=27, device=device), (),
        {"conv3x3_fwd": RN50_ROUTED, "conv3x3_wgrad": RN50_ROUTED,
         "decode_heatmaps": K1_PER_TRAIN_STEP}, totals, label)
    torch.cuda.empty_cache()


# -- phase 28: full-frame serving --------------------------------------------

def make_frames(n: int, boxes_per_frame: int, seed: int):
    """``n`` noise frames of ``FRAME_HW`` and ``boxes_per_frame`` person
    boxes (x, y, w, h) each, some across the frame's borders."""
    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    frames, boxes = [], []
    for _ in range(n):
        frames.append(rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8))
        bw = rng.uniform(40, 400, boxes_per_frame)
        bh = rng.uniform(80, 600, boxes_per_frame)
        x = rng.uniform(-0.2 * bw, w - 0.8 * bw)
        y = rng.uniform(-0.2 * bh, h - 0.8 * bh)
        boxes.append([tuple(float(v) for v in b)
                      for b in zip(x, y, bw, bh)])
    return frames, boxes


def serial_predict_crops(p, crops, centers, scales):
    """The loop ``Predictor.predict_crops`` ran before its pipeline, kept
    as a yardstick: each chunk padded in fresh pageable host memory,
    uploaded synchronously, stepped; the results read back once at the
    end."""
    import torch
    from fhpe_tpu_torch.ops.decode import make_inverse_transforms
    w, h = p.image_size
    n = len(crops)
    inv = make_inverse_transforms(np.asarray(centers), np.asarray(scales),
                                  p.heatmap_size)
    b = p.batch_size
    preds, vals = [], []
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        img = torch.zeros((b, h, w, 3), dtype=torch.uint8)
        itr = torch.zeros((b, 2, 3), dtype=torch.float32)
        img[:hi - lo] = torch.from_numpy(crops[lo:hi])
        itr[:hi - lo] = torch.from_numpy(inv[lo:hi])
        out = p.step(p.model, {"image": img.to(p.device),
                               "inv_trans": itr.to(p.device)})
        preds.append(out["preds"][:hi - lo])
        vals.append(out["maxvals"][:hi - lo])
    return torch.cat(preds).cpu().numpy(), torch.cat(vals).cpu().numpy()


def rates_in_turns(fns: dict, items: dict, device, rounds: int = 3) -> dict:
    """{name: items/s, median of ``rounds``} of ``fns``, each round in
    turns (the order of ``fns``, then reversed, ...), host clock ended by
    a synchronise."""
    names = list(fns)
    walls = {k: [] for k in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            sync(device)
            t0 = time.perf_counter()
            fns[name]()
            sync(device)
            walls[name].append(time.perf_counter() - t0)
    return {k: items[k] / sorted(v)[len(v) // 2] for k, v in walls.items()}


def phase_frame_serving(device, totals, label) -> None:
    """Phase 28: ``Predictor.predict(image, boxes)`` on full frames, W32
    at full width (bf16, batch 32, flip test): the crops cut on the
    prefetch thread, the chunks double-buffered through the captured
    serve step."""
    from fhpe_tpu_torch.serve import Predictor
    from fhpe_tpu_torch.serve.predictor import xywh_to_center_scale

    w32 = serve_cfg(W32_YAML)
    p = Predictor(w32, he_model(w32, 200), device=device)
    p.warmup()
    num_joints = int(w32.MODEL.NUM_JOINTS)
    frames, boxes = make_frames(FRAMES, BOXES_PER_FRAME, seed=280)
    frames.append(np.zeros(FRAME_HW + (3,), np.uint8))
    boxes.append([])
    outs, counts = main_path_run(totals, lambda: [
        p.predict(f, b) for f, b in zip(frames, boxes)])
    chunks = sum(-(-len(b) // p.batch_size) for b in boxes)
    want = expected(device, decode_heatmaps=chunks,
                    branch_chain_eval=chains_per_chunk(p) * chunks)
    if counts != want:
        raise AssertionError(f"frames: launches {counts} for {chunks} "
                             f"chunks, want {want}")
    for out, b in zip(outs, boxes):
        if out.shape != (len(b), num_joints, 3) or out.dtype != np.float32 \
                or not np.isfinite(out).all():
            raise AssertionError(f"frames: output {out.dtype} {out.shape} "
                                 f"for {len(b)} boxes")

    # against cropping first (Predictor.crop, then predict_crops) and the
    # serial yardstick on the same crops: bit-equal, frame by frame
    cropped = []
    for f, b, out in zip(frames, boxes, outs):
        cs = [xywh_to_center_scale(x, p.aspect_ratio) for x in b]
        centers = np.array([c for c, _ in cs], np.float32).reshape(-1, 2)
        scales = np.array([s for _, s in cs], np.float32).reshape(-1, 2)
        crops = np.stack([p.crop(f, c, s) for c, s in cs]) if cs else \
            np.zeros((0, p.image_size[1], p.image_size[0], 3), np.uint8)
        cropped.append((crops, centers, scales))
        preds, vals = p.predict_crops(crops, centers, scales)
        if not len(b):
            continue
        s_preds, s_vals = serial_predict_crops(p, crops, centers, scales)
        if not (np.array_equal(out[..., :2], preds)
                and np.array_equal(out[..., 2], vals)
                and np.array_equal(preds, s_preds)
                and np.array_equal(vals, s_vals)):
            raise AssertionError("frames: predict != predict_crops of "
                                 "crop's crops != the serial yardstick")
    # several chunks in one request, results in flight: all the frames'
    # crops with max_in_flight 2 (3 chunks in 3 slots) and 1 (2 slots, one
    # reused), and the timed request below (8 chunks in 3 slots, reused)
    crops, centers, scales = (np.concatenate(a) for a in zip(*cropped))
    t_crops, t_centers, t_scales = make_requests(
        w32, FRAME_TIMED_CHUNKS * p.batch_size, 281)
    runs = []
    for request, in_flight in (((crops, centers, scales), 2),
                               ((crops, centers, scales), 1),
                               ((t_crops, t_centers, t_scales), 2)):
        p.max_in_flight = in_flight
        try:
            got = p.predict_crops(*request)
        finally:
            p.max_in_flight = 2
        ref = serial_predict_crops(p, *request)
        if not all(np.array_equal(a, r) for a, r in zip(got, ref)):
            raise AssertionError(
                f"frames: pipelined predict_crops != the serial yardstick "
                f"over {len(request[0])} crops, max_in_flight {in_flight}")
        chunks_in = -(-len(request[0]) // p.batch_size)
        runs.append(f"{len(request[0])} crops in {chunks_in} chunks through "
                    f"{min(in_flight + 1, chunks_in)} slots")
    n_people = sum(len(b) for b in boxes)
    log("frames", f"predict on {len(frames)} {FRAME_HW[1]}x{FRAME_HW[0]} "
        f"frames ({n_people} boxes, one frame empty -> (0, {num_joints}, "
        f"3)): {chunks} chunks, decode launches "
        f"{counts['decode_heatmaps']}, P5e {counts['branch_chain_eval']} "
        f"({chains_per_chunk(p)} per chunk); bit-equal to predict_crops of "
        f"crop's crops and to the serial yardstick frame by frame; the "
        f"pipelined predict_crops bit-equal to the serial yardstick over "
        + "; ".join(runs))

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for f, b in zip(frames, boxes):
            for x in b:
                p.crop(f, *xywh_to_center_scale(x, p.aspect_ratio))
        walls.append((time.perf_counter() - t0) * 1e3 / n_people)
    import torch
    from fhpe_tpu_torch.ops.decode import make_inverse_transforms
    inv = torch.from_numpy(make_inverse_transforms(t_centers, t_scales,
                                                   p.heatmap_size))
    bs = p.batch_size
    resident = [{"image": torch.from_numpy(t_crops[i:i + bs]).to(device),
                 "inv_trans": inv[i:i + bs].to(device)}
                for i in range(0, len(t_crops), bs)]
    n_crops = len(t_crops)
    fns = {"predict": lambda: [p.predict(f, x)
                               for f, x in zip(frames, boxes)],
           "predict_crops": lambda: p.predict_crops(t_crops, t_centers,
                                                    t_scales),
           "serial": lambda: serial_predict_crops(p, t_crops, t_centers,
                                                  t_scales),
           "step": lambda: [p.step(p.model, r) for r in resident]}
    rates = rates_in_turns(fns, {"predict": n_people,
                                 "predict_crops": n_crops, "serial": n_crops,
                                 "step": n_crops}, device)
    idle = {}
    if device.type == "cuda":
        for name in ("predict_crops", "serial"):
            idle[name] = f"{one_call_profile(fns[name])['idle']:.3f}"
    log("frames", f"persons/s (medians of 3 in turns; "
        f"{w32.TPU.COMPUTE_DTYPE}, batch {bs}, flip test): predict "
        f"{rates['predict']:.1f} ({n_people} persons in {len(frames)} "
        f"frame requests), pipelined predict_crops "
        f"{rates['predict_crops']:.1f} ({n_crops} crops), serial yardstick "
        f"{rates['serial']:.1f}, the step alone on resident chunks "
        f"{rates['step']:.1f}; host crop {sorted(walls)[1]:.3f} ms per "
        f"person; idle share of one profiled call: predict_crops "
        f"{idle.get('predict_crops', 'not measured')}, serial "
        f"{idle.get('serial', 'not measured')}; {label}")
    del p, resident


# -- phase 29: the canvas-fed FPD step (TPU.DEVICE_WARP) ----------------------

def canvas_cfgs(root: Path, device_warp: bool):
    """``loader_cfgs`` with ``TPU.DEVICE_WARP`` set and the canvas at
    ``CANVAS_SIZE``."""
    scfg, tcfg = loader_cfgs(root)
    scfg.defrost()
    scfg.TPU.DEVICE_WARP = device_warp
    scfg.TPU.CANVAS_SIZE = list(CANVAS_SIZE)
    scfg.freeze()
    return scfg, tcfg


def phase_canvas_step(device, totals, label, root: Path) -> None:
    """Phase 29: the captured hourglass FPD step (phase 14b's pair, bf16,
    batch 32) fed letterbox canvases: ``build_loaders`` -> ``BatchLoader``
    (decode, augment draws, the resize into the canvas, the matrix) ->
    ``device_batch`` -> the step, whose preprocessor warps the crops on
    the card; then the crops against the CPU's warp and the host warp,
    and the feed against the host-warp feed of the same files."""
    import os

    import torch
    from fhpe_tpu_torch.cli.common import build_loaders, device_batch
    from fhpe_tpu_torch.ops.preprocess import warp_affine
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)

    write_mpii_sets(root, CANVAS_IMAGE_HW)
    scfg, tcfg = canvas_cfgs(root, True)
    cfgs = {"canvas": scfg, "host": canvas_cfgs(root, False)[0]}

    def train_loader(cfg):
        train, val, _ = build_loaders(cfg)
        val.close()
        return train

    prepare = make_batch_preprocessor(scfg)
    tap = {}

    def tapped(batch):
        """The preprocessor; a canvas batch's prepared image is also
        copied into a buffer that the captured graph writes on replay."""
        out = prepare(batch)
        if "canvas" in batch:
            if "image" not in tap:
                tap["image"] = torch.empty_like(out["image"])
            tap["image"].copy_(out["image"])
        return out

    teacher = seeded_model(tcfg, 100).to(device)
    state = create_train_state(scfg, seeded_model(scfg, 0), device=device)
    step = make_fpd_train_step(scfg, teacher, tcfg, prepare=tapped)
    loaders = {k: train_loader(c) for k, c in cfgs.items()}

    def train():
        fed = [step(state, device_batch(scfg, batch, device))[1]
               for _ in range(CANVAS_EPOCHS) for batch in loaders["canvas"]]
        one = device_batch(scfg, next(iter(loaders["canvas"])), device)
        return fed, [step(state, one)[1] for _ in range(CANVAS_REPEATS)]

    (fed, repeated), counts = main_path_run(totals, train)
    steps = len(fed) + len(repeated)
    want = expected(device, conv3x3_wgrad=P4_PER_STEP * steps,
                    decode_heatmaps=K1_PER_TRAIN_STEP * steps)
    if len(fed) < 6 or counts != want:
        raise AssertionError(f"canvas: {steps} steps, launches {counts}, "
                             f"want {want}")
    losses = [check_finite("canvas", m)["loss"] for m in fed + repeated]
    if not losses[-1] < losses[len(fed)]:
        raise AssertionError(f"canvas: the loss did not fall on one "
                             f"batch: {losses[len(fed):]}")
    log("canvas", f"{steps} captured FPD steps on canvas batches "
        f"({CANVAS_SIZE[0]}x{CANVAS_SIZE[1]} canvases of "
        f"{CANVAS_IMAGE_HW[1]}x{CANVAS_IMAGE_HW[0]} JPEGs), {len(fed)} fed "
        f"by the loader, loss " + ", ".join(f"{v:.6f}" for v in
                                           losses[:len(fed)])
        + f", then {len(repeated)} on one batch: {losses[len(fed)]:.6f} -> "
        f"{losses[-1]:.6f}; launches per step: P4 "
        f"{counts['conv3x3_wgrad'] / steps:g}, decode "
        f"{counts['decode_heatmaps'] / steps:g}")

    # one batch's crops: the card's warp against the CPU's on the same
    # canvases, and against the host warp of the same augmentation draws
    # (fresh loaders of one seed draw the same samples)
    fresh = {k: train_loader(c) for k, c in cfgs.items()}
    cb, hb = (next(iter(fresh[k])) for k in ("canvas", "host"))
    for loader in fresh.values():
        loader.close()
    if not (np.array_equal(cb["flipped"], hb["flipped"])
            and np.array_equal(cb["joints"], hb["joints"])):
        raise AssertionError("canvas: the two feeds drew different samples")
    # the canvas graph's prepared image, from one replay on this batch,
    # against the preprocessor run eagerly on the card: bit-equal
    captures = step.captured.captures
    dev_batch = device_batch(scfg, cb, device)
    step(state, dev_batch)
    graph_image = tap["image"].clone()
    eager_image = prepare(dev_batch)["image"]
    if step.captured.captures != captures:
        raise AssertionError("canvas: a canvas batch was captured again")
    if not torch.equal(graph_image, eager_image):
        raise AssertionError(
            f"canvas: the captured step's prepared image != the eager "
            f"preprocessor's (max |diff| "
            f"{float((graph_image - eager_image).abs().max())})")
    size = tuple(int(v) for v in scfg.MODEL.IMAGE_SIZE)
    canvas, inv = (torch.from_numpy(cb[k]) for k in ("canvas", "warp_inv"))
    card = warp_affine(canvas.to(device), inv.to(device), size).cpu()
    cpu = warp_affine(canvas, inv, size)
    d_cpu = (card - cpu).abs()
    d_host = (card - torch.from_numpy(hb["image"]).float()).abs()
    if d_cpu.max() > CANVAS_WARP_ATOL or not (
            d_host.mean() < HOST_WARP_MEAN
            and d_host.median() < HOST_WARP_MEDIAN):
        raise AssertionError(
            f"canvas: crops off: card vs CPU max {float(d_cpu.max())}, vs "
            f"host warp mean {float(d_host.mean())}, median "
            f"{float(d_host.median())}")
    log("canvas", f"one batch's {len(card)} crops warped on the card from "
        f"its canvases: against the CPU warp_affine max |diff| "
        f"{float(d_cpu.max()):.3g} ({int((d_cpu > 0).sum())} of "
        f"{d_cpu.numel()} values differ; bar {CANVAS_WARP_ATOL}); against "
        f"the host warp of the same draws mean |diff| "
        f"{float(d_host.mean()):.3f}, median {float(d_host.median()):.3f} "
        f"(bars {HOST_WARP_MEAN}, {HOST_WARP_MEDIAN}); "
        f"{int(cb['flipped'].sum())} flipped; the canvas graph's prepared "
        f"image from one replay bit-equal to the eager preprocessor's")

    # the canvas feed against the host-warp feed of the same files: the
    # loader alone, the step fed by it, idle share, upload
    def alone(name):
        return lambda: sum(len(b["valid"]) for _ in range(
            LOADER_TIMED_EPOCHS) for b in loaders[name])

    def fed(name):
        cfg = cfgs[name]

        def run():
            for _ in range(LOADER_TIMED_EPOCHS):
                for batch in loaders[name]:
                    step(state, device_batch(cfg, batch, device))
        return run

    n_img = LOADER_TIMED_EPOCHS * len(loaders["canvas"]) * TRAIN_BATCH
    turns = ("canvas", "host", "host", "canvas")
    # the host batches' own graph (a new input signature), captured first
    step(state, device_batch(cfgs["host"], next(iter(loaders["host"])),
                             device))
    alone_rates = feed_rates({k: alone(k) for k in cfgs}, turns, n_img,
                             device)
    feeds = {k: fed(k) for k in cfgs}
    fed_rates = feed_rates(feeds, turns, n_img, device)
    idle = idle_shares(feeds, device)
    uploads = {k: upload_ms(cfgs[k], next(iter(loaders[k])), device)[:2]
               for k in cfgs}
    what = {"canvas": "letterbox canvases, the warp in the step",
            "host": "crops warped on the host"}
    for k in cfgs:
        log("canvas", f"{k} feed ({what[k]}): the loader alone "
            + ", ".join(f"{r:.1f}" for r in alone_rates[k])
            + " images/s, the captured FPD step fed by it "
            + ", ".join(f"{r:.1f}" for r in fed_rates[k])
            + f" images/s (in turns, {n_img} images per run; idle share "
            f"{idle.get(k, 'not measured')}); upload "
            f"{uploads[k][0]:.3f} ms host for {uploads[k][1]:.2f} MB per "
            f"batch (median of 5); {max(2, int(cfgs[k].WORKERS))} loader "
            f"threads, nproc {os.cpu_count()}; {label}")
    for loader in loaders.values():
        loader.close()
    del state, teacher, step


# -- phase 30: data-parallel training under torchrun -----------------------

def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_record(state, metrics) -> dict:
    """{group: {name: tensor}}: the state (parameters, buffers, Adam's
    moments and step counts) and each step's metrics."""
    groups = state_tensors(state)
    names = {id(p): k for k, p in state.model.named_parameters()}
    groups["adam_step"] = {names[id(p)]: st["step"]
                           for p, st in state.optimizer.state.items()}
    groups["metrics"] = {f"{k}@{i}": v for i, m in enumerate(metrics)
                         for k, v in m.items()}
    return groups


def unequal(a: dict, b: dict) -> list:
    """The tensors of two :func:`step_record` that are not bit-equal."""
    import torch
    return [f"{g}:{k}" for g, ts in a.items() for k, t in ts.items()
            if not torch.equal(t, b[g][k])]


# NCCL's device kernels: its collectives' (ncclDevKernel_*) and the one a
# single rank runs for an average (oneRankReduce)
NCCL_KERNEL = re.compile(r"nccl|onerankreduce", re.I)


def replay_ops(events) -> dict:
    """What the device ran in a trace: kernels and their ms, NCCL's
    kernels and their us, copies and their us, and {kernel name: (count,
    us)}."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if NCCL_KERNEL.search(e["name"])]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    names = {}
    for e in kernels:
        n, us = names.get(e["name"], (0, 0.0))
        names[e["name"]] = (n + 1, us + float(e["dur"]))
    return {"kernels": len(kernels),
            "kernel_ms": sum(float(e["dur"]) for e in kernels) / 1e3,
            "nccl": len(nccl), "nccl_us": sum(float(e["dur"]) for e in nccl),
            "copies": len(copies),
            "copy_us": sum(float(e["dur"]) for e in copies), "names": names}


def extra_kernels(ops: dict, base: dict) -> str:
    """The kernels a replay ran beyond another's: name, count, us."""
    out = []
    for name, (n, us) in sorted(ops["names"].items()):
        m = n - base["names"].get(name, (0, 0.0))[0]
        if m > 0:
            out.append(f"{name[:70]} x{m} ({us * m / n:.1f} us)")
    return "; ".join(out) or "none"


@contextlib.contextmanager
def counted_collectives():
    """A context counting the calls to ``torch.distributed.all_reduce`` and
    ``broadcast`` (they still run); yields the Counter."""
    import torch.distributed as dist
    calls = Counter()
    stack = contextlib.ExitStack()
    for name in ("all_reduce", "broadcast"):
        orig = getattr(dist, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        stack.enter_context(mock.patch.object(dist, name, counted))
    with stack:
        yield calls


def phase_ddp_step(device, totals, label) -> None:
    """Phase 30a: the hourglass FPD step (phase 12's pair at full width,
    bf16, batch 32, Adam) in a process group of one rank joined through
    ``parallel.initialize`` (NCCL on the card, gloo on the CPU), against
    the same step without a group."""
    import torch
    from fhpe_tpu_torch import parallel
    from fhpe_tpu_torch.tools.train_parity import fpd_cfgs, train_batch
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)
    from fhpe_tpu_torch.utils.profiling import trace_events

    scfg, tcfg = fpd_cfgs()
    teacher = seeded_model(tcfg, 100).to(device)
    base = create_train_state(scfg, seeded_model(scfg, 0), device=device)
    batches = [train_batch(scfg, TRAIN_BATCH, seed=50 + i, device=device)
               for i in range(DDP_STEPS)]

    def make_step():
        return make_fpd_train_step(scfg, teacher, tcfg,
                                   prepare=make_batch_preprocessor(scfg))

    def run(fn, state):
        return [fn(state, b)[1] for b in batches]

    single_state, single = copy.deepcopy(base), make_step()
    single_rec = step_record(single_state, run(single, single_state))
    env = {"RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": str(device.index or 0),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    with mock.patch.dict(os.environ, env):
        own = parallel.initialize(device.type)
    try:
        nccl = (".".join(map(str, torch.cuda.nccl.version()))
                if device.type == "cuda" else "none")
        log("ddp-step", f"process group: backend {parallel.backend()}, world "
            f"size {parallel.process_count()}, rank "
            f"{parallel.process_index()} on {own}; NCCL {nccl}; torch "
            f"{torch.__version__}")
        ddp_state, ddp = copy.deepcopy(base), make_step()
        with counted_collectives() as calls:
            metrics, counts = main_path_run(totals,
                                            lambda: run(ddp, ddp_state))
        want = expected(device, conv3x3_wgrad=P4_PER_STEP * DDP_STEPS,
                        decode_heatmaps=K1_PER_TRAIN_STEP * DDP_STEPS)
        captures = ddp.captured.captures
        if counts != want or captures != on_card(device, 1):
            raise AssertionError(f"ddp-step: launches {counts}, want {want};"
                                 f" {captures} captures")
        ddp_rec = step_record(ddp_state, metrics)
        eager_state = copy.deepcopy(base)
        eager_rec = step_record(eager_state, run(ddp.eager, eager_state))
        vs_single, vs_eager = (unequal(ddp_rec, single_rec),
                               unequal(ddp_rec, eager_rec))
        if vs_single or vs_eager:
            raise AssertionError(f"ddp-step: not bit-equal to the single-"
                                 f"device graph in {vs_single[:5]}, to its "
                                 f"eager body in {vs_eager[:5]}")
        n = sum(len(g) for g in ddp_rec.values())
        # bodies run: on the card the first call's and the capture's
        # (replays issue nothing from the host), on the CPU each step's
        bodies = 2 if device.type == "cuda" else DDP_STEPS
        per_body = {k: v // bodies for k, v in calls.items()}
        log("ddp-step", f"{DDP_STEPS} steps from one state (the first eager "
            f"then {captures} capture, the rest replays): all {n} tensors "
            f"(parameters, buffers, Adam's moments and steps, the metrics "
            f"of each step) bit-equal to the single-device graph's and to "
            f"the distributed eager body's; collectives issued per body: "
            f"{dict(per_body)}")
        if device.type == "cuda":
            events, counts = main_path_run(totals, lambda: trace_events(
                lambda: ddp(ddp_state, batches[0])))
            want = expected(device, conv3x3_wgrad=P4_PER_STEP,
                            decode_heatmaps=K1_PER_TRAIN_STEP)
            if counts != want:
                raise AssertionError(f"ddp-step: one profiled replay "
                                     f"launched {counts}, want {want}")
            ops = {"distributed": replay_ops(events),
                   "single": replay_ops(trace_events(
                       lambda: single(single_state, batches[0])))}
            log("ddp-step", "one profiled replay of each graph: " + "; ".join(
                f"{k} {v['kernels']} kernels ({v['kernel_ms']:.2f} ms), "
                f"{v['nccl']} NCCL kernels ({v['nccl_us']:.1f} us), "
                f"{v['copies']} copies ({v['copy_us']:.1f} us)"
                for k, v in ops.items()) + f"; P4 "
                f"{counts['conv3x3_wgrad']} and decode "
                f"{counts['decode_heatmaps']} launches per replay; the "
                f"distributed replay's kernels beyond the single one's: "
                + extra_kernels(ops["distributed"], ops["single"]))
            # the averages (gradients, losses) run NCCL's kernel even at
            # one rank; in place, its sum and broadcast run nothing
            if not ops["distributed"]["nccl"]:
                raise AssertionError("ddp-step: no NCCL kernel in the "
                                     "profiled replay of the distributed "
                                     "graph")

        def steps(fn, state):
            return lambda: [fn(state, batches[0])
                            for _ in range(GRAPH_TIMED_STEPS)]

        rates = in_turns({"distributed": steps(ddp, ddp_state),
                          "single": steps(single, single_state)},
                         GRAPH_TIMED_STEPS * TRAIN_BATCH, device)
        log("ddp-step", f"graph images/s: distributed "
            f"{rates['distributed']:.1f}, single-device "
            f"{rates['single']:.1f} (medians of 3 x "
            f"{GRAPH_TIMED_STEPS} steps in turns); {label}")
    finally:
        parallel.shutdown()
    if parallel.initialized():
        raise AssertionError("ddp-step: the process group outlived shutdown")


def run_process_group(cmd, log_path: Path, timeout: float,
                      tag: str = DDP_RUN_TAG) -> float:
    """``cmd`` from the repository root in a session of its own, with
    ``FHPE_RUN_TAG`` ``tag``, its output into ``log_path``; on a timeout
    the whole session is killed.  Raises on a non-zero exit with the log's
    tail.  Returns the wall seconds."""
    import signal
    import subprocess
    env = dict(os.environ, FHPE_RUN_TAG=tag)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"{cmd[:8]} ran over {timeout} s; log "
                                 f"tail:\n{log_path.read_text()[-4000:]}")
    if code:
        raise AssertionError(f"{cmd[:8]} exited {code}; log tail:\n"
                             f"{log_path.read_text()[-6000:]}")
    return time.perf_counter() - t0


def phase_ddp_cli(device, totals, label) -> None:
    """Phase 30b: ``torchrun --standalone --nproc_per_node 1 -m
    fhpe_tpu_torch.cli.fpd_train`` on phase 25's pair and settings over
    phase 14b's synthetic MPII JPEGs (``write_mpii_sets`` again):
    ``DDP_CLI_EPOCHS`` epochs, a second launch resumes to one more, then
    ``cli.test`` in this process gives the last validation's predictions
    exactly."""
    import torch
    from scipy.io import loadmat
    from fhpe_tpu_torch.cli import test as test_cli
    from fhpe_tpu_torch.config import load_config
    from fhpe_tpu_torch.tools.train_parity import STUDENT_YAML as FPD_YAML
    from fhpe_tpu_torch.utils import checkpoint as ck

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        mpii = root / "mpii"
        opts = ["OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
                "DATASET.ROOT", str(mpii), "DATASET.CACHE_ROOT", "",
                "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.DEAD_BIAS_SKIP", "True",
                "TRAIN.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "PRINT_FREQ", "1", "AUTO_RESUME", "True"]
        tcfg = load_config(str(FPD_YAML), opts)
        side = int(tcfg.MODEL.IMAGE_SIZE[0])
        write_mpii_sets(mpii, (side, side))
        tcfg.defrost()
        tcfg.merge_from_file(str(TEACHER_YAML))
        teacher_pth = root / "teacher.pth"
        ck.save_weights(str(teacher_pth), seeded_model(tcfg, 100))
        torchrun = [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "1",
                    "-m", "fhpe_tpu_torch.cli.fpd_train",
                    "--cfg", str(FPD_YAML), "--tcfg", str(TEACHER_YAML),
                    "--device", device.type, *opts,
                    "KD.TEACHER", str(teacher_pth)]
        run_dir = (root / "out" / "mpii" / "hourglass"
                   / f"{FPD_YAML.stem}_{DDP_RUN_TAG}")
        if device.type == "cuda":
            torch.cuda.empty_cache()

        def launch(end_epoch, name):
            """(wall s, rank 0's log messages, the checkpoint, where the
            launch's time went); the log holds every launch so far."""
            start = time.time()
            wall = run_process_group(
                torchrun + ["TRAIN.END_EPOCH", str(end_epoch)],
                root / f"{name}.log", DDP_CLI_TIMEOUT_S)
            stamped = [(datetime.datetime.strptime(m.group(1),
                                                   "%Y-%m-%d %H:%M:%S,%f"
                                                   ).timestamp(), m.group(2))
                       for m in map(re.compile(
                           r"^(\d{4}-\d\d-\d\d \S+) (.*)$").match,
                           (run_dir / "running.log").read_text().splitlines())
                       if m]
            now = [(t, msg) for t, msg in stamped if t >= start - 1]
            first_step = next(t for t, msg in now
                              if msg.startswith("Epoch: ["))
            split = (f"start-up to the first log line "
                     f"{now[0][0] - start:.1f} s, to the first train step "
                     f"{first_step - start:.1f} s, the rest "
                     f"{start + wall - first_step:.1f} s")
            saved = ck.load_checkpoint_file(str(run_dir / ck.CKPT_NAME))
            return wall, [msg for _, msg in stamped], saved, split

        steps = 2 * DDP_CLI_EPOCHS
        wall, lines, saved, split = launch(DDP_CLI_EPOCHS, "first")
        want_line = ("device: cuda:0, rank 0 of world size 1, backend nccl"
                     if device.type == "cuda" else
                     "device: cpu, rank 0 of world size 1, backend gloo")
        evals = sum(ln.startswith("Test: loss") for ln in lines)
        losses = [float(m.group(1)) for m in (re.search(
            r"Loss ([-\d.einaf]+) ", ln) for ln in lines
            if ln.startswith("Epoch: [")) if m]
        if (want_line not in lines or evals != 2 + DDP_CLI_EPOCHS
                or (saved["epoch"], saved["step"]) != (DDP_CLI_EPOCHS, steps)
                or len(losses) != steps
                or not all(math.isfinite(v) for v in losses)):
            raise AssertionError(
                f"ddp-cli: log names {want_line!r}: {want_line in lines}; "
                f"{evals} validations; checkpoint epoch {saved['epoch']} "
                f"step {saved['step']}; losses {losses}")
        log("ddp-cli", f"torchrun --nproc_per_node 1 cli.fpd_train: "
            f"{wall:.2f} s for the launch (interpreter, process group, "
            f"both pre-training validations, {DDP_CLI_EPOCHS} epochs of 2 "
            f"steps, a validation after each: {split}); logged "
            f"{want_line!r}; "
            f"losses {', '.join(f'{v:.5f}' for v in losses)}; "
            + cli_speeds(lines) + f"; {label}")

        wall, lines, saved, split = launch(DDP_CLI_EPOCHS + 1, "resume")
        adam = {int(s["step"]) for s in saved["optimizer"]["state"].values()}
        resumed = [ln for ln in lines
                   if ln.startswith(f"=> auto-resumed from epoch "
                                    f"{DDP_CLI_EPOCHS} ")]
        if len(resumed) != 1 or (saved["epoch"], saved["step"], adam) != (
                DDP_CLI_EPOCHS + 1, steps + 2, {steps + 2}):
            raise AssertionError(f"ddp-cli resume: {resumed}; checkpoint "
                                 f"epoch {saved['epoch']}, step "
                                 f"{saved['step']}, Adam steps {adam}")
        last = [re.search(r"\(perf ([-\d.]+),", ln).group(1) for ln in lines
                if ln.startswith("=> saving checkpoint")][-1]
        log("ddp-cli", f"resume launch {wall:.2f} s ({split}): "
            f"{resumed[0]}; "
            f"checkpoint at epoch {saved['epoch']}, step {saved['step']}, "
            f"Adam steps {sorted(adam)}; last PCKh Mean {last}")

        preds = loadmat(str(run_dir / "pred.mat"))["preds"]
        (run_dir / "pred.mat").rename(root / "torchrun_pred.mat")
        test = cli_run(test_cli, ["--cfg", str(FPD_YAML), "--device",
                                  str(device), *opts, "TEST.MODEL_FILE",
                                  str(run_dir / ck.FINAL_NAME)], totals)
        per_batch = math.ceil(MPII_PEOPLE / TRAIN_BATCH)
        check_cli("ddp-cli test", test, expected(
            device, decode_heatmaps=K1_PER_EVAL_BATCH * per_batch), 1, 0)
        got = test["vals"][0][2][:, :, 0:2] + 1.0
        if not np.array_equal(got, preds) or f"{test['result']:.4f}" != last:
            raise AssertionError(
                f"ddp-cli test: PCKh Mean {test['result']:.4f} against the "
                f"torchrun run's last {last}; predictions max |diff| "
                f"{np.abs(got - preds).max():.3g}")
        log("ddp-cli", f"cli.test on final_state.pth: PCKh Mean "
            f"{test['result']:.4f}, and all {preds.shape[0]} people's "
            f"predictions equal to the torchrun run's last validation "
            f"(its pred.mat)")


# -- phase 31: replicas and fhpe_tpu's weight files ---------------------------

def serve_both(p, crops, centers, scales, frame, boxes):
    """``predict_crops`` of the crops and ``predict`` of the frame."""
    return p.predict_crops(crops, centers, scales) + (p.predict(frame,
                                                                boxes),)


def serve_run(phase, p, request, device, totals):
    """:func:`serve_both` as one main-path run: per chunk and replica one
    decode launch and P5e's; returns the outputs."""
    crops, _, _, _, boxes = request
    outs, counts = main_path_run(totals, lambda: serve_both(p, *request))
    chunks = -(-len(crops) // p.batch_size) + -(-len(boxes) // p.batch_size)
    steps = chunks * len(p.devices)
    want = expected(device, decode_heatmaps=steps,
                    branch_chain_eval=chains_per_chunk(p) * steps)
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts} for {chunks} "
                             f"chunks on {len(p.devices)} replicas, want "
                             f"{want}")
    num_joints = int(p.cfg.MODEL.NUM_JOINTS)
    check_outputs(phase, outs[0], outs[1], len(crops), num_joints)
    if outs[2].shape != (len(boxes), num_joints, 3) or \
            not np.isfinite(outs[2]).all():
        raise AssertionError(f"{phase}: predict gave {outs[2].shape}")
    return outs, counts, chunks


def phase_replicas(device, totals, label, tmp: Path) -> None:
    """Phase 31: ``Predictor`` over replicas and from ``fhpe_tpu``'s
    ``.msgpack`` weights, W32 at full width (bf16, batch 32 per replica,
    flip test)."""
    import torch
    from fhpe_tpu_torch.serve import Predictor
    from fhpe_tpu_torch.utils import msgpack
    from fhpe_tpu_torch.utils.checkpoint import load_model_weights
    from fhpe_tpu_torch.utils.convert import variables_from_state_dict
    from fhpe_tpu_torch.utils.graph import storage_fingerprint

    w32 = serve_cfg(W32_YAML)
    one = Predictor(w32, he_model(w32, 200), device=device)
    two = Predictor(w32, he_model(w32, 200), device=[device, device])
    if two.batch_size != 2 * one.batch_size or two.models[1] is two.model:
        raise AssertionError(f"replicas: global batch {two.batch_size} for "
                             f"{one.batch_size} per replica")
    t0 = time.perf_counter()
    one.warmup()
    two.warmup()
    log("replicas", f"warmup of 1 + 2 replicas {time.perf_counter() - t0:.2f}"
        f" s ({len(one.steps) + len(two.steps)} serve graphs captured)")
    frames, boxes = make_frames(1, BOXES_PER_FRAME, seed=311)
    request = (*make_requests(w32, REPLICA_CROPS, 310), frames[0], boxes[0])

    # (a) two replicas against one: each replica's rows are a chunk of 32
    # as one replica runs it, so bit-equal
    out_one, c_one, k_one = serve_run("replicas", one, request, device,
                                      totals)
    out_two, c_two, k_two = serve_run("replicas", two, request, device,
                                      totals)
    if not all(np.array_equal(a, b) for a, b in zip(out_one, out_two)):
        raise AssertionError("replicas: 2 replicas != 1 replica")
    check_kernel_path_on_chunk("replicas", two, *request[:3], replica=1)
    log("replicas", f"{REPLICA_CROPS} crops and a frame of {len(boxes[0])} "
        f"boxes: 2 replicas on {two.devices} (global batch "
        f"{two.batch_size}) bit-equal to 1 (batch {one.batch_size}); "
        f"launches 1 replica: {k_one} chunks, decode "
        f"{c_one['decode_heatmaps']}, P5e {c_one['branch_chain_eval']}; 2 "
        f"replicas: {k_two} chunks, decode {c_two['decode_heatmaps']}, P5e "
        f"{c_two['branch_chain_eval']} ({chains_per_chunk(two)} per chunk "
        f"and replica)")
    t_crops, t_centers, t_scales = make_requests(w32, REPLICA_TIMED_CROPS,
                                                 312)
    rates = rates_in_turns(
        {"one": lambda: one.predict_crops(t_crops, t_centers, t_scales),
         "two": lambda: two.predict_crops(t_crops, t_centers, t_scales)},
        {"one": REPLICA_TIMED_CROPS, "two": REPLICA_TIMED_CROPS}, device)
    t0 = time.perf_counter()
    for _ in range(FINGERPRINT_CALLS):
        storage_fingerprint((two.models[1],))
    fp_us = (time.perf_counter() - t0) / FINGERPRINT_CALLS * 1e6
    log("replicas", f"persons/s of predict_crops ({REPLICA_TIMED_CROPS} "
        f"crops, medians of 3 in turns): 1 replica "
        f"{rates['one']:.1f}, 2 replicas on one card "
        f"{rates['two']:.1f}; the storage fingerprint "
        f"{fp_us:.1f} us of host per replica per chunk "
        f"({FINGERPRINT_CALLS} calls); {label}")

    # (b) fhpe_tpu's final_state layout, written by the port's writer
    path = tmp / "final_state.msgpack"
    variables = variables_from_state_dict(w32, one.model.state_dict())
    path.write_bytes(msgpack.packb(variables))
    t0 = time.perf_counter()
    sd = load_model_weights(str(path), w32)
    read_s = time.perf_counter() - t0
    if sd.keys() != one.model.state_dict().keys():
        raise AssertionError("msgpack: the state_dict's keys differ")
    loaded = Predictor.from_checkpoint(w32, str(path), device=device)
    loaded.warmup()
    out_mp, c_mp, _ = serve_run("msgpack", loaded, request, device, totals)
    if not all(np.array_equal(a, b) for a, b in zip(out_one, out_mp)):
        raise AssertionError("msgpack: from_checkpoint(.msgpack) != the "
                             "Predictor built from the state_dict")
    log("msgpack", f"{path.name}: {path.stat().st_size / 1e6:.1f} MB, "
        f"load_model_weights {read_s:.3f} s (read, unpack, map); "
        f"Predictor.from_checkpoint serves keypoints bit-equal to the "
        f"Predictor of the state_dict (decode {c_mp['decode_heatmaps']}, "
        f"P5e {c_mp['branch_chain_eval']}); {label}")
    del one, two, loaded


def summary_of(lines, title: str) -> tuple:
    """(parameters, GFLOPs, seconds of the count) of the model summary a
    CLI logged, the one after a ``title`` line (``Student:``,
    ``Teacher:``) or the first when ``title`` is empty."""
    for ln in lines:
        if "Total Parameters:" in ln and ln.startswith(title):
            params = int(re.search(r"Total Parameters: ([\d,]+)",
                                   ln).group(1).replace(",", ""))
            m = SUMMARY_LINE.search(ln)
            if m is None:
                raise AssertionError(f"summary {title!r} without its "
                                     f"FLOPs: {ln[-300:]}")
            return params, float(m.group(2)), float(m.group(1))
    raise AssertionError(f"no model summary {title!r} logged")


def check_dumps(phase, run_dir: Path, prefixes, shapes) -> int:
    """Each ``{prefix}_{gt,pred,hm_gt,hm_pred}.jpg`` in ``run_dir`` decodes
    through the image library at its grid's shape; returns their bytes."""
    from fhpe_tpu_torch.ops import native_image
    total = 0
    for prefix in prefixes:
        for kind in DUMPS:
            path = run_dir / f"{prefix}_{kind}.jpg"
            if not path.exists():
                raise AssertionError(f"{phase}: no {path.name} in {run_dir}")
            shape = native_image.imread(str(path)).shape
            if shape != shapes[kind]:
                raise AssertionError(f"{phase}: {path.name} decodes at "
                                     f"{shape}, the grid is {shapes[kind]}")
            total += path.stat().st_size
    return total


def phase_hrnet_cli(device, totals, label) -> None:
    """Phase 32: ``cli.fpd_train`` on W32 by W48 (bf16, batch 32, one
    epoch, ``PRINT_FREQ`` 1, ``DEBUG.DEBUG`` and every ``SAVE_*`` flag on)
    over synthetic COCO JPEGs, then ``cli.test`` on its
    ``final_state.pth``: launches, the dumps, the TensorBoard images, the
    Student and Teacher summaries; then a debug-captured FPD step against
    a plain-captured one from copies of one state."""
    import importlib.util

    import torch
    from fhpe_tpu_torch.cli import fpd_train as fpd_cli
    from fhpe_tpu_torch.cli import test as test_cli
    from fhpe_tpu_torch.config import load_config
    from fhpe_tpu_torch.data import make_synthetic_coco
    from fhpe_tpu_torch.models import get_pose_net, param_count
    from fhpe_tpu_torch.tools.train_parity import (HRNET_STUDENT_YAML,
                                                   HRNET_TEACHER_YAML,
                                                   hrnet_fpd_cfgs)
    from fhpe_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    scfg, tcfg = hrnet_fpd_cfgs()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        make_synthetic_coco(str(root / "coco"), "train2017",
                            LOADER_TRAIN_IMAGES, seed=0)
        make_synthetic_coco(str(root / "coco"), COCO_SET, CLI_COCO_VALID,
                            seed=1)
        opts = ["OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
                "DATASET.ROOT", str(root / "coco"), "DATASET.TRAIN_SET",
                "train2017", "DATASET.TEST_SET", COCO_SET,
                "DATASET.CACHE_ROOT", "", "TPU.COMPUTE_DTYPE", "bfloat16",
                "TRAIN.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "TEST.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "PRINT_FREQ", "1", *DEBUG_OPTS]
        # the CLI's configs: the student's, and the teacher file merged over
        # it (reference fpd_train.py:128-131)
        cli_s = load_config(str(HRNET_STUDENT_YAML), opts)
        cli_t = cli_s.clone()
        cli_t.defrost()
        cli_t.merge_from_file(str(HRNET_TEACHER_YAML))
        teacher_pth = root / "teacher.pth"
        ck.save_weights(str(teacher_pth), hrnet_pair(scfg, tcfg)[1])
        argv = ["--cfg", str(HRNET_STUDENT_YAML), "--tcfg",
                str(HRNET_TEACHER_YAML), "--device", str(device), *opts,
                "KD.TEACHER", str(teacher_pth), "TRAIN.END_EPOCH", "1"]
        batches = math.ceil(CLI_COCO_VALID / TRAIN_BATCH)
        steps = LOADER_TRAIN_IMAGES // TRAIN_BATCH

        def want(steps, vals):
            return expected(
                device,
                branch_chain_eval=HRNET_CHAINS * steps
                + 2 * HRNET_CHAINS * batches * vals,
                branch_chain_train=HRNET_CHAINS * steps,
                conv3x3_wgrad=HRNET_P4_PER_STEP * steps,
                decode_heatmaps=K1_PER_TRAIN_STEP * steps
                + K1_PER_EVAL_BATCH * batches * vals,
                oks_nms_segments=vals)

        run = cli_run(fpd_cli, argv, totals, "make_fpd_train_step")
        check_cli("hrnet-cli", run, want(steps, 3), 3, steps)
        run_dir = (root / "out" / "coco" / "pose_hrnet"
                   / f"{HRNET_STUDENT_YAML.stem}_{CLI_RUN_TAG}")
        for name in (ck.CKPT_NAME, ck.FINAL_NAME):
            if not (run_dir / name).exists():
                raise AssertionError(f"hrnet-cli: no {name} in {run_dir}")
        w, h = (int(v) for v in scfg.MODEL.IMAGE_SIZE)
        hw, hh = (int(v) for v in scfg.MODEL.HEATMAP_SIZE)
        joints = int(scfg.MODEL.NUM_JOINTS)
        nrow = min(8, TRAIN_BATCH)          # vis.joints_grid's layout
        grid = (math.ceil(TRAIN_BATCH / nrow) * (h + 2), nrow * (w + 2), 3)
        shapes = {"gt": grid, "pred": grid,
                  "hm_gt": (TRAIN_BATCH * hh, (joints + 1) * hw, 3),
                  "hm_pred": (TRAIN_BATCH * hh, (joints + 1) * hw, 3)}
        prefixes = ([f"train_0_{i}" for i in range(steps)]
                    + [f"val_{i}" for i in range(batches)])
        nbytes = check_dumps("hrnet-cli", run_dir, prefixes, shapes)
        tb = root / "log" / "coco" / "pose_hrnet" / run_dir.name
        events = sum(f.stat().st_size for f in tb.glob("events.*"))
        if importlib.util.find_spec("tensorboardX") is None:
            tb_text = "tensorboardX is not installed: no TensorBoard file"
        elif events < max(shapes["hm_gt"][0] * shapes["hm_gt"][1], 1):
            raise AssertionError(f"hrnet-cli: the TensorBoard events in {tb} "
                                 f"hold {events} bytes: no images")
        else:
            tb_text = (f"TensorBoard events {events / 1e6:.2f} MB (scalars "
                       f"and the first validation batch's 3 grids)")

        # the summaries: the CLI's models' parameters, and their FLOPs
        with torch.device("meta"):
            n_student = param_count(get_pose_net(cli_s))
            n_teacher = param_count(get_pose_net(cli_t))
        s_sum = summary_of(run["lines"], "Student:")
        t_sum = summary_of(run["lines"], "Teacher:")
        if (s_sum[0], t_sum[0]) != (n_student, n_teacher):
            raise AssertionError(f"hrnet-cli: summary parameters "
                                 f"{s_sum[0]}, {t_sum[0]}; the models have "
                                 f"{n_student}, {n_teacher}")
        log("hrnet-cli", f"model summaries counted on CPU copies: student "
            f"{s_sum[0]:,} parameters, {s_sum[1]} GFLOPs per image, in "
            f"{s_sum[2]:.2f} s; teacher {t_sum[0]:,}, {t_sum[1]} GFLOPs, "
            f"in {t_sum[2]:.2f} s (equal to the CLI's models' parameters)")
        ap = run["vals"][-1][0]
        log("hrnet-cli", f"{HRNET_STUDENT_YAML.name} by "
            f"{HRNET_TEACHER_YAML.name} (a .pth of phase 17's He-scale "
            f"teacher), DEBUG.DEBUG on, {LOADER_TRAIN_IMAGES} + "
            f"{CLI_COCO_VALID} synthetic COCO JPEGs: {run['wall']:.2f} s for "
            f"main(), 1 epoch of {run['steps']} steps, 3 validations, AP "
            f"{ap:.4f}; launches " + ", ".join(
                f"{k} {v}" for k, v in run["counts"].items() if v)
            + f"; {len(prefixes) * len(DUMPS)} dumps ({nbytes / 1e6:.2f} MB) "
            f"decode at their grids' shapes; {tb_text}")
        log("hrnet-cli", cli_speeds(run["lines"]) + f"; {label}")

        def mtimes():
            return [(run_dir / f"{p}_{k}.jpg").stat().st_mtime_ns
                    for p in prefixes[steps:] for k in DUMPS]

        before = mtimes()
        test = cli_run(test_cli, ["--cfg", str(HRNET_STUDENT_YAML),
                                  "--device", str(device), *opts,
                                  "TEST.MODEL_FILE",
                                  str(run_dir / ck.FINAL_NAME)], totals)
        check_cli("hrnet-cli test", test, want(0, 1), 1, 0)
        verdict = same_perf("hrnet-cli test", test["vals"][0],
                            run["vals"][-1])
        check_dumps("hrnet-cli test", run_dir, prefixes[steps:], shapes)
        if any(a == b for a, b in zip(before, mtimes())):
            raise AssertionError("hrnet-cli test: the val dumps were not "
                                 "written again")
        if summary_of(test["lines"], "")[0] != n_student:
            raise AssertionError("hrnet-cli test: summary parameters")
        log("hrnet-cli", f"cli.test on final_state.pth, DEBUG.DEBUG on: AP "
            f"{test['result']:.6f}, the last validation's {ap:.6f}: "
            f"{verdict}; its {len(before)} val dumps written again; "
            + cli_speeds(test["lines"]) + f"; {label}")
    phase_debug_step(device, totals, scfg, tcfg)
    log("hrnet-cli", f"phase 32 in {time.perf_counter() - t_phase:.1f} s; "
        f"{label}")


def phase_debug_step(device, totals, scfg, tcfg) -> None:
    """Phase 32 (end): the W48 -> W32 FPD step captured with
    ``debug_outputs`` against the same step captured without, from
    copies of one state on one resident batch, 2 calls each (the capture
    call, then a replay): equal launches, bit-equal losses and parameters
    wherever a second plain run is bit-equal to the first (elsewhere within
    phase 27's spread), and the debug outputs finite heatmaps of the
    step's shape."""
    from fhpe_tpu_torch.tools.train_parity import train_batch
    from fhpe_tpu_torch.train import (create_train_state,
                                      make_batch_preprocessor,
                                      make_fpd_train_step)

    student, teacher = hrnet_pair(scfg, tcfg)
    teacher = teacher.to(device)
    base = create_train_state(scfg, student, device=device)
    batch = train_batch(scfg, TRAIN_BATCH, seed=32, device=device)
    runs = {}
    for tag in ("debug", "plain", "plain2"):
        state = copy.deepcopy(base)
        step = make_fpd_train_step(scfg, teacher, tcfg,
                                   prepare=make_batch_preprocessor(scfg),
                                   debug_outputs=tag == "debug")
        metrics, counts = main_path_run(totals, lambda: [
            step(state, batch)[1] for _ in range(2)])
        sync(device)
        runs[tag] = (state, metrics, counts)
    (d_state, d_metrics, d_counts), (_, _, p_counts) = (runs["debug"],
                                                        runs["plain"])
    if d_counts != p_counts:
        raise AssertionError(f"debug-step: launches {d_counts} with debug "
                             f"outputs, {p_counts} without")
    out, target = d_metrics[-1]["output"], d_metrics[-1]["target"]
    hw, hh = (int(v) for v in scfg.MODEL.HEATMAP_SIZE)
    shape = (TRAIN_BATCH, int(scfg.MODEL.NUM_JOINTS), hh, hw)
    if (tuple(out.shape), tuple(target.shape)) != (shape, shape) or not (
            bool(out.isfinite().all()) and bool(target.isfinite().all())):
        raise AssertionError(f"debug-step: output {tuple(out.shape)}, "
                             f"target {tuple(target.shape)}, want {shape}")

    def grouped(tag):
        state, metrics, _ = runs[tag]
        groups = {"params": dict(state.model.named_parameters()),
                  "buffers": dict(state.model.named_buffers())}
        groups["metrics"] = {f"{k}@{i}": v for i, m in enumerate(metrics)
                             for k, v in m.items()
                             if k not in ("output", "target")}
        return groups

    agree = graph_agreement(grouped("debug"), grouped("plain"),
                            grouped("plain2"))
    log("debug-step", f"W48 -> W32 FPD step captured with debug outputs "
        f"against without, 2 calls each from one state (bf16, batch "
        f"{TRAIN_BATCH}): launches equal ({sum(d_counts.values())} each); "
        + "; ".join(
            f"{g} {n_self}/{n} tensors equal in two plain runs, the debug "
            f"run bit-equal on {n_eq} of them" + (
                f", the rest relative L2 {rg:.3g} against the plain runs' "
                f"{re_:.3g}" if n_self < n else "")
            for g, (n, n_self, n_eq, rg, re_) in agree.items()))


# -- phase 33: the stall watchdog and AUTO_RESUME -----------------------------

STALL_WORKER = """\
\"\"\"chip_smoke.py phase 33's torchrun worker: cli.fpd_train with the stall
watchdog; in attempt 0 a device spin after epoch 1's first step.

Usage: stall_worker.py RECORD_DIR RUN_DIR SPIN_S CLI_ARGV...  Writes
RECORD_DIR/attempt{N}.json: the times of the start, of the card's first
answer, of the last beat and of the exit (by wrapping the watchdog's beat
and os._exit), and in attempt 1 the checkpoint attempt 0 left (copied to
RECORD_DIR/checkpoint_epoch1.pth) and the kernel launches.
\"\"\"
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

from fhpe_tpu_torch.cli import fpd_train
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils import watchdog
from fhpe_tpu_torch.utils.graph import launch_counters

RECORD, RUN_DIR, SPIN_S = Path(sys.argv[1]), Path(sys.argv[2]), float(
    sys.argv[3])
ATTEMPT = int(os.environ["TORCHELASTIC_RESTART_COUNT"])
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
rec = {"attempt": ATTEMPT, "start": time.time()}


def save():
    (RECORD / f"attempt{ATTEMPT}.json").write_text(json.dumps(rec))


beat = watchdog.StallWatchdog.beat


def timed_beat(self):
    rec["last_beat"] = time.time()
    beat(self)


real_exit = os._exit


def timed_exit(code):
    rec["exit"], rec["code"] = time.time(), code
    save()
    real_exit(code)


watchdog.StallWatchdog.beat = timed_beat
os._exit = timed_exit
# a CPU rehearsal (--device cpu) blocks the host where the card spins
ON_CARD = sys.argv[sys.argv.index("--device") + 1] != "cpu"
if ON_CARD:
    torch.zeros(1, device="cuda").sum().item()
rec["card_ready"] = time.time()

if ATTEMPT == 0:
    rate = 0.0
    if ON_CARD:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(100_000_000)
        end.record()
        end.synchronize()
        rate = 1e8 / (start.elapsed_time(end) / 1e3)
    make = fpd_train.make_fpd_train_step

    def spinning(*a, **k):
        step, calls = make(*a, **k), [0]

        def run(state, batch):
            out = step(state, batch)
            calls[0] += 1
            if calls[0] == 3:       # epoch 1's first step
                rec["spin_enqueued"] = time.time()
                rec["spin_cycles"] = int(SPIN_S * rate)
                if ON_CARD:
                    torch.cuda._sleep(rec["spin_cycles"])
                else:
                    time.sleep(SPIN_S)
            return out
        return run

    fpd_train.make_fpd_train_step = spinning
else:
    saved = ck.load_checkpoint_file(str(RUN_DIR / ck.CKPT_NAME))
    sd = saved["state_dict"]
    rec["ckpt"] = {
        "keys": sorted(saved), "epoch": saved["epoch"],
        "step": saved["step"], "perf": saved["perf"], "tensors": len(sd),
        "adam_steps": sorted({float(st["step"]) for st in
                              saved["optimizer"]["state"].values()}),
        "param_sum": repr(sum(float(v.double().sum()) for k, v in sd.items()
                              if not k.endswith(BUFFERS)))}
    shutil.copy(RUN_DIR / ck.CKPT_NAME, RECORD / "checkpoint_epoch1.pth")
save()
fpd_train.main(sys.argv[4:])
rec["end"] = time.time()
rec["launches"] = {name: getattr(m, attr)
                   for name, (m, attr) in launch_counters().items()}
save()
"""


def thread_dump(text: str) -> list:
    """The main thread's frames in a ``faulthandler`` dump, innermost
    first, as (file, function): the thread whose outermost frame is the
    script's ``<module>``."""
    blocks, cur = [], None
    for line in text.splitlines():
        if re.match(r"^(Current thread|Thread) 0x[0-9a-f]+ \(most recent "
                    r"call first\):", line):
            cur = []
            blocks.append(cur)
        elif cur is not None:
            m = re.match(r'^\s+File "(.+)", line \d+ in (\S+)', line)
            if m:
                cur.append(m.groups())
            elif line.strip():
                cur = None
    main = [b for b in blocks if b and b[-1][1] == "<module>"]
    return main[-1] if main else []


def log_times(path: Path) -> list:
    """(epoch seconds, message) of each line of a run's ``running.log``."""
    out = []
    for line in path.read_text().splitlines():
        m = re.match(r"^(\d{4}-\d\d-\d\d \S+) (.*)$", line)
        if m:
            out.append((datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(), m.group(2)))
    return out


def phase_stall_restart(device, totals, label) -> None:
    """Phase 33 (see the module docstring): (a) a stalled FPD run through
    torchrun's restart, (b) AUTO_RESUME from ``fhpe_tpu``'s
    ``checkpoint.msgpack``."""
    import torch
    from scipy.io import loadmat
    from fhpe_tpu_torch.cli import fpd_train as fpd_cli
    from fhpe_tpu_torch.cli import test as test_cli
    from fhpe_tpu_torch.config import load_config
    from fhpe_tpu_torch.tools.train_parity import STUDENT_YAML as FPD_YAML
    from fhpe_tpu_torch.train import create_train_state
    from fhpe_tpu_torch.utils import checkpoint as ck
    from fhpe_tpu_torch.utils import msgpack
    from fhpe_tpu_torch.utils.convert import checkpoint_tree_from_state

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        mpii, record = root / "mpii", root / "record"
        record.mkdir()
        opts = ["OUTPUT_DIR", str(root / "out"), "LOG_DIR", str(root / "log"),
                "DATASET.ROOT", str(mpii), "DATASET.CACHE_ROOT", "",
                "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.DEAD_BIAS_SKIP", "True",
                "TRAIN.BATCH_SIZE_PER_GPU", str(TRAIN_BATCH),
                "PRINT_FREQ", "1", "AUTO_RESUME", "True",
                "TPU.STALL_TIMEOUT_S", str(STALL_TIMEOUT_S)]
        scfg = load_config(str(FPD_YAML), opts)
        side = int(scfg.MODEL.IMAGE_SIZE[0])
        write_mpii_sets(mpii, (side, side))
        tcfg = scfg.clone()
        tcfg.defrost()
        tcfg.merge_from_file(str(TEACHER_YAML))
        teacher_pth = root / "teacher.pth"
        ck.save_weights(str(teacher_pth), seeded_model(tcfg, 100))
        argv = ["--cfg", str(FPD_YAML), "--tcfg", str(TEACHER_YAML),
                "--device", device.type, *opts, "KD.TEACHER",
                str(teacher_pth), "TRAIN.END_EPOCH", "2"]
        run_dir = (root / "out" / "mpii" / "hourglass"
                   / f"{FPD_YAML.stem}_{STALL_RUN_TAG}")
        worker = root / "stall_worker.py"
        worker.write_text(STALL_WORKER)
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # (a) attempt 0 stalls and exits 86; torchrun restarts it
        log_path = root / "torchrun.log"
        wall = run_process_group(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "--max-restarts", "1", str(worker),
             str(record), str(run_dir), str(STALL_SPIN_S), *argv],
            log_path, STALL_LAUNCH_TIMEOUT_S, tag=STALL_RUN_TAG)
        a0, a1 = (json.loads((record / f"attempt{i}.json").read_text())
                  for i in (0, 1))
        out = log_path.read_text()
        lines = log_times(run_dir / "running.log")
        msgs = [m for _, m in lines]
        bound = STALL_TIMEOUT_S + min(max(STALL_TIMEOUT_S / 4, 0.05), 30.0) \
            + 30.0      # timeout, a poll, the callbacks' budget
        stall = a0.get("exit", math.inf) - a0.get("last_beat", -math.inf)
        fires = [m for m in msgs if m.startswith("STALL WATCHDOG")]
        frames = thread_dump(out)
        top = frames[0][1] if frames else None
        if (a0.get("code") != 86 or not stall <= bound or len(fires) != 1
                or top not in CUDA_WAITS):
            raise AssertionError(
                f"stall: attempt 0 {a0}; {stall:.2f} s from the last beat "
                f"to the exit (bound {bound}); watchdog lines {fires}; main "
                f"thread {frames[:4]}; log tail:\n{out[-4000:]}")
        log("stall", f"attempt 0: device spin of {STALL_SPIN_S:g} s "
            f"({a0['spin_cycles']:,} cycles) enqueued after epoch 1's first "
            f"step; exit {a0['code']} {stall:.2f} s after its last beat "
            f"(timeout {STALL_TIMEOUT_S} s, bound {bound:g} s), "
            f"{a0['exit'] - a0['spin_enqueued']:.2f} s after the spin was "
            f"enqueued (the last beat "
            f"{a0['last_beat'] - a0['spin_enqueued']:+.2f} s from it); "
            f"{fires[0]!r}; main thread blocked in "
            + " <- ".join(f"{Path(f).name}:{fn}" for f, fn in frames[:4]))
        agent = [ln.strip() for ln in out.splitlines()
                 if re.search(r"exitcode|restart", ln, re.I)
                 and "[rank" not in ln][:3]
        log("stall", "torchrun's agent: " + " | ".join(agent))

        ck1 = a1["ckpt"]
        resumed = [m for m in msgs if m.startswith(
            "=> auto-resumed from epoch 1 ")]
        saved = ck.load_checkpoint_file(str(run_dir / ck.CKPT_NAME))
        if ((ck1["epoch"], ck1["step"], ck1["adam_steps"]) != (1, 2, [2.0])
                or not {"state_dict", "optimizer", "epoch", "perf",
                        "step"} <= set(ck1["keys"])
                or len(resumed) != 1
                or f"parameter sum {ck1['param_sum']})" not in resumed[0]
                or (saved["epoch"], saved["step"]) != (2, 4)
                or not (run_dir / ck.FINAL_NAME).exists()):
            raise AssertionError(f"stall: attempt 1 found {ck1}; resumed "
                                 f"{resumed}; checkpoint at epoch "
                                 f"{saved['epoch']}, step {saved['step']}")
        first_step = next(t for t, m in lines
                          if t >= a1["start"] and m.startswith("Epoch: ["))
        log("stall", f"attempt 1: started {a1['start'] - a0['exit']:.2f} s "
            f"after attempt 0's exit, the card answered "
            f"{a1['card_ready'] - a0['exit']:.2f} s after it (its own "
            f"start-up to the card {a1['card_ready'] - a1['start']:.2f} s, "
            f"attempt 0's {a0['card_ready'] - a0['start']:.2f} s); first "
            f"train step {first_step - a1['start']:.2f} s after its start; "
            f"{resumed[0]}; checkpoint at epoch {saved['epoch']}, step "
            f"{saved['step']}; attempt 1 {a1['end'] - a1['start']:.2f} s, "
            f"attempt 0 {a0['exit'] - a0['start']:.2f} s, the whole "
            f"launch {wall:.2f} s; attempt 1's launches "
            + ", ".join(f"{k} {v}" for k, v in a1["launches"].items() if v)
            + f"; {label}")

        last = [re.search(r"\(perf ([-\d.]+),", m).group(1) for m in msgs
                if m.startswith("=> saving checkpoint")][-1]
        preds = loadmat(str(run_dir / "pred.mat"))["preds"]
        test = cli_run(test_cli, ["--cfg", str(FPD_YAML), "--device",
                                  str(device), *opts, "TEST.MODEL_FILE",
                                  str(run_dir / ck.FINAL_NAME)], totals)
        per_batch = math.ceil(MPII_PEOPLE / TRAIN_BATCH)
        check_cli("stall test", test, expected(
            device, decode_heatmaps=K1_PER_EVAL_BATCH * per_batch), 1, 0)
        got = test["vals"][0][2][:, :, 0:2] + 1.0
        if not np.array_equal(got, preds) or f"{test['result']:.4f}" != last:
            raise AssertionError(
                f"stall test: PCKh Mean {test['result']:.4f} against the "
                f"restarted run's last {last}; predictions max |diff| "
                f"{np.abs(got - preds).max():.3g}")
        log("stall", f"cli.test on final_state.pth: PCKh Mean "
            f"{test['result']:.4f}, and all {preds.shape[0]} people's "
            f"predictions equal to the restarted run's last validation")

        # (b) the epoch-1 state as fhpe_tpu's checkpoint.msgpack
        pth_dir, run_b = root / "pth", (root / "msgpack_out" / "mpii"
                                        / "hourglass"
                                        / f"{FPD_YAML.stem}_{CLI_RUN_TAG}")
        pth_dir.mkdir()
        run_b.mkdir(parents=True)
        (record / "checkpoint_epoch1.pth").rename(pth_dir / ck.CKPT_NAME)
        written, epoch, perf = ck.auto_resume(
            str(pth_dir), create_train_state(scfg, seed=1, device=device))
        tree = checkpoint_tree_from_state(scfg, written.model,
                                          written.optimizer, written.step,
                                          epoch, perf)
        t0 = time.perf_counter()
        data = msgpack.packb(tree)
        (run_b / ck.JAX_CKPT_NAME).write_bytes(data)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, b_epoch, b_perf = ck.auto_resume(
            str(run_b), create_train_state(scfg, seed=2, device=device), scfg)
        t_read = time.perf_counter() - t0
        differ = [k for k, v in written.model.state_dict().items()
                  if not k.endswith("num_batches_tracked")
                  and not torch.equal(v, back.model.state_dict()[k])]
        opt_w = written.optimizer.state_dict()["state"]
        opt_b = back.optimizer.state_dict()["state"]
        differ += [f"{i}:{key}" for i, st in opt_w.items() for key in st
                   if not torch.equal(torch.as_tensor(st[key]).cpu(),
                                      torch.as_tensor(opt_b[i][key]).cpu())]
        if (differ or (b_epoch, b_perf, back.step) != (epoch, perf,
                                                       written.step)
                or len(opt_b) != len(opt_w)):
            raise AssertionError(f"msgpack resume: {len(differ)} tensors "
                                 f"differ ({differ[:5]}); epoch {b_epoch}, "
                                 f"perf {b_perf}, step {back.step}")
        n_tensors = sum(1 for k in written.model.state_dict()
                        if not k.endswith("num_batches_tracked"))
        log("msgpack-resume", f"attempt 0's epoch-1 state as fhpe_tpu's "
            f"checkpoint.msgpack: {len(data) / 1e6:.2f} MB written in "
            f"{t_write:.3f} s, resumed in {t_read:.3f} s bit-equal (float32): "
            f"{n_tensors} weight and BN tensors, Adam's moments and step of "
            f"{len(opt_w)} parameters, step {back.step}, epoch {b_epoch}, "
            f"perf {b_perf}")
        del written, back
        torch.cuda.empty_cache()

        # the watchdog stays armed: a healthy run in this process must not
        # fire (a fire would end this script with code 86)
        argv_b = [a.replace(str(root / "out"), str(root / "msgpack_out"))
                  for a in argv]
        run = cli_run(fpd_cli, argv_b, totals, "make_fpd_train_step")
        check_cli("msgpack-resume", run, expected(
            device, conv3x3_wgrad=P4_PER_STEP * 2,
            decode_heatmaps=K1_PER_TRAIN_STEP * 2
            + K1_PER_EVAL_BATCH * per_batch * 3), 3, 2)
        read = [m for m in run["lines"] if "resume checkpoint" in m]
        resumed_b = [m for m in run["lines"]
                     if m.startswith("=> auto-resumed from epoch 1 ")]
        saved_b = ck.load_checkpoint_file(str(run_b / ck.CKPT_NAME))
        adam = {float(st["step"]) for st in
                saved_b["optimizer"]["state"].values()}
        if (len(read) != 1 or not read[0].endswith(ck.JAX_CKPT_NAME)
                or len(resumed_b) != 1
                or (saved_b["epoch"], saved_b["step"], adam) != (2, 4, {4.0})):
            raise AssertionError(f"msgpack-resume: read {read}, resumed "
                                 f"{resumed_b}, checkpoint epoch "
                                 f"{saved_b['epoch']} step {saved_b['step']} "
                                 f"Adam {adam}")
        tap = LogTap()
        logging.getLogger().addHandler(tap)
        try:
            again, a_epoch, _ = ck.auto_resume(
                str(run_b), create_train_state(scfg, seed=3, device=device),
                scfg)
        finally:
            logging.getLogger().removeHandler(tap)
        read2 = [m for m in tap.lines if "resume checkpoint" in m]
        if (a_epoch, again.step) != (2, 4) or not (
                read2 and read2[-1].endswith(ck.CKPT_NAME)):
            raise AssertionError(f"msgpack-resume: the second resume read "
                                 f"{read2}, epoch {a_epoch}")
        del again
        final_a = ck.load_model_weights(str(run_dir / ck.CKPT_NAME))
        final_b = saved_b["state_dict"]
        gap = max((final_a[k].double() - final_b[k].double()).abs().max()
                  .item() for k in final_a
                  if not k.endswith("num_batches_tracked"))
        log("msgpack-resume", f"cli.fpd_train resumed from it in "
            f"{run['wall']:.2f} s: {read[0]!r}; {resumed_b[0]}; epoch 1's "
            f"2 steps and 3 validations, checkpoint.pth at epoch 2, step 4, "
            f"Adam steps 4; a second resume read {Path(read2[-1].split()[-1]).name}"
            f"; against attempt 1's epoch-2 checkpoint (the same state and "
            f"data through the torchrun run) max |diff| {gap:.3g}; "
            f"launches " + ", ".join(f"{k} {v}" for k, v in
                                     run["counts"].items() if v))
    log("stall", f"phase 33 in {time.perf_counter() - t_phase:.1f} s; "
        f"{label}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fhpe_tpu_torch.data.coco_synthetic import (synthetic_coco_gt,
                                                    write_coco_gt)
    from fhpe_tpu_torch.ops import _build, native_image
    from fhpe_tpu_torch.tools.train_parity import hrnet_fpd_cfgs, rn50_cfg
    from fhpe_tpu_torch.utils.profiling import card_label

    device = torch.device("cuda", 0)
    label = card_label()
    log("device", f"{label} ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:     # g++ beside the nvcc processes
        image_lib = pool.submit(native_image.build)
        lib_path = _build.build()
        _build.load_library()
        image_path = image_lib.result()
    log("build", f"{lib_path.relative_to(REPO)} and "
        f"{image_path.relative_to(REPO)} (JPEG route "
        f"{native_image.route()}) in {time.perf_counter() - t0:.2f} s")

    stats = {"decode_heatmaps": phase_kernel_vs_plain(device),
             **phase_nms_kernels(device),
             "conv3x3_wgrad": phase_wgrad_kernel(device),
             **phase_chain_kernels(device),
             **phase_conv_kernel(device)}
    phase_nms_coco_scale(device)
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
    # phase 14b writes the synthetic MPII sets that phase 25 reads again
    with tempfile.TemporaryDirectory(dir=build_dir) as mpii_tmp:
        mpii = Path(mpii_tmp) / "mpii"
        phase_loader(state, device, totals, label, mpii)

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
        del state
        torch.cuda.empty_cache()
        phase_fpd_cli(device, totals, label, mpii)
    phase_rn50_cli(device, totals, label)
    phase_graphs(device, totals, label)
    phase_frame_serving(device, totals, label)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_canvas_step(device, totals, label, Path(tmp) / "mpii")
    phase_ddp_step(device, totals, label)
    phase_ddp_cli(device, totals, label)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        phase_replicas(device, totals, label, Path(tmp))
    phase_hrnet_cli(device, totals, label)
    phase_stall_restart(device, totals, label)

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
