"""Train, FPD and eval steps, on one device or data-parallel.

Counterpart of ``fhpe_tpu/train/step.py`` (the reference's hot loops,
``lib/core/function.py:28-332``).  Where ``fhpe_tpu`` compiles each step
with ``jax.jit``, here each step's body is captured as a CUDA graph on
the card, once per input signature, and replayed
(``utils/graph.py::CapturedStep``); on the CPU the body runs as it is.
Every step keeps its body as ``step.eager``:

* :func:`make_train_step`: forward, loss (MSE or OHKM), backward,
  optimizer step, PCK counts on the device;
* :func:`make_fpd_train_step`: adds the teacher forward (eval mode, no
  gradient: ``fhpe_tpu``'s deliberate fix of the reference's undetached
  teacher, function.py:120-122) and the ``(1-alpha)*pose + alpha*kd``
  mixing (function.py:134);
* :func:`make_eval_step`: forward with the flip test (input W-flip,
  ``flip_back``, SHIFT_HEATMAP 1-px right shift, 0.5 average;
  function.py:218-240), loss masked over padded rows, decode.

Every argmax (the decode and both sides of the PCK counts) goes through
the decode kernel K1 (``ops/decode.py``); every 3x3 stride-1 filter
gradient of the student's backward through the P4 kernel
(``ops/conv_wgrad.py``, via ``models/common.py::Conv3x3``).

In a process group (``parallel/mesh.py``, one process per device under
``torchrun``) the train bodies call the collectives where ``fhpe_tpu``'s
SPMD steps call ``pmean`` / ``psum`` (``fhpe_tpu/train/step.py:196-219``,
``:264-292``): the gradients and the losses are averaged over the ranks,
the PCK counts summed before they are finalized, and after the update the
BatchNorm running statistics are reconciled by ``TPU.BN_STATS``
(``device0``: rank 0's, as DataParallel keeps its master replica's
buffers; ``mean``: their average).  They sit inside the body, so on the
card the graph captures them.  Without a group they do nothing.  The
eval step has none: validation runs on rank 0 alone.  Metrics stay
device tensors until the caller reads them, fresh ones each step (never
the graph's own outputs).  With ``debug_outputs`` each step also returns
its final heatmaps and targets, ``"output"`` and ``"target"`` (the eval
step's output flip-merged), for the ``DEBUG.*`` image dumps
(``utils/vis.py``), as ``fhpe_tpu``'s steps do; without it the body, and
so the captured graph, is the one it was.  BatchNorm keeps its running
statistics as torch does in train mode (``fhpe_tpu``'s
``_TorchBatchNorm`` rebuilds those semantics).  The bodies build no tensor from host data after their
first call and never read the card, so that they can be captured.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..geometry.flip import flip_back_torch
from ..geometry.targets import generate_target_torch
from ..models import is_multi_output
from ..ops.decode import decode_argmax, decode_heatmaps
from ..ops.preprocess import normalize_images, warp_affine
from ..parallel import all_reduce_mean_, all_reduce_sum_, broadcast_
from ..utils.dtype import autocast, compute_dtype
from ..utils.graph import CapturedStep, constant, storage_fingerprint
from ..utils.spans import span
from .loss import fpd_loss, stacked_mse_loss, stacked_ohkm_loss
from .state import TrainState


def make_batch_preprocessor(cfg, joints_weight=None):
    """On-device preprocessing (``TPU.DEVICE_PREPROCESS``).

    The batch carries raw uint8 crops ``image`` (B, H, W, 3) with
    ``joints`` (B, J, 2) and ``joints_vis`` (B, J) on the device; the
    closure normalizes (/255, ImageNet mean/std) to NCHW float32 and
    stamps the Gaussian targets (B, J, h, w) and ``target_weight`` (B, J).
    With ``TPU.DEVICE_WARP`` the batch carries uint8 letterbox canvases
    ``canvas`` (B, Hc, Wc, 3) and their dst->canvas matrices ``warp_inv``
    (B, 2, 3) in place of ``image``: the closure first crops them to the
    model input (``ops/preprocess.py::warp_affine``).  A batch that
    already has ``target`` (and no canvas) is returned as it is.
    """
    img_size = tuple(cfg.MODEL.IMAGE_SIZE)      # (W, H)
    hm_size = tuple(cfg.MODEL.HEATMAP_SIZE)     # (W, H)
    sigma = cfg.MODEL.SIGMA
    use_diff = bool(cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT)
    jw = None
    if use_diff and joints_weight is not None:
        jw = np.asarray(joints_weight, dtype=np.float32).reshape(-1)

    def prepare(batch):
        out = dict(batch)
        if "canvas" in batch:
            out["image"] = normalize_images(warp_affine(
                batch["canvas"], batch["warp_inv"], img_size))
        elif "target" in batch:
            return batch
        else:
            out["image"] = normalize_images(batch["image"])
        if "target" not in batch:
            out["target"], out["target_weight"] = generate_target_torch(
                batch["joints"], batch["joints_vis"], hm_size, img_size,
                sigma, joints_weight=jw, use_different_joints_weight=use_diff)
        return out

    return prepare


def _identity_prepare(batch):
    if batch["image"].dtype != torch.uint8:
        return batch
    return dict(batch, image=normalize_images(batch["image"]))


def _pck_counts(output, target, sample_mask=None):
    """(hits, valids) per joint for the global-PCK meter (eval/pck.py
    semantics as summable counts).  output/target (B, J, H, W) float32;
    ``sample_mask`` (B,) excludes padded rows.  Both argmaxes run on the
    decode kernel K1 (``decode_argmax`` without the quarter offset)."""
    pred, _ = decode_argmax(output.contiguous(), post_process=False)
    gt, _ = decode_argmax(target.contiguous(), post_process=False)
    h, w = output.shape[2], output.shape[3]
    norm = constant((h / 10.0, w / 10.0), torch.float32, output.device)
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    if sample_mask is not None:
        valid = valid & (sample_mask > 0)[:, None]
    d = torch.linalg.vector_norm((pred - gt) / norm, dim=-1)
    hit = (d < 0.5) & valid
    return hit.sum(0, dtype=torch.int32), valid.sum(0, dtype=torch.int32)


def _per_sample_loss(output, target, target_weight, use_ohkm, topk):
    """Per-sample criterion value (B,), the reference loss per row."""
    diff = output - target
    if target_weight is not None:
        diff = diff * target_weight[:, :, None, None]
    if use_ohkm:
        per_joint = 0.5 * torch.mean(torch.square(diff), dim=(-2, -1))
        return torch.topk(per_joint, topk, dim=-1).values.sum(-1) / topk
    return 0.5 * torch.mean(torch.square(diff), dim=(-3, -2, -1))


def _finalize_pck(hits, valids):
    """Macro PCK (reference accuracy(): per-joint acc averaged over joints
    with valid samples; cnt = number of counted joints, evaluate.py:62-68)."""
    per_joint = torch.where(valids > 0, hits / valids.clamp(min=1), -1.0)
    has = per_joint >= 0
    cnt = has.sum()
    total = torch.where(has, per_joint, 0.0).sum()
    avg = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
    return per_joint, avg, cnt


def _input(model, image):
    """The image in the model's parameter dtype (float64 only in the CPU
    parity mode; bf16 runs under autocast on float32 parameters)."""
    return image.to(next(model.parameters()).dtype)


def _stacked(outputs, multi_output: bool):
    """(stacked outputs for the loss, last output)."""
    if multi_output:
        return torch.stack(list(outputs)), outputs[-1]
    return outputs, outputs


def _resolve_bn_stats(cfg, bn_stats):
    """Resolve + validate the BN-stats reconciliation mode.

    Only "device0" (DataParallel-faithful) and "mean" are valid: every
    rank keeps the same running statistics, so per-device ("local") ones
    would let the ranks' models drift apart."""
    if bn_stats is None:
        bn_stats = cfg.TPU.get("BN_STATS", "device0")
    if bn_stats not in ("device0", "mean"):
        raise ValueError(
            f"TPU.BN_STATS must be 'device0' or 'mean', got '{bn_stats}'")
    return bn_stats


def _metrics(losses: dict, final, target):
    """The losses averaged over the ranks, and the PCK finalized from the
    ranks' summed counts."""
    with torch.no_grad():
        losses = {k: v.detach() for k, v in losses.items()}
        all_reduce_mean_(list(losses.values()))
        hits, valids = _pck_counts(final.detach(), target)
        all_reduce_sum_([hits, valids])
        per_joint, avg, cnt = _finalize_pck(hits, valids)
    return {**losses, "acc": avg, "acc_cnt": cnt, "per_joint_acc": per_joint}


def _with_debug(outputs: dict, debug_outputs: bool, output, target) -> dict:
    """``outputs``, with ``"output"`` and ``"target"`` when
    ``debug_outputs``."""
    if debug_outputs:
        outputs.update(output=output.detach(), target=target)
    return outputs


def _update(state: TrainState, loss) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_mean_([p.grad for p in state.model.parameters()])
    state.optimizer.step()


def _reconcile_bn(model: nn.Module, bn_stats: str) -> None:
    """Every rank's BatchNorm running mean and variance made equal
    (``num_batches_tracked`` is equal already): rank 0's
    (``device0``) or their average (``mean``)."""
    stats = [t for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.running_mean is not None
             for t in (m.running_mean, m.running_var)]
    with torch.no_grad():
        if bn_stats == "device0":
            broadcast_(stats, src=0)
        else:
            all_reduce_mean_(stats)


def _compiled_train_step(body, teacher=None) -> Callable:
    """``(state, batch) -> (state, metrics)`` around ``body(state, batch)
    -> metrics``: the student in train mode (the teacher in eval mode),
    the body captured on the card (:class:`CapturedStep`, over the
    student's, the teacher's and the optimizer's storage), and
    ``state.step`` counted on the host; setting the modes is the
    ``fhpe.train.modes`` span.  ``.eager`` is the same step with the body
    run as it is; ``.captured`` the :class:`CapturedStep`."""
    modules = () if teacher is None else (teacher,)
    captured = CapturedStep(body, lambda state: storage_fingerprint(
        (state.model, *modules), state.optimizer))

    def wrap(run):
        def step(state: TrainState, batch):
            with span("fhpe.train.modes"):
                state.model.train()
                if teacher is not None:
                    teacher.eval()
            metrics = run(state, batch)
            state.step += 1
            return state, metrics
        return step

    step = wrap(captured)
    step.eager = wrap(body)
    step.captured = captured
    return step


def make_train_step(cfg, prepare=None, bn_stats=None,
                    debug_outputs: bool = False) -> Callable:
    """``(state, batch) -> (state, metrics)``: one supervised step.

    batch: {"image" (B, 3, H, W) float or (B, H, W, 3) uint8, "target"
    (B, J, h, w), "target_weight" (B, J)} on the state's device (this
    rank's slice of the global batch in a process group), or the raw
    batch a ``prepare`` closure (:func:`make_batch_preprocessor`) takes.
    The student runs ``train()`` under ``TPU.COMPUTE_DTYPE``.
    ``bn_stats`` (default ``TPU.BN_STATS``): how the ranks' BatchNorm
    running statistics are reconciled.  ``debug_outputs``: the metrics
    also hold ``"output"`` (the last stack's heatmaps) and ``"target"``.
    On the card the step is a captured graph (``.eager``: the body).
    """
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    use_ohkm = bool(cfg.LOSS.USE_OHKM)
    topk = int(cfg.LOSS.TOPK)
    prepare = prepare or _identity_prepare
    bn_stats = _resolve_bn_stats(cfg, bn_stats)

    def body(state: TrainState, batch):
        batch = prepare(batch)
        model = state.model
        image = _input(model, batch["image"])
        with autocast(compute_dtype(cfg, image.device), image.device):
            outputs = model(image)
        stacked, final = _stacked(outputs, is_multi_output(model))
        tw = batch["target_weight"] if use_tw else None
        if use_ohkm:
            loss = stacked_ohkm_loss(stacked, batch["target"], tw, topk)
        else:
            loss = stacked_mse_loss(stacked, batch["target"], tw)
        _update(state, loss)
        _reconcile_bn(model, bn_stats)
        metrics = _metrics({"loss": loss}, final, batch["target"])
        return _with_debug(metrics, debug_outputs, final, batch["target"])

    return _compiled_train_step(body)


def make_fpd_train_step(cfg, teacher, teacher_cfg=None, prepare=None,
                        bn_stats=None, debug_outputs: bool = False
                        ) -> Callable:
    """``(state, batch) -> (state, metrics)``: one FPD distillation step.

    ``teacher`` (an ``nn.Module`` on the state's device, frozen) runs in
    eval mode without gradient under the teacher config's compute dtype;
    its last heatmap is the KD target.  The KD term's target-weight flag
    comes from ``teacher_cfg`` (the reference builds kd_pose_criterion
    from the teacher config, fpd_train.py:145-147); it defaults to
    ``cfg``.  Metrics: loss, pose_loss, kd_loss, acc, acc_cnt,
    per_joint_acc, and with ``debug_outputs`` the student's ``"output"``
    and the ``"target"``.  ``bn_stats`` as :func:`make_train_step` (the
    frozen teacher, in eval mode, keeps its statistics).  On the card the
    step, the teacher's forward and the collectives included, is one
    captured graph (``.eager``: the body).
    """
    tcfg = teacher_cfg or cfg
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    use_tw_kd = bool(tcfg.LOSS.USE_TARGET_WEIGHT)
    alpha = float(cfg.KD.ALPHA)
    prepare = prepare or _identity_prepare
    bn_stats = _resolve_bn_stats(cfg, bn_stats)
    teacher_multi = is_multi_output(teacher)

    def body(state: TrainState, batch):
        batch = prepare(batch)
        model = state.model
        image = _input(model, batch["image"])
        with torch.no_grad(), autocast(compute_dtype(tcfg, image.device),
                                       image.device):
            t_out = teacher(_input(teacher, batch["image"]))
        teacher_final = t_out[-1] if teacher_multi else t_out

        with autocast(compute_dtype(cfg, image.device), image.device):
            outputs = model(image)
        stacked, final = _stacked(outputs, is_multi_output(model))
        loss, pose, kd = fpd_loss(
            stacked, teacher_final, batch["target"], batch["target_weight"],
            alpha, use_target_weight_pose=use_tw,
            use_target_weight_kd=use_tw_kd)
        _update(state, loss)
        _reconcile_bn(model, bn_stats)
        metrics = _metrics({"loss": loss, "pose_loss": pose,
                            "kd_loss": kd}, final, batch["target"])
        return _with_debug(metrics, debug_outputs, final, batch["target"])

    return _compiled_train_step(body, teacher)


def make_eval_step(cfg, flip_perm=None, prepare=None,
                   debug_outputs: bool = False) -> Callable:
    """``(model, batch) -> outputs`` under ``inference_mode``.

    batch: {"image", "target", "target_weight", "inv_trans" (B, 2, 3),
    optionally "valid" (B,) with 0 on padded rows}.  outputs: {"preds"
    (B, J, 2) in source-image coordinates, "maxvals" (B, J), "loss" (),
    "hits"/"valids" (J,)}, device tensors; with ``debug_outputs`` also
    the flip-merged heatmaps ``"output"`` and the ``"target"`` (reference
    function.py:286-289).  Three decode-kernel launches
    per batch: the decode and the two PCK argmaxes.  The model runs in
    eval mode; on the card the step is a captured graph per model and
    batch shape (``.eager``: the body).
    """
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    use_ohkm = bool(cfg.LOSS.USE_OHKM)
    topk = int(cfg.LOSS.TOPK)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift_heatmap = bool(cfg.TEST.SHIFT_HEATMAP)
    post_process = bool(cfg.TEST.POST_PROCESS)
    if flip_test and flip_perm is None:
        raise ValueError("flip_perm is required when TEST.FLIP_TEST")
    prepare = prepare or _identity_prepare
    perm = None if flip_perm is None else np.asarray(flip_perm)

    @torch.inference_mode()
    def body(model, batch):
        batch = prepare(batch)
        image = _input(model, batch["image"])
        multi = is_multi_output(model)

        def fwd(x):
            with autocast(compute_dtype(cfg, x.device), x.device):
                out = model(x)
            return out[-1] if multi else out

        output = fwd(image)
        if flip_test:
            flipped = flip_back_torch(fwd(image.flip(3)),
                                      constant(perm, torch.int64,
                                               image.device))
            if shift_heatmap:
                # reference: col 0 kept, cols 1: get cols 0:-1
                # (function.py:236-238)
                flipped = torch.cat([flipped[..., :1], flipped[..., :-1]],
                                    dim=3)
            output = (output + flipped) * 0.5

        tw = batch["target_weight"] if use_tw else None
        mask = batch.get("valid")
        if mask is None:
            mask = torch.ones(output.shape[0], device=output.device)
        mask = mask.to(torch.float32)
        per_sample = _per_sample_loss(output, batch["target"], tw, use_ohkm,
                                      topk)
        loss = (per_sample * mask).sum() / mask.sum().clamp(min=1.0)

        preds, maxvals = decode_heatmaps(output.contiguous(),
                                         batch["inv_trans"], post_process)
        hits, valids = _pck_counts(output, batch["target"], mask)
        result = {"preds": preds, "maxvals": maxvals, "loss": loss,
                  "hits": hits, "valids": valids}
        return _with_debug(result, debug_outputs, output, batch["target"])

    captured = CapturedStep(body, lambda model: storage_fingerprint((model,)))

    def wrap(run):
        def step(model, batch):
            model.eval()
            return run(model, batch)
        return step

    step = wrap(captured)
    step.eager = wrap(body)
    step.captured = captured
    return step
