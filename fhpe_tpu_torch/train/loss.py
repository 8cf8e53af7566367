"""Heatmap losses: joints MSE, OHKM, and the FPD distillation objective.

Counterpart of ``fhpe_tpu/train/loss.py`` (the reference's
``lib/core/loss.py`` and the FPD mixing of ``lib/core/function.py:127-140``
as single fused expressions).  Heatmaps are NCHW ``(B, J, H, W)``; a
stacked hourglass's outputs carry a leading stacks axis ``(S, B, J, H, W)``
(``torch.stack`` of the per-stack list), which broadcasting handles.
``target_weight`` is ``(B, J)``.

The fused form equals the reference's per-joint loop: every per-joint
mean has the same element count, so ``(1/J) sum_j 0.5 mean((w p - w g)^2)``
is ``0.5 mean_{B,J,HW}(w^2 (p - g)^2)``.
"""

from __future__ import annotations

import torch


def _weighted_diff(output, target, target_weight):
    diff = output - target
    if target_weight is not None:
        diff = diff * target_weight[:, :, None, None]
    return diff


def joints_mse_loss(output, target, target_weight=None):
    """0.5 * weighted MSE over (..., B, J, H, W); one value per leading
    index (per stack)."""
    diff = _weighted_diff(output, target, target_weight)
    return 0.5 * torch.mean(torch.square(diff), dim=(-4, -3, -2, -1))


def stacked_mse_loss(outputs, target, target_weight=None):
    """Per-stack MSE summed over the leading stacks axis (if present)."""
    return torch.sum(joints_mse_loss(outputs, target, target_weight))


def joints_ohkm_mse_loss(output, target, target_weight=None, topk: int = 8):
    """Online hard keypoint mining MSE (reference loss.py:42-84): per
    sample the top-k joint losses, averaged (sum / k) over the batch."""
    diff = _weighted_diff(output, target, target_weight)
    per_joint = 0.5 * torch.mean(torch.square(diff), dim=(-2, -1))  # .., B, J
    top = torch.topk(per_joint, topk, dim=-1).values
    return torch.mean(torch.sum(top, dim=-1) / topk, dim=-1)


def stacked_ohkm_loss(outputs, target, target_weight=None, topk: int = 8):
    return torch.sum(joints_ohkm_mse_loss(outputs, target, target_weight,
                                          topk))


def fpd_loss(student_out, teacher_final, target, target_weight=None,
             alpha: float = 0.5, use_target_weight_pose: bool = True,
             use_target_weight_kd: bool = True):
    """FPD objective: (1-alpha)*MSE(student, gt) + alpha*MSE(student, teacher).

    ``teacher_final`` is the teacher's last heatmap, computed without
    gradient by the caller.  For stacked students both terms are summed
    per stack.  The pose term's target-weight flag comes from the student
    config and the KD term's from the teacher config (reference
    fpd_train.py:145-147,177-179).  Returns (total, pose_loss, kd_loss).
    """
    pose_w = target_weight if use_target_weight_pose else None
    kd_w = target_weight if use_target_weight_kd else None
    pose = stacked_mse_loss(student_out, target, pose_w)
    kd = stacked_mse_loss(student_out, teacher_final, kd_w)
    total = (1.0 - alpha) * pose + alpha * kd
    return total, pose, kd
