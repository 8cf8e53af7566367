"""The reference FPD training step: Gaussian targets, the teacher's and the
student's forwards, the loss, the gradient and Adam, in plain PyTorch.

Follows Zhang et al. (FPD, CVPR 2019): ``loss = (1 - alpha) * MSE(student,
ground truth) + alpha * MSE(student, teacher)``, each MSE the reference
code's ``0.5 * mean((w * (p - g))^2)`` summed over a stacked student's
outputs, ``w`` the joints' target weights.  Targets are the reference
dataset's unnormalised Gaussians (peak 1, a ``6 sigma + 1`` window, joints
off the heatmap or invisible weighted 0).  Adam: betas 0.9 / 0.999,
eps 1e-8, no weight decay.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .models import build, final_heatmaps, set_precision
from .serve import normalize

BETAS = (0.9, 0.999)
EPS = 1e-8


def targets(joints, vis, heatmap_size, image_size, sigma):
    """(B, J, 2) joints in input pixels, (B, J) visibility -> (target (B, J,
    h, w), weight (B, J)), float32."""
    w, h = heatmap_size
    stride_x, stride_y = image_size[0] / w, image_size[1] / h
    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    r = 3 * sigma
    inside = ((mu_x - r < w) & (mu_y - r < h) & (mu_x + r + 1 >= 0)
              & (mu_y + r + 1 >= 0))
    weight = (vis > 0).float() * inside.float()
    xs = torch.arange(w, device=joints.device, dtype=torch.float32)
    ys = torch.arange(h, device=joints.device, dtype=torch.float32)
    dx = xs - mu_x[..., None]
    dy = ys - mu_y[..., None]
    gx = torch.exp(-dx ** 2 / (2 * sigma ** 2)) * (dx.abs() <= r)
    gy = torch.exp(-dy ** 2 / (2 * sigma ** 2)) * (dy.abs() <= r)
    target = gy[..., :, None] * gx[..., None, :]
    return target * (weight > 0.5).float()[..., None, None], weight


def mse(outputs, target, weight):
    """Summed over the stacks: 0.5 * mean((w (p - g))^2)."""
    total = 0.0
    for out in outputs:
        d = (out - target) * weight[:, :, None, None]
        total = total + 0.5 * torch.mean(d * d)
    return total


def fpd_loss(outputs, teacher_final, target, weight, alpha, tw_pose, tw_kd):
    ones = torch.ones_like(weight)
    pose = mse(outputs, target, weight if tw_pose else ones)
    kd = mse(outputs, teacher_final, weight if tw_kd else ones)
    return (1 - alpha) * pose + alpha * kd


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float()
                                             for n in names])).cpu()
    return dict(zip(names, norms.double().tolist()))


def fpd_steps(cfg: dict, student_sd, teacher_sd, batches: List[dict],
              device, precision: str = "float32") -> dict:
    """The first ``len(batches)`` FPD steps from ``student_sd`` (the student
    in train mode) taught by ``teacher_sd`` (eval mode).  ``cfg``: a
    configuration file's dict.  Returns {"loss": [per step], "grad": {leaf:
    norm of the first step's gradient}, "delta": {leaf: norm of the
    parameters' change after the last step}}."""
    s_cfg, t_cfg = cfg["student"], cfg["teacher"]
    student = set_precision(build(s_cfg["MODEL"]), precision)
    teacher = set_precision(build(t_cfg["MODEL"]), precision)
    student.load_state_dict(student_sd)
    teacher.load_state_dict(teacher_sd)
    student.to(device).train()
    teacher.to(device).eval().requires_grad_(False)
    params = dict(student.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    model = s_cfg["MODEL"]
    lr = float(s_cfg["TRAIN"]["LR"])
    alpha = float(s_cfg["KD"]["ALPHA"])
    tw_pose = bool(s_cfg["LOSS"]["USE_TARGET_WEIGHT"])
    tw_kd = bool(t_cfg["LOSS"]["USE_TARGET_WEIGHT"])
    out = {"loss": [], "grad": None, "delta": None}
    for t, batch in enumerate(batches, start=1):
        image = normalize(torch.from_numpy(batch["image"]).to(device))
        joints = torch.from_numpy(batch["joints"]).to(device)
        vis = torch.from_numpy(batch["joints_vis"]).to(device)
        target, weight = targets(joints, vis, model["HEATMAP_SIZE"],
                                 model["IMAGE_SIZE"], model["SIGMA"])
        with torch.no_grad():
            teacher_final = final_heatmaps(teacher, image)
        outputs = student(image)
        if not student.multi_output:
            outputs = [outputs]
        loss = fpd_loss(outputs, teacher_final, target, weight, alpha,
                        tw_pose, tw_kd)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                      list(params.values()))))
        out["loss"].append(float(loss.detach()))
        if t == 1:
            out["grad"] = leaf_norms(grads)
        with torch.no_grad():
            c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            for n, p in params.items():
                g = grads[n]
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[n].sqrt() / c2 ** 0.5).add_(EPS)
                p.addcdiv_(m[n], denom, value=-lr / c1)
    out["delta"] = leaf_norms({n: p.detach() - start[n]
                               for n, p in params.items()})
    return out
