"""Gaussian target heatmaps on the device, NCHW.

Counterpart of ``fhpe_tpu/geometry/targets.py::generate_target_jax`` (an
XLA fusion there, plain tensor ops here): the reference's
``JointsDataset.generate_target`` (an unnormalised Gaussian, peak 1, in a
``6 * sigma + 1`` window around each joint, ``int(x / stride + 0.5)``
truncation, out-of-bounds and invisible joints weighted 0), written as a
separable Gaussian over the whole heatmap masked to the window, which is
exact for integer sigma.
"""

from __future__ import annotations

import torch


def generate_target_torch(joints, joints_vis, heatmap_size, image_size, sigma,
                          joints_weight=None,
                          use_different_joints_weight=False):
    """joints (..., J, 2) float; joints_vis (..., J) float (visibility).
    heatmap_size / image_size: (width, height).  Returns (target
    (..., J, H, W) float32, target_weight (..., J) float32) on
    ``joints.device``."""
    if float(sigma) != int(sigma):
        raise ValueError(
            "generate_target_torch supports integer MODEL.SIGMA only (the "
            "masked-window formulation is exact for integer sigma; all "
            "shipped configs use SIGMA=2). Use host targets "
            "(generate_target_np) for fractional sigma.")
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    sx = float(image_size[0]) / float(heatmap_size[0])
    sy = float(image_size[1]) / float(heatmap_size[1])
    tmp = int(sigma) * 3
    dev = joints.device

    # the reference's int(x + 0.5): truncation toward zero
    mu_x = torch.trunc(joints[..., 0] / sx + 0.5).to(torch.int32)
    mu_y = torch.trunc(joints[..., 1] / sy + 0.5).to(torch.int32)

    in_bounds = ((mu_x - tmp < w) & (mu_y - tmp < h)
                 & (mu_x + tmp + 1 >= 0) & (mu_y + tmp + 1 >= 0))
    vis = (joints_vis > 0).to(torch.float32)
    weight = vis * in_bounds.to(torch.float32)

    px = torch.arange(w, dtype=torch.float32, device=dev)
    py = torch.arange(h, dtype=torch.float32, device=dev)
    dx = px - mu_x[..., None].to(torch.float32)            # (..., J, W)
    dy = py - mu_y[..., None].to(torch.float32)            # (..., J, H)
    two_s2 = 2.0 * sigma ** 2
    gx = torch.exp(-(dx ** 2) / two_s2) * (dx.abs() <= tmp)
    gy = torch.exp(-(dy ** 2) / two_s2) * (dy.abs() <= tmp)
    target = gy[..., :, None] * gx[..., None, :]           # (..., J, H, W)
    stamp = (weight > 0.5).to(torch.float32)
    target = target * stamp[..., None, None]

    if use_different_joints_weight and joints_weight is not None:
        weight = weight * torch.as_tensor(joints_weight, dtype=torch.float32,
                                          device=dev)
    return target.to(torch.float32), weight
