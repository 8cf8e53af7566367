"""Gaussian target heatmaps on the device, NCHW.

Counterpart of ``fhpe_tpu/geometry/targets.py::generate_target_jax`` (an
XLA fusion there, plain tensor ops here): the reference's
``JointsDataset.generate_target`` (an unnormalised Gaussian, peak 1, in a
``6 * sigma + 1`` window around each joint, ``int(x / stride + 0.5)``
truncation, out-of-bounds and invisible joints weighted 0), written as a
separable Gaussian over the whole heatmap masked to the window, which is
exact for integer sigma.  :func:`generate_target_np` is a copy of
``fhpe_tpu``'s scalar numpy generator (pinned by
``tests/test_torch_port_hygiene.py``): the loader's host targets when
``TPU.DEVICE_PREPROCESS`` is off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.graph import constant


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
        weight = weight * constant(joints_weight, torch.float32, dev)
    return target.to(torch.float32), weight


def generate_target_np(joints, joints_vis, heatmap_size, image_size, sigma,
                       joints_weight=None, use_different_joints_weight=False):
    """Single-sample numpy target generator.

    joints: (J, 3) float; joints_vis: (J, 3) (only column 0 is used).
    heatmap_size / image_size: (width, height).
    Returns (target (J, H, W) float32, target_weight (J, 1) float32).
    """
    num_joints = joints.shape[0]
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    stride = (np.asarray(image_size, dtype=np.float64)
              / np.asarray(heatmap_size, dtype=np.float64))
    tmp_size = sigma * 3  # float when sigma is float, as in the reference

    target = np.zeros((num_joints, h, w), dtype=np.float32)
    target_weight = np.ones((num_joints, 1), dtype=np.float32)
    target_weight[:, 0] = joints_vis[:, 0]

    for j in range(num_joints):
        mu_x = int(joints[j][0] / stride[0] + 0.5)
        mu_y = int(joints[j][1] / stride[1] + 0.5)
        # int() placement matches JointsDataset.py:258-259 exactly (matters
        # for non-integer sigma)
        ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
        br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
        if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
            target_weight[j] = 0
            continue
        if target_weight[j] > 0.5:
            size = 2 * tmp_size + 1
            x = np.arange(0, size, 1, np.float32)
            y = x[:, np.newaxis]
            x0 = y0 = size // 2
            g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
            g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
            g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
            img_x = max(0, ul[0]), min(br[0], w)
            img_y = max(0, ul[1]), min(br[1], h)
            target[j][img_y[0]:img_y[1], img_x[0]:img_x[1]] = \
                g[g_y[0]:g_y[1], g_x[0]:g_x[1]]

    if use_different_joints_weight and joints_weight is not None:
        target_weight = target_weight * joints_weight
    return target, target_weight
