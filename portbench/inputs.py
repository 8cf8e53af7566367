"""Weights and inputs made from the run's seed, on the device, in a few
large draws.

Every stream of numbers comes from a CUDA (or, in the CPU tests, CPU)
``torch.Generator`` seeded with the run's seed mixed with a tag, so that
the weights, the images and the samples are independent and the same seed
gives the same inputs.  Weights are He-scale convolutions and random
BatchNorm scales and shifts; a network served or used as a teacher (in
eval mode) gets BatchNorm statistics from one float32 forward of the
reference network in train mode, so that its activations stay moderate as
a trained network's do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .reference import models as ref_models
from .reference.precision import strict_float32
from .reference.serve import normalize

# the last layer of each residual branch is drawn at this share of the
# others' scale, as trained residual networks keep their branches small:
# at full scale the random networks amplify round-off from block to block
# (PERF.md)
RESIDUAL_SCALE = 0.25
# tags of the independent streams drawn from one seed
WEIGHTS_STUDENT, WEIGHTS_TEACHER, CALIBRATION, BATCHES, CROPS, SAMPLE = \
    range(6)


def substream(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed`` (any int)."""
    state = np.random.SeedSequence([seed % 2 ** 64, tag]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def generator(seed: int, tag: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(substream(seed, tag))
    return gen


def numpy_rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(substream(seed, tag))


def seeded_state_dict(model_cfg: dict, seed: int, tag: int, device,
                      calibrate: bool) -> dict:
    """The state dict of the network of ``model_cfg`` (a configuration
    file's ``MODEL`` group), on ``device``: conv weights normal(0,
    sqrt(2 / fan_in)), conv biases and BatchNorm shifts normal(0, 0.1),
    BatchNorm scales uniform(0.5, 1.5), in one normal and one uniform draw;
    the last layer of each residual branch at ``RESIDUAL_SCALE`` of that.
    ``calibrate``: BatchNorm running statistics from one train-mode
    forward of the reference network in float32 over 16 seeded images;
    otherwise 0 and 1."""
    with torch.device("meta"):
        shapes = ref_models.build(model_cfg)
    normal, uniform = [], []
    for name, m in shapes.named_modules():
        k = RESIDUAL_SCALE if getattr(m, "residual_out", False) else 1.0
        if isinstance(m, nn.Conv2d):
            normal.append((f"{name}.weight", m.weight.shape,
                           k * (2.0 / m.weight[0].numel()) ** 0.5))
            if m.bias is not None:
                normal.append((f"{name}.bias", m.bias.shape, k * 0.1))
        elif isinstance(m, nn.BatchNorm2d):
            uniform.append((f"{name}.weight", m.weight.shape, k))
            normal.append((f"{name}.bias", m.bias.shape, k * 0.1))
    gen = generator(seed, tag, device)
    counts = [int(np.prod(s)) for _, s, _ in normal]
    z = torch.randn(sum(counts), generator=gen, device=device)
    z *= torch.repeat_interleave(
        torch.tensor([std for *_, std in normal], device=device),
        torch.tensor(counts, device=device))
    ucounts = [int(np.prod(s)) for _, s, _ in uniform]
    u = torch.rand(sum(ucounts), generator=gen, device=device) + 0.5
    u *= torch.repeat_interleave(
        torch.tensor([k for *_, k in uniform], device=device),
        torch.tensor(ucounts, device=device))
    sd = {}
    for (name, shape, _), part in zip(normal, torch.split(z, counts)):
        sd[name] = part.view(shape)
    for (name, shape, _), part in zip(uniform, torch.split(u, ucounts)):
        sd[name] = part.view(shape)
    with torch.device(device):
        model = ref_models.build(model_cfg)
    model.load_state_dict(sd, strict=False)     # buffers keep 0 and 1
    if calibrate:
        _calibrate(model, model_cfg, seed, device)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _calibrate(model, model_cfg, seed, device) -> None:
    w, h = model_cfg["IMAGE_SIZE"]
    gen = generator(seed, CALIBRATION, device)
    images = smooth_images(gen, 16, h, w, device)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None       # one batch sets the statistics
    model.train()
    with torch.no_grad(), strict_float32():
        model(normalize(images))
    for m in bns:
        m.momentum = 0.1
        m.num_batches_tracked.zero_()
    model.eval()


def smooth_images(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 on ``device``: blobs of colour at 1/8 of the
    size, upsampled, with grain on top."""
    low = torch.rand((n, 3, h // 8 + 2, w // 8 + 2), generator=gen,
                     device=device)
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False) * 200
    img += torch.rand((n, 3, h, w), generator=gen, device=device) * 55
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def train_batches(model_cfg: dict, batch: int, count: int, seed: int,
                  device) -> list:
    """``count`` host batches in the loader's layout: uint8 crops (B, H, W,
    3), ``joints`` (B, J, 2) float32 in crop pixels (a few off the crop),
    ``joints_vis`` (B, J) float32 0 / 1 (nine in ten visible)."""
    w, h = model_cfg["IMAGE_SIZE"]
    j = model_cfg["NUM_JOINTS"]
    gen = generator(seed, BATCHES, device)
    n = batch * count
    images = smooth_images(gen, n, h, w, device).cpu().numpy()
    lo = torch.tensor([-8.0, -8.0], device=device)
    span = torch.tensor([w + 16.0, h + 16.0], device=device)
    joints = (torch.rand((n, j, 2), generator=gen, device=device) * span
              + lo).cpu().numpy()
    vis = (torch.rand((n, j), generator=gen, device=device) > 0.1
           ).float().cpu().numpy()
    return [{"image": images[i * batch:(i + 1) * batch],
             "joints": joints[i * batch:(i + 1) * batch],
             "joints_vis": vis[i * batch:(i + 1) * batch]}
            for i in range(count)]
