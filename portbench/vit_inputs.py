"""ViTPose's weights and training batches made from the run's seed, on the
device, in a few large draws (the ViT's counterpart of ``inputs.py``,
whose streams, tags and images it shares).

Weights: every linear's weight normal(0, 0.02) and bias normal(0, 0.02),
the last linear of each residual branch (``attn.proj``, ``mlp.fc2``) at
``inputs.RESIDUAL_SCALE`` of that, as trained residual networks keep
their branches small; LayerNorm scales uniform(0.5, 1.5) and shifts
normal(0, 0.1); ``pos_embed`` normal(0, 0.02); the patch conv and the
decoder's convs He-scale with biases normal(0, 0.1), BatchNorm scales
uniform(0.5, 1.5) and shifts normal(0, 0.1).  A network used as a teacher
(eval mode) gets its head's BatchNorm statistics from one float32
train-mode forward of the reference.  Batches: ``inputs.train_batches``
with each sample's drop-path keep flags, drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import inputs
from .reference import vit_pose as ref_vit
from .reference.precision import strict_float32
from .reference.serve import normalize

KEEP = 6        # the keep flags' stream (inputs.py's tags are 0-5)


def seeded_state_dict(model_cfg: dict, seed: int, tag: int, device,
                      calibrate: bool) -> dict:
    """The state dict of ViTPose ``model_cfg`` on ``device``, as the module
    docstring draws it; ``calibrate``: the head's BatchNorm statistics
    from one train-mode forward in float32 over 16 seeded images (else 0
    and 1)."""
    with torch.device("meta"):
        shapes = ref_vit.build(model_cfg)
    normal, uniform = [], []
    for name, m in shapes.named_modules():
        k = inputs.RESIDUAL_SCALE if getattr(m, "residual_out", False) else 1.0
        if isinstance(m, nn.Linear):
            normal.append((f"{name}.weight", m.weight.shape, k * 0.02))
            normal.append((f"{name}.bias", m.bias.shape, k * 0.02))
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            normal.append((f"{name}.weight", m.weight.shape,
                           (2.0 / m.weight[0].numel()) ** 0.5))
            if m.bias is not None:
                normal.append((f"{name}.bias", m.bias.shape, 0.1))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            uniform.append((f"{name}.weight", m.weight.shape))
            normal.append((f"{name}.bias", m.bias.shape, 0.1))
    normal.append(("backbone.pos_embed", shapes.backbone.pos_embed.shape,
                   0.02))
    gen = inputs.generator(seed, tag, device)
    counts = [int(np.prod(s)) for _, s, _ in normal]
    z = torch.randn(sum(counts), generator=gen, device=device)
    z *= torch.repeat_interleave(
        torch.tensor([std for *_, std in normal], device=device),
        torch.tensor(counts, device=device))
    ucounts = [int(np.prod(s)) for _, s in uniform]
    u = torch.rand(sum(ucounts), generator=gen, device=device) + 0.5
    sd = {}
    for (name, shape, _), part in zip(normal, torch.split(z, counts)):
        sd[name] = part.view(shape)
    for (name, shape), part in zip(uniform, torch.split(u, ucounts)):
        sd[name] = part.view(shape)
    with torch.device(device):
        model = ref_vit.build(model_cfg)
    model.load_state_dict(sd, strict=False)     # buffers keep 0 and 1
    if calibrate:
        _calibrate(model, model_cfg, seed, device)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _calibrate(model, model_cfg, seed, device) -> None:
    w, h = model_cfg["IMAGE_SIZE"]
    gen = inputs.generator(seed, inputs.CALIBRATION, device)
    images = inputs.smooth_images(gen, 16, h, w, device)
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


def keep_flags(seed: int, n: int, depth: int, rate: float) -> np.ndarray:
    """(n, depth, 2) float32: 1 where a sample keeps a block's branch (the
    attention's, then the MLP's), each dropped with its block's rate,
    linear from 0 to ``rate``."""
    rates = np.linspace(0.0, rate, depth)
    rng = inputs.numpy_rng(seed, KEEP)
    return (rng.random((n, depth, 2))
            >= rates[None, :, None]).astype(np.float32)


def train_batches(model_cfg: dict, batch: int, count: int, seed: int,
                  device) -> list:
    """``inputs.train_batches`` with each batch's ``drop_path_keep``."""
    out = inputs.train_batches(model_cfg, batch, count, seed, device)
    e = model_cfg["EXTRA"]
    flags = keep_flags(seed, batch * count, int(e["DEPTH"]),
                       float(e["DROP_PATH_RATE"]))
    for i, b in enumerate(out):
        b["drop_path_keep"] = flags[i * batch:(i + 1) * batch]
    return out
