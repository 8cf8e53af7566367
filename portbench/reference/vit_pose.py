"""Plain PyTorch ViTPose and its FPD training step, the benchmark's
reference for the ``vitpose_fpd_coco`` configuration.

Follows Xu et al., ViTPose, NeurIPS 2022 (arXiv:2204.12484) and the
ViTAE-Transformer/ViTPose ``ViTPose_{base,large}_coco_256x192.py``
configs, with the module names of the published checkpoints
(``backbone.*``, ``keypoint_head.*``), so that one state dict loads here
and into the measured program alike: the patch conv ``Conv2d(3, D, 16,
stride 16, padding 2)``; ``pos_embed`` (1, N + 1, D) added as
``pos_embed[:, 1:] + pos_embed[:, :1]``; pre-LN blocks with biased qkv,
attention written out as ``softmax(q k^T head_dim^-0.5) v``, exact GELU,
LayerNorm eps 1e-6; the last norm; two ``ConvTranspose2d(k4, s2, p1)`` +
BatchNorm + ReLU and a 1x1 conv to the joints.  The step: FPD's loss
(``reference/train.py``), the gradient's total norm clipped, AdamW
(betas 0.9 / 0.999, eps 1e-8, decoupled decay, none on 1-D parameters,
biases and ``pos_embed``) with each rate scaled by ``decay ** (depth + 1
- layer_id)``.  Every linear and conv is a ``Ref*`` module: float32, or,
for the precision control, on operands rounded to scaled e4m3 with the
gradient of its output rounded to scaled e5m2.  Nothing here imports the
program under test.

Departures from the published description: stochastic depth takes its
keep flags as an input (B, depth, 2), as the program does, instead of
drawing them in the forward; the 500-iteration linear warm-up is left out
(the program sets its rate per epoch); targets are the FPD reference's
(``reference/train.py``), not ViTPose's UDP.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .precision import fake_quant, grad_quant
from .serve import normalize
from .train import fpd_loss, leaf_norms, targets


class RefLinear(nn.Linear):
    precision = "float32"

    def forward(self, x):
        if self.precision != "fp8":
            return F.linear(x, self.weight, self.bias)
        return grad_quant(F.linear(fake_quant(x), fake_quant(self.weight),
                                   self.bias))


class RefConv(nn.Conv2d):
    precision = "float32"

    def forward(self, x):
        if self.precision != "fp8":
            return self._conv_forward(x, self.weight, self.bias)
        return grad_quant(self._conv_forward(
            fake_quant(x), fake_quant(self.weight), self.bias))


class RefConvT(nn.ConvTranspose2d):
    precision = "float32"

    def forward(self, x):
        w = self.weight if self.precision != "fp8" else fake_quant(self.weight)
        x = x if self.precision != "fp8" else fake_quant(x)
        out = F.conv_transpose2d(x, w, self.bias, self.stride, self.padding)
        return out if self.precision != "fp8" else grad_quant(out)


def residual_out(module: nn.Module) -> nn.Module:
    """Marks the last layer of a residual branch, which the benchmark's
    weights draw small."""
    module.residual_out = True
    return module


def attention(q, k, v):
    """softmax(q k^T / sqrt(head_dim)) v, written out."""
    scale = q.shape[-1] ** -0.5
    return torch.softmax(q @ k.transpose(-2, -1) * scale, dim=-1) @ v


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = RefLinear(dim, 3 * dim)
        self.proj = residual_out(RefLinear(dim, dim))

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = RefLinear(dim, hidden)
        self.fc2 = residual_out(RefLinear(hidden, dim))

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(0.5 * h * (1 + torch.erf(h / math.sqrt(2))))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, drop):
        super().__init__()
        self.drop = drop
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, keep=None):
        def dp(branch, i):
            if keep is None:
                return branch
            return branch * (keep[:, i] / (1 - self.drop))[:, None, None]
        x = x + dp(self.attn(self.norm1(x)), 0)
        return x + dp(self.mlp(self.norm2(x)), 1)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, padding):
        super().__init__()
        self.proj = RefConv(3, dim, patch, stride=patch, padding=padding)


class Backbone(nn.Module):
    def __init__(self, image_size, e):
        super().__init__()
        w, h = image_size
        patch, pad = int(e["PATCH_SIZE"]), int(e["PATCH_PADDING"])
        dim, depth = int(e["EMBED_DIM"]), int(e["DEPTH"])
        n = (((h + 2 * pad - patch) // patch + 1)
             * ((w + 2 * pad - patch) // patch + 1))
        self.patch_embed = PatchEmbed(dim, patch, pad)
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        rate = float(e["DROP_PATH_RATE"])
        self.blocks = nn.ModuleList(
            Block(dim, int(e["NUM_HEADS"]), float(e["MLP_RATIO"]),
                  rate * i / (depth - 1) if depth > 1 else 0.0)
            for i in range(depth))
        self.last_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, keep=None):
        x = self.patch_embed.proj(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for i, block in enumerate(self.blocks):
            x = block(x, None if keep is None else keep[:, i])
        return self.last_norm(x).transpose(1, 2).reshape(b, c, hp, wp)


class Head(nn.Module):
    def __init__(self, dim, joints, e):
        super().__init__()
        layers, cin = [], dim
        n = int(e["NUM_DECONV_LAYERS"])
        for cout, k in zip(e["NUM_DECONV_FILTERS"][:n],
                           e["NUM_DECONV_KERNELS"][:n]):
            assert k == 4, "the published decoder's kernels are 4"
            layers += [RefConvT(cin, cout, 4, 2, 1, bias=False),
                       nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
                       nn.ReLU()]
            cin = cout
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = RefConv(cin, joints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    multi_output = False

    def __init__(self, model_cfg: dict):
        super().__init__()
        e = model_cfg["EXTRA"]
        self.depth = int(e["DEPTH"])
        self.backbone = Backbone(model_cfg["IMAGE_SIZE"], e)
        self.keypoint_head = Head(int(e["EMBED_DIM"]),
                                  int(model_cfg["NUM_JOINTS"]), e)

    def forward(self, x, keep=None):
        return self.keypoint_head(self.backbone(x, keep))


def build(model_cfg: dict) -> ViTPose:
    return ViTPose(model_cfg)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (RefLinear, RefConv, RefConvT)):
            m.precision = precision
    return model


def layer_id(name: str, depth: int) -> int:
    if name.startswith("backbone.patch_embed") or name == "backbone.pos_embed":
        return 0
    if name.startswith("backbone.blocks."):
        return int(name.split(".")[2]) + 1
    return depth + 1


def rates(named, depth: int, lr: float, wd: float, decay: float) -> dict:
    """{name: (rate, weight decay)} of every parameter."""
    out = {}
    for name, p in named:
        bare = p.ndim == 1 or name.endswith(".bias") or "pos_embed" in name
        out[name] = (lr * decay ** (depth + 1 - layer_id(name, depth)),
                     0.0 if bare else wd)
    return out


BETAS = (0.9, 0.999)
EPS = 1e-8


def fpd_steps(cfg: dict, student_sd, teacher_sd, batches: List[dict],
              device, precision: str = "float32") -> dict:
    """The first ``len(batches)`` FPD steps of ViTPose ``student_sd`` (train
    mode, each batch's ``drop_path_keep`` flags) taught by ``teacher_sd``
    (eval mode).  Returns {"loss": [per step], "grad": {leaf: norm of the
    first step's clipped gradient}, "delta": {leaf: norm of the
    parameters' change after the last step}}."""
    s_cfg, t_cfg = cfg["student"], cfg["teacher"]
    student = set_precision(build(s_cfg["MODEL"]), precision)
    teacher = set_precision(build(t_cfg["MODEL"]), precision)
    student.load_state_dict(student_sd)
    teacher.load_state_dict(teacher_sd)
    student.to(device).train()
    teacher.to(device).eval().requires_grad_(False)
    named = list(student.named_parameters())
    train = s_cfg["TRAIN"]
    lr_wd = rates(named, student.depth, float(train["LR"]),
                  float(train["WD"]), float(train["LAYER_DECAY"]))
    clip = float(train["CLIP_GRAD_NORM"])
    start = {n: p.detach().clone() for n, p in named}
    m = {n: torch.zeros_like(p) for n, p in named}
    v = {n: torch.zeros_like(p) for n, p in named}
    model = s_cfg["MODEL"]
    alpha = float(s_cfg["KD"]["ALPHA"])
    tw_pose = bool(s_cfg["LOSS"]["USE_TARGET_WEIGHT"])
    tw_kd = bool(t_cfg["LOSS"]["USE_TARGET_WEIGHT"])
    out = {"loss": [], "grad": None, "delta": None}
    for t, batch in enumerate(batches, start=1):
        image = normalize(torch.from_numpy(batch["image"]).to(device))
        joints = torch.from_numpy(batch["joints"]).to(device)
        vis = torch.from_numpy(batch["joints_vis"]).to(device)
        keep = torch.from_numpy(batch["drop_path_keep"]).to(device)
        target, weight = targets(joints, vis, model["HEATMAP_SIZE"],
                                 model["IMAGE_SIZE"], model["SIGMA"])
        with torch.no_grad():
            teacher_final = teacher(image)
        loss = fpd_loss([student(image, keep)], teacher_final, target,
                        weight, alpha, tw_pose, tw_kd)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        coef = min(1.0, clip / (float(total) + 1e-6)) if clip > 0 else 1.0
        grads = {n: g * coef for (n, _), g in zip(named, grads)}
        out["loss"].append(float(loss.detach()))
        if t == 1:
            out["grad"] = leaf_norms(grads)
        with torch.no_grad():
            c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            for n, p in named:
                g = grads[n]
                rate, decay = lr_wd[n]
                p.mul_(1 - rate * decay)
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[n].sqrt() / c2 ** 0.5).add_(EPS)
                p.addcdiv_(m[n], denom, value=-rate / c1)
    out["delta"] = leaf_norms({n: p.detach() - start[n] for n, p in named})
    return out
