"""A plain PyTorch ViTPose and its FPD training step: the reference the
port's ``models/vit_pose.py``, AdamW with layer decay and the clipped
update are held to on the CPU (``tests/test_torch_vit_pose.py``).

It imports neither ``fhpe_tpu`` nor ``fhpe_tpu_torch``.  As published
(Xu et al., NeurIPS 2022, arXiv:2204.12484, and the
ViTAE-Transformer/ViTPose ``ViTPose_{base,large}_coco_256x192.py``
configs): patch conv ``Conv2d(3, D, P, stride P, padding)``, ``pos_embed``
(1, N + 1, D) added as ``pos_embed[:, 1:] + pos_embed[:, :1]``, pre-LN
blocks with biased qkv, attention written out as ``softmax(q k^T scale)
v`` with scale ``head_dim ** -0.5``, exact GELU, LayerNorm eps 1e-6, the
last norm, then two ``ConvTranspose2d(k4, s2, p1)`` + BatchNorm + ReLU and
a 1x1 conv to the joints.  The FPD loss is ``(1 - alpha) MSE(student, gt)
+ alpha MSE(student, teacher)``, each ``0.5 mean((w (p - g))^2)`` with
the joints' target weights.  AdamW: betas 0.9 / 0.999, eps 1e-8,
decoupled weight decay, none on 1-D parameters, biases and
``pos_embed``; rate scaled by ``decay ** (depth + 1 - layer_id)``; the
gradient's total norm clipped first.

Departures from the published description:

* stochastic depth takes its keep flags as an input, (B, depth, 2), one
  per sample, block and branch, instead of drawing them inside the
  forward (the same Bernoulli draws, made by the caller);
* the deconv decoder's widths and the input size are the caller's, so
  that the tests run at a small size;
* it computes in the dtype of the weights it is given, with TF32 off for
  cuBLAS and cuDNN while it runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.softmax(q @ k.transpose(-2, -1) * hd ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

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
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, keep):
        def dp(branch, flags):
            if keep is None:
                return branch
            flags = flags.to(branch.dtype)
            return branch * (flags / (1 - self.drop))[:, None, None]
        x = x + dp(self.attn(self.norm1(x)), None if keep is None
                   else keep[:, 0])
        return x + dp(self.mlp(self.norm2(x)), None if keep is None
                      else keep[:, 1])


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, padding):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=padding)


class Backbone(nn.Module):
    def __init__(self, image_hw, patch, padding, dim, depth, heads,
                 mlp_ratio, drop_path_rate):
        super().__init__()
        h, w = image_hw
        n = (((h + 2 * padding - patch) // patch + 1)
             * ((w + 2 * padding - patch) // patch + 1))
        self.patch_embed = PatchEmbed(dim, patch, padding)
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        rates = [drop_path_rate * i / (depth - 1) if depth > 1 else 0.0
                 for i in range(depth)]
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, r)
                                    for r in rates)
        self.last_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, keep=None):
        x = self.patch_embed.proj(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for i, block in enumerate(self.blocks):
            x = block(x, None if keep is None else keep[:, i])
        x = self.last_norm(x)
        return x.transpose(1, 2).reshape(b, c, hp, wp)


class Head(nn.Module):
    def __init__(self, dim, joints, filters):
        super().__init__()
        layers, cin = [], dim
        for cout in filters:
            layers += [nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
                       nn.BatchNorm2d(cout), nn.ReLU()]
            cin = cout
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, joints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    def __init__(self, image_hw, joints, dim, depth, heads, filters,
                 patch=16, padding=2, mlp_ratio=4, drop_path_rate=0.0):
        super().__init__()
        self.depth = depth
        self.backbone = Backbone(image_hw, patch, padding, dim, depth, heads,
                                 mlp_ratio, drop_path_rate)
        self.keypoint_head = Head(dim, joints, filters)

    def forward(self, x, keep=None):
        return self.keypoint_head(self.backbone(x, keep))


def layer_id(name, depth):
    if name.startswith("backbone.patch_embed") or name == "backbone.pos_embed":
        return 0
    if name.startswith("backbone.blocks."):
        return int(name.split(".")[2]) + 1
    return depth + 1


def groups(named, depth, lr, wd, decay):
    """{name: (rate, weight decay)} of every parameter."""
    out = {}
    for name, p in named:
        bare = p.ndim == 1 or name.endswith(".bias") or "pos_embed" in name
        out[name] = (lr * decay ** (depth + 1 - layer_id(name, depth)),
                     0.0 if bare else wd)
    return out


def mse(out, target, weight):
    d = (out - target) * weight[:, :, None, None]
    return 0.5 * torch.mean(d * d)


def fpd_step(student, teacher, batch, alpha, lr, wd, decay, clip, state):
    """One FPD step of ``student`` (train mode) taught by ``teacher`` (eval
    mode), AdamW with layer decay over the clipped gradient.  ``batch``:
    image (B, 3, H, W), target (B, J, h, w), target_weight (B, J),
    drop_path_keep (B, depth, 2).  ``state``: {} before the first step,
    AdamW's moments and step count after.  Returns (loss, {name: the
    gradient after clipping}, the norm before clipping)."""
    named = list(student.named_parameters())
    rates = groups(named, student.depth, lr, wd, decay)
    with no_tf32():
        with torch.no_grad():
            teacher_out = teacher.eval()(batch["image"])
        out = student.train()(batch["image"], batch["drop_path_keep"])
        w = batch["target_weight"]
        loss = ((1 - alpha) * mse(out, batch["target"], w)
                + alpha * mse(out, teacher_out, w))
        grads = torch.autograd.grad(loss, [p for _, p in named])
    total = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    coef = min(1.0, clip / (total + 1e-6)) if clip > 0 else 1.0
    grads = [g * coef for g in grads]
    t = state["t"] = state.get("t", 0) + 1
    with torch.no_grad():
        for (n, p), g in zip(named, grads):
            m = state.setdefault(("m", n), torch.zeros_like(p))
            v = state.setdefault(("v", n), torch.zeros_like(p))
            rate, decay_w = rates[n]
            p.mul_(1 - rate * decay_w)
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = v.sqrt() / math.sqrt(1 - 0.999 ** t) + 1e-8
            p.sub_(rate / (1 - 0.9 ** t) * m / denom)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}, total
