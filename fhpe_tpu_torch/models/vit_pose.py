"""ViTPose (Xu et al., NeurIPS 2022, arXiv:2204.12484), NCHW PyTorch.

A plain ViT backbone and the classic deconv decoder, with the module names
of the published checkpoints (``backbone.*``, ``keypoint_head.*``):

* ``backbone.patch_embed.proj``: ``Conv2d(3, D, P, stride P, padding
  PATCH_PADDING)``; at 256x192 with P 16 and padding 2 a 16x12 grid of
  N = 192 tokens;
* ``backbone.pos_embed`` (1, N + 1, D), added as ``pos_embed[:, 1:] +
  pos_embed[:, :1]`` (the class token's slot folded in, as the published
  checkpoints keep it);
* ``backbone.blocks.{i}``: pre-LN blocks, ``x + dp(attn.proj(MHSA(
  norm1(x))))`` then ``x + dp(mlp.fc2(GELU(mlp.fc1(norm2(x)))))``; qkv with
  bias, scale ``head_dim ** -0.5``, attention through
  ``F.scaled_dot_product_attention`` (the flash kernels under bf16
  autocast on the card); exact (erf) GELU; LayerNorm eps 1e-6;
* ``backbone.last_norm``, then the tokens as a (B, D, Hp, Wp) map;
* ``keypoint_head.deconv_layers`` / ``keypoint_head.final_layer``:
  PoseResNet's decoder (``models/common.py::deconv_decoder``).

Under bf16 autocast the linears, the patch conv, the decoder and the
attention run in bf16; LayerNorm and the softmax's statistics in float32,
and the residual stream stays float32.  The heatmaps come back in at
least float32.

Stochastic depth (``dp``): block i's two branches are each scaled per
sample by a keep flag over ``1 - p_i``, ``p_i`` rising linearly from 0 at
the first block to ``DROP_PATH_RATE`` at the last.  The flags are an
input, ``drop_path_keep`` (B, depth, 2) of 0 and 1, drawn on the host by
the data layer (``data/drop_path.py``), so that a captured train step
holds no random state and a reference can be handed the same flags.  In
eval mode, or without flags, no branch is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import deconv_decoder, drop_rates, init_decoder

LN_EPS = 1e-6


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qkv_bias: bool):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 qkv_bias: bool, drop_prob: float = 0.0):
        super().__init__()
        self.keep_prob = 1.0 - drop_prob
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, keep=None):
        """``keep``: None, or the (B, 2) keep flags of the two branches;
        a kept branch is scaled by one over the keep probability."""
        attn = self.attn(self.norm1(x))
        if keep is not None:
            attn = attn * (keep[:, 0] / self.keep_prob)[:, None, None]
        x = x + attn
        mlp = self.mlp(self.norm2(x))
        if keep is not None:
            mlp = mlp * (keep[:, 1] / self.keep_prob)[:, None, None]
        return x + mlp


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, padding: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=padding)

    def forward(self, x):
        return self.proj(x)


class ViT(nn.Module):
    def __init__(self, image_size, patch: int, padding: int, dim: int,
                 depth: int, heads: int, mlp_ratio: float, qkv_bias: bool,
                 drop_path_rate: float):
        super().__init__()
        w, h = image_size
        self.grid = ((h + 2 * padding - patch) // patch + 1,
                     (w + 2 * padding - patch) // patch + 1)
        self.patch_embed = PatchEmbed(dim, patch, padding)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1] + 1, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, qkv_bias, float(p))
            for p in drop_rates(depth, drop_path_rate))
        self.last_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, drop_path_keep=None):
        x = self.patch_embed(x)
        b, d, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        keep = None
        if self.training and drop_path_keep is not None:
            keep = drop_path_keep.to(x.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, None if keep is None else keep[:, i])
        x = self.last_norm(x)
        return x.transpose(1, 2).reshape(b, d, hp, wp)


class KeypointHead(nn.Module):
    def __init__(self, inplanes: int, num_joints: int, extra):
        super().__init__()
        layers = int(extra.NUM_DECONV_LAYERS)
        self.deconv_layers, self.final_layer = deconv_decoder(
            inplanes, num_joints, tuple(extra.NUM_DECONV_FILTERS)[:layers],
            tuple(extra.NUM_DECONV_KERNELS)[:layers],
            bool(extra.DECONV_WITH_BIAS), int(extra.FINAL_CONV_KERNEL))

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """ViTPose; ``forward(x, drop_path_keep=None)`` returns one ``(B, J,
    4 Hp, 4 Wp)`` heatmap tensor in at least float32.

    For AdamW's parameter groups (``train/state.py::make_optimizer``) the
    model names its layers for the rate decay (:meth:`layer_id`, 0 to
    :attr:`num_layers`) and the parameters that AdamW leaves without
    weight decay beyond the 1-D ones and the biases
    (:meth:`no_weight_decay`), as ViTPose's
    ``LayerDecayOptimizerConstructor`` and timm's ViT do.
    """

    flow_blocks = (nn.ConvTranspose2d,)

    def __init__(self, image_size, num_joints: int, extra):
        super().__init__()
        dim = int(extra.EMBED_DIM)
        self.backbone = ViT(
            image_size, int(extra.PATCH_SIZE), int(extra.PATCH_PADDING), dim,
            int(extra.DEPTH), int(extra.NUM_HEADS), float(extra.MLP_RATIO),
            bool(extra.QKV_BIAS), float(extra.DROP_PATH_RATE))
        self.keypoint_head = KeypointHead(dim, num_joints, extra)
        self.num_layers = int(extra.DEPTH) + 1
        self.init_weights()

    def init_weights(self) -> None:
        """The published init from scratch: linears truncated normal(0,
        0.02) with zero biases, LayerNorm 1 and 0, ``pos_embed`` truncated
        normal(0, 0.02), the patch conv torch's default, the decoder the
        reference's (``init_decoder``)."""
        for m in self.backbone.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.backbone.pos_embed, std=0.02)
        init_decoder(self.keypoint_head.modules())

    def forward(self, x, drop_path_keep=None) -> torch.Tensor:
        out = self.keypoint_head(self.backbone(x, drop_path_keep))
        return out.to(torch.promote_types(torch.float32, out.dtype))

    def layer_id(self, name: str) -> int:
        """A parameter's layer for the rate decay: 0 for the patch and
        position embeddings, i + 1 for ``backbone.blocks.i``,
        :attr:`num_layers` (depth + 1) for the rest (the last norm and the
        head)."""
        if name.startswith(("backbone.patch_embed.", "backbone.pos_embed")):
            return 0
        if name.startswith("backbone.blocks."):
            return int(name.split(".")[2]) + 1
        return self.num_layers

    def no_weight_decay(self) -> set:
        """The position embedding."""
        return {"backbone.pos_embed"}


def get_pose_net(cfg) -> ViTPose:
    return ViTPose(tuple(cfg.MODEL.IMAGE_SIZE), cfg.MODEL.NUM_JOINTS,
                   cfg.MODEL.EXTRA)
