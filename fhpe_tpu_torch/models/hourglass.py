"""Stacked Hourglass network (Newell et al., ECCV 2016), NCHW PyTorch.

Counterpart of ``fhpe_tpu/models/hourglass.py`` (teacher: stacks=8 /
features=256, student: stacks=4 / features=128, FPD CVPR'19).  Module
names follow the reference's torch layout, so ``state_dict()`` keys are
exactly what ``fhpe_tpu.utils.torch_import.import_hourglass`` reads and
the reference's published ``.pth`` files load directly:

* stem ``conv1``, ``bn1``, ``layer{1,2,3}.0`` (``downsample.0`` where the
  channel count changes);
* ``hg.{s}.hg.{n}.{j}.{b}`` with ``n = level - 1`` and ``j`` 0 = up1,
  1 = low1, 2 = low3, 3 = low2 (innermost level only);
* per stack ``res.{s}.{b}``, ``fc.{s}.0`` (conv), ``fc.{s}.1`` (BN),
  ``score.{s}``; between stacks ``fc_.{s}`` and ``score_.{s}``.

``NUM_FEATURES`` is halved inside: stem planes ``features/4``, hourglass
planes ``features/2``, blocks output ``features``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .common import batch_norm, conv, max_pool_2x2, upsample_nearest


class Bottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 2, biased convs.

    ``biased=False`` (``TPU.DEAD_BIAS_SKIP``) drops the conv biases, each
    of which feeds a BatchNorm through ops that commute with a constant,
    so BN absorbs it exactly (``fhpe_tpu/models/hourglass.py``).
    """

    expansion = 2

    def __init__(self, inplanes: int, planes: int, biased: bool = True):
        super().__init__()
        self.bn1 = batch_norm(inplanes, relu=True)
        self.conv1 = conv(inplanes, planes, 1, bias=biased)
        self.bn2 = batch_norm(planes, relu=True)
        self.conv2 = conv(planes, planes, 3, bias=biased)
        self.bn3 = batch_norm(planes, relu=True)
        self.conv3 = conv(planes, planes * 2, 1, bias=biased)
        self.downsample = None
        if inplanes != planes * 2:
            self.downsample = nn.Sequential(
                conv(inplanes, planes * 2, 1, bias=biased))

    def forward(self, x):
        out = self.conv1(self.bn1(x))
        out = self.conv2(self.bn2(out))
        out = self.conv3(self.bn3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


def residual_chain(inplanes: int, planes: int, num_blocks: int,
                   biased: bool) -> nn.Sequential:
    """``num_blocks`` bottlenecks at ``planes`` (the first may downsample)."""
    blocks = [Bottleneck(inplanes, planes, biased)]
    blocks += [Bottleneck(planes * 2, planes, biased)
               for _ in range(1, num_blocks)]
    return nn.Sequential(*blocks)


class Hourglass(nn.Module):
    """One depth-``depth`` hourglass over ``planes*2``-channel features."""

    def __init__(self, planes: int, num_blocks: int, depth: int = 4,
                 biased: bool = True):
        super().__init__()
        self.depth = depth
        ch = planes * 2
        self.hg = nn.ModuleList(
            nn.ModuleList(residual_chain(ch, planes, num_blocks, biased)
                          for _ in range(4 if n == 0 else 3))
            for n in range(depth))

    def _level(self, n: int, x):
        res = self.hg[n - 1]
        up1 = res[0](x)
        low1 = res[1](max_pool_2x2(x))
        low2 = self._level(n - 1, low1) if n > 1 else res[3](low1)
        low3 = res[2](low2)
        return up1 + upsample_nearest(low3)

    def forward(self, x):
        return self._level(self.depth, x)


class HourglassNet(nn.Module):
    """Stacked hourglass; ``forward`` returns one heatmap per stack.

    Input NCHW ``(B, 3, H, W)``; output a list of ``(B, J, H/4, W/4)``
    heatmaps in at least float32 (bf16 compute under autocast is cast up,
    as ``fhpe_tpu`` does).
    """

    flow_blocks = (Bottleneck, Hourglass)   # common.bf16_flow_violations

    def __init__(self, num_stacks: int = 8, num_blocks: int = 1,
                 num_features: int = 256, num_joints: int = 16,
                 dead_bias_skip: bool = False):
        super().__init__()
        inplanes = num_features // 4
        feats = num_features // 2
        ch = feats * 2
        b = not dead_bias_skip
        self.num_stacks = num_stacks

        self.conv1 = conv(3, inplanes, 7, stride=2, bias=b)
        self.bn1 = batch_norm(inplanes, relu=True)
        self.layer1 = residual_chain(inplanes, inplanes, 1, b)
        self.layer2 = residual_chain(inplanes * 2, inplanes * 2, 1, b)
        self.layer3 = residual_chain(inplanes * 4, feats, 1, b)

        self.hg = nn.ModuleList(Hourglass(feats, num_blocks, 4, b)
                                for _ in range(num_stacks))
        self.res = nn.ModuleList(residual_chain(ch, feats, num_blocks, b)
                                 for _ in range(num_stacks))
        self.fc = nn.ModuleList(
            nn.Sequential(conv(ch, ch, 1, bias=b), batch_norm(ch, relu=True))
            for _ in range(num_stacks))
        # score heads keep their bias: no BatchNorm follows the heatmaps
        self.score = nn.ModuleList(conv(ch, num_joints, 1, bias=True)
                                   for _ in range(num_stacks))
        self.fc_ = nn.ModuleList(conv(ch, ch, 1, bias=b)
                                 for _ in range(num_stacks - 1))
        self.score_ = nn.ModuleList(conv(num_joints, ch, 1, bias=b)
                                    for _ in range(num_stacks - 1))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.bn1(self.conv1(x))
        x = self.layer1(x)
        x = max_pool_2x2(x)
        x = self.layer2(x)
        x = self.layer3(x)

        outs = []
        for i in range(self.num_stacks):
            y = self.res[i](self.hg[i](x))
            y = self.fc[i](y)
            score = self.score[i](y)
            outs.append(score.to(torch.promote_types(torch.float32,
                                                     score.dtype)))
            if i < self.num_stacks - 1:
                x = x + self.fc_[i](y) + self.score_[i](score)
        return outs


def get_pose_net(cfg) -> HourglassNet:
    extra = cfg.MODEL.EXTRA
    return HourglassNet(
        num_stacks=extra.NUM_STACKS,
        num_blocks=extra.NUM_BLOCKS,
        num_features=extra.NUM_FEATURES,
        num_joints=cfg.MODEL.NUM_JOINTS,
        dead_bias_skip=bool(cfg.TPU.get("DEAD_BIAS_SKIP", False)),
    )
