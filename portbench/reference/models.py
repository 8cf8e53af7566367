"""Plain PyTorch hourglass and HRNet, the benchmark's reference networks.

A frozen, self-contained copy of the two architectures as published
(Newell et al. 2016 as FPD uses it; Sun et al. 2019), with the module
names of the reference ``.pth`` layout, so that one state dict loads into
these and into the measured program alike.  Every conv is a
:class:`RefConv`: ``torch.nn.functional.conv2d`` in float32, or, for the
precision control, on operands rounded to fp8 first.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .precision import fake_quant, grad_quant


class RefConv(nn.Conv2d):
    """``nn.Conv2d`` with torch-style padding; ``precision`` ``"fp8"``
    rounds input and weight to scaled e4m3 before the float32 conv and the
    gradient of its output to scaled e5m2 in the backward."""

    precision = "float32"

    def forward(self, x):
        if self.precision != "fp8":
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding)
        return grad_quant(F.conv2d(fake_quant(x), fake_quant(self.weight),
                                   self.bias, self.stride, self.padding))


def conv(cin, cout, k, stride=1, bias=True):
    return RefConv(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                   bias=bias)


def bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def residual_out(module: nn.Module) -> nn.Module:
    """Marks the last layer of a residual branch (what is added to the
    residual), which the benchmark's weights draw small."""
    module.residual_out = True
    return module


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    for m in model.modules():
        if isinstance(m, RefConv):
            m.precision = precision
    return model


# -- stacked hourglass --------------------------------------------------------

class HgBottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 2, biased convs."""

    def __init__(self, inplanes, planes):
        super().__init__()
        self.bn1, self.conv1 = bn(inplanes), conv(inplanes, planes, 1)
        self.bn2, self.conv2 = bn(planes), conv(planes, planes, 3)
        self.bn3 = bn(planes)
        self.conv3 = residual_out(conv(planes, planes * 2, 1))
        self.downsample = (nn.Sequential(conv(inplanes, planes * 2, 1))
                           if inplanes != planes * 2 else None)

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + (x if self.downsample is None else self.downsample(x))


def _chain(inplanes, planes, n):
    return nn.Sequential(HgBottleneck(inplanes, planes),
                         *[HgBottleneck(planes * 2, planes)
                           for _ in range(1, n)])


class Hourglass(nn.Module):
    def __init__(self, planes, blocks, depth=4):
        super().__init__()
        self.depth = depth
        self.hg = nn.ModuleList(
            nn.ModuleList(_chain(planes * 2, planes, blocks)
                          for _ in range(4 if n == 0 else 3))
            for n in range(depth))

    def _level(self, n, x):
        res = self.hg[n - 1]
        up1 = res[0](x)
        low1 = res[1](F.max_pool2d(x, 2, 2))
        low2 = self._level(n - 1, low1) if n > 1 else res[3](low1)
        low3 = res[2](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(self.depth, x)


class HourglassNet(nn.Module):
    """Returns the list of every stack's heatmaps."""

    multi_output = True

    def __init__(self, num_stacks, num_blocks, num_features, num_joints):
        super().__init__()
        inplanes, feats = num_features // 4, num_features // 2
        ch = feats * 2
        self.conv1, self.bn1 = conv(3, inplanes, 7, 2), bn(inplanes)
        self.layer1 = _chain(inplanes, inplanes, 1)
        self.layer2 = _chain(inplanes * 2, inplanes * 2, 1)
        self.layer3 = _chain(inplanes * 4, feats, 1)
        self.hg = nn.ModuleList(Hourglass(feats, num_blocks)
                                for _ in range(num_stacks))
        self.res = nn.ModuleList(_chain(ch, feats, num_blocks)
                                 for _ in range(num_stacks))
        self.fc = nn.ModuleList(nn.Sequential(conv(ch, ch, 1), bn(ch),
                                              nn.ReLU())
                                for _ in range(num_stacks))
        self.score = nn.ModuleList(conv(ch, num_joints, 1)
                                   for _ in range(num_stacks))
        self.fc_ = nn.ModuleList(conv(ch, ch, 1)
                                 for _ in range(num_stacks - 1))
        self.score_ = nn.ModuleList(conv(num_joints, ch, 1)
                                    for _ in range(num_stacks - 1))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(F.max_pool2d(self.layer1(x), 2, 2))
        x = self.layer3(x)
        outs = []
        for i in range(len(self.hg)):
            y = self.fc[i](self.res[i](self.hg[i](x)))
            score = self.score[i](y)
            outs.append(score)
            if i < len(self.hg) - 1:
                x = x + self.fc_[i](y) + self.score_[i](score)
        return outs


# -- HRNet --------------------------------------------------------------------

class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, downsample=False):
        super().__init__()
        self.conv1, self.bn1 = conv(inplanes, planes, 3, bias=False), bn(planes)
        self.conv2 = conv(planes, planes, 3, bias=False)
        self.bn2 = residual_out(bn(planes))
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, bias=False),
                                         bn(planes)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, downsample=False):
        super().__init__()
        self.conv1, self.bn1 = conv(inplanes, planes, 1, bias=False), bn(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, bias=False), bn(planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = residual_out(bn(planes * 4))
        self.downsample = (nn.Sequential(conv(inplanes, planes * 4, 1,
                                              bias=False), bn(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _branch(block, inplanes, planes, n):
    out = planes * block.expansion
    return nn.Sequential(block(inplanes, planes, downsample=inplanes != out),
                         *[block(out, planes) for _ in range(1, n)])


def _conv_bn(cin, cout, stride, relu):
    layers = [conv(cin, cout, 3, stride, bias=False), bn(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class Upsample(nn.Module):
    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.factor, mode="nearest")


class HRModule(nn.Module):
    def __init__(self, block, blocks, channels, in_ch, multi_scale):
        super().__init__()
        cls = BLOCKS[block]
        nb = len(channels)
        out = [c * cls.expansion for c in channels]
        self.branches = nn.ModuleList(
            _branch(cls, in_ch[b], channels[b], blocks[b]) for b in range(nb))
        self.fuse_layers = None
        if nb > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(i, j, out) for j in range(nb))
                for i in range(nb if multi_scale else 1))

    @staticmethod
    def _fuse(i, j, ch):
        if j == i:
            return None
        if j > i:
            return nn.Sequential(conv(ch[j], ch[i], 1, bias=False), bn(ch[i]),
                                 Upsample(2 ** (j - i)))
        steps = i - j
        return nn.Sequential(*(
            _conv_bn(ch[j], ch[i] if k == steps - 1 else ch[j], 2,
                     relu=k < steps - 1) for k in range(steps)))

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        out = []
        for row in self.fuse_layers:
            y = None
            for layer, x in zip(row, xs):
                t = x if layer is None else layer(x)
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


def _transition(prev, cur):
    layers = []
    for i, ch in enumerate(cur):
        if i < len(prev):
            layers.append(_conv_bn(prev[-1], ch, 1, True)
                          if ch != prev[i] else None)
        else:
            steps = i + 1 - len(prev)
            layers.append(nn.Sequential(*(
                _conv_bn(prev[-1], ch if k == steps - 1 else prev[-1], 2, True)
                for k in range(steps))))
    return nn.ModuleList(layers)


class HRNet(nn.Module):
    """Returns the heatmaps of the highest-resolution branch."""

    multi_output = False

    def __init__(self, stages, num_joints, final_kernel=1):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 3, 2, bias=False), bn(64)
        self.conv2, self.bn2 = conv(64, 64, 3, 2, bias=False), bn(64)
        self.layer1 = _branch(Bottleneck, 64, 64, 4)
        prev = [256]
        for s, st in zip((2, 3, 4), stages):
            cur = [c * BLOCKS[st["BLOCK"]].expansion
                   for c in st["NUM_CHANNELS"]]
            setattr(self, f"transition{s - 1}", _transition(prev, cur))
            n = st["NUM_MODULES"]
            setattr(self, f"stage{s}", nn.Sequential(*(
                HRModule(st["BLOCK"], st["NUM_BLOCKS"], st["NUM_CHANNELS"],
                         cur, multi_scale=not (s == 4 and m == n - 1))
                for m in range(n))))
            prev = cur
        self.final_layer = conv(prev[0], num_joints, final_kernel)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            xs = [xs[i] if t is None else t(xs[-1])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s}")(xs)
        return self.final_layer(xs[0])


def build(model_cfg: dict) -> nn.Module:
    """The network of a configuration file's ``MODEL`` group."""
    extra = model_cfg["EXTRA"]
    if model_cfg["NAME"] == "hourglass":
        return HourglassNet(extra["NUM_STACKS"], extra["NUM_BLOCKS"],
                            extra["NUM_FEATURES"], model_cfg["NUM_JOINTS"])
    if model_cfg["NAME"] == "pose_hrnet":
        return HRNet([extra[f"STAGE{s}"] for s in (2, 3, 4)],
                     model_cfg["NUM_JOINTS"], extra["FINAL_CONV_KERNEL"])
    raise KeyError(model_cfg["NAME"])


def final_heatmaps(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    out = model(x)
    return out[-1] if model.multi_output else out
