"""HRNet pose backbone (Sun et al., CVPR 2019), NCHW PyTorch.

Counterpart of ``fhpe_tpu/models/pose_hrnet.py`` (FPD's COCO pair: W48
teacher, W32 student).  Module names follow the reference's torch layout,
so ``state_dict()`` keys are exactly what
``fhpe_tpu.utils.torch_import.import_hrnet`` reads and the reference's
published ``.pth`` files load as they are:

* stem ``conv1``, ``bn1``, ``conv2``, ``bn2``; ``layer1.{b}`` (four
  Bottleneck-64, ``downsample.{0,1}`` on the first);
* ``transition{s-1}.{i}`` builds stage ``s``'s inputs: ``.{0,1}`` (conv,
  BN) where an existing branch changes width, ``.{k}.{0,1}`` for the
  strided chain that creates a new branch, nothing where it is identity;
* ``stage{s}.{m}.branches.{b}.{blk}`` and
  ``stage{s}.{m}.fuse_layers.{i}.{j}``: ``.{0,1}`` (1x1 conv, BN, then a
  nearest upsample) for j > i, ``.{k}.{0,1}`` (strided 3x3 conv, BN, ReLU
  but the last) for j < i;
* ``final_layer`` on the highest-resolution branch only (the last stage-4
  module has ``multi_scale_output=False``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.branch_chain import BranchChainFn, branch_chain_eval
from .common import (BasicBlock, Bottleneck, Conv3x3, UpsampleNearest,
                     batch_norm, conv)

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(in_ch: int, out_ch: int, kernel: int, stride: int,
             relu: bool) -> nn.Sequential:
    return nn.Sequential(conv(in_ch, out_ch, kernel, stride, bias=False),
                         batch_norm(out_ch, relu=relu))


class BranchChain(nn.Sequential):
    """One branch's blocks (``fhpe_tpu``'s ``BranchChain``), keyed as the
    reference's ``nn.Sequential``.

    A chain of BASIC blocks with identity residuals (every branch of a
    ``HighResolutionModule``) runs as one P5 call
    (``ops/branch_chain.py``): ``branch_chain_eval`` in eval mode,
    ``BranchChainFn`` in train mode, which returns the batch statistics;
    the running statistics then move as ``nn.BatchNorm2d`` moves them
    (momentum, or the cumulative average when it is None; Bessel-corrected
    variance).  Under autocast the chain gets the bf16 copies of x and the
    conv weights, as ``Conv3x3`` does; BatchNorm parameters stay float32.
    Any other chain (a projecting first block, Bottlenecks), one with
    ``fused`` set to False, or an eval-mode chain with gradients on (the
    eval kernel has no backward; a frozen-BN fine-tune) runs its blocks
    one by one.
    """

    def __init__(self, *blocks):
        super().__init__(*blocks)
        self.fused = all(isinstance(b, BasicBlock) and b.downsample is None
                         and isinstance(b.conv1, Conv3x3) for b in blocks)

    def forward(self, x):
        if not self.fused or (not self.training and torch.is_grad_enabled()):
            return super().forward(x)
        convs = [cv for b in self for cv in (b.conv1, b.conv2)]
        bns = [bn for b in self for bn in (b.bn1, b.bn2)]
        weights = [cv.weight for cv in convs]
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dt = torch.get_autocast_dtype(dev)
            x, weights = x.to(dt), [w.to(dt) for w in weights]
        gammas = [bn.weight for bn in bns]
        betas = [bn.bias for bn in bns]
        eps = bns[0].eps
        if not self.training:
            return branch_chain_eval(
                x, weights, gammas, betas, [bn.running_mean for bn in bns],
                [bn.running_var for bn in bns], eps)
        y, mean, var = BranchChainFn.apply(x, eps, *weights, *gammas, *betas)
        _update_running_stats(bns, mean, var, x.numel() // x.shape[1])
        return y


@torch.no_grad()
def _update_running_stats(bns, mean, var, n: int) -> None:
    """``nn.BatchNorm2d``'s train-mode update of each BN's running mean and
    (Bessel-corrected) variance from the batch statistics rows."""
    torch._foreach_add_([bn.num_batches_tracked for bn in bns], 1)
    # momentum None: the cumulative moving average, whose factor is read
    # from the card; a captured step would freeze it at the capture
    if (any(bn.momentum is None for bn in bns)
            and mean.is_cuda and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "BatchNorm momentum None (a cumulative average) cannot run in a "
            "captured step: its factor 1 / num_batches_tracked is read from "
            "the card; set a momentum")
    fs = [1.0 / float(bn.num_batches_tracked) if bn.momentum is None
          else bn.momentum for bn in bns]
    bessel = n / max(n - 1, 1)
    for key, batch, scale in (("running_mean", mean, 1.0),
                              ("running_var", var, bessel)):
        running = [getattr(bn, key) for bn in bns]
        torch._foreach_mul_(running, [1.0 - f for f in fs])
        torch._foreach_add_(running, torch._foreach_mul(
            list(batch.unbind(0)), [f * scale for f in fs]))


def _branch(block, inplanes: int, planes: int, num_blocks: int):
    """``num_blocks`` blocks at ``planes`` (the first may project)."""
    out_ch = planes * block.expansion
    layers = [block(inplanes, planes, downsample=inplanes != out_ch)]
    layers += [block(out_ch, planes) for _ in range(1, num_blocks)]
    return BranchChain(*layers)


class HighResolutionModule(nn.Module):
    """Per-branch residual chains, then the full fuse matrix summed and
    ReLU'd per output branch (only branch 0 when not
    ``multi_scale_output``)."""

    def __init__(self, block: str, num_blocks: Sequence[int],
                 num_channels: Sequence[int], in_channels: Sequence[int],
                 multi_scale_output: bool = True):
        super().__init__()
        cls = BLOCKS[block]
        nb = len(num_channels)
        out_ch = [c * cls.expansion for c in num_channels]
        self.branches = nn.ModuleList(
            _branch(cls, in_channels[b], num_channels[b], num_blocks[b])
            for b in range(nb))
        self.fuse_layers = None
        if nb > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(i, j, out_ch) for j in range(nb))
                for i in range(nb if multi_scale_output else 1))

    @staticmethod
    def _fuse(i: int, j: int, ch: Sequence[int]):
        if j == i:
            return None
        if j > i:   # low -> high resolution
            return nn.Sequential(conv(ch[j], ch[i], 1, bias=False),
                                 batch_norm(ch[i]),
                                 UpsampleNearest(2 ** (j - i)))
        steps = i - j   # high -> low: strided 3x3 chain
        return nn.Sequential(*(
            _conv_bn(ch[j], ch[i] if k == steps - 1 else ch[j], 3, 2,
                     relu=k < steps - 1)
            for k in range(steps)))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for row in self.fuse_layers:
            y = None
            for j, (layer, x) in enumerate(zip(row, xs)):
                t = x if layer is None else layer(x)
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


def _transition(prev: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    layers = []
    for i, ch in enumerate(cur):
        if i < len(prev):
            # Reference quirk kept: a non-identity transition on an existing
            # branch reads the LOWEST-resolution input (forward below), so
            # its conv takes prev[-1] channels.  In every shipped config it
            # is reached only from the single stage-1 branch.
            layers.append(_conv_bn(prev[-1], ch, 3, 1, relu=True)
                          if ch != prev[i] else None)
        else:   # a new branch: strided convs from the lowest-res branch
            steps = i + 1 - len(prev)
            layers.append(nn.Sequential(*(
                _conv_bn(prev[-1], ch if k == steps - 1 else prev[-1], 3, 2,
                         relu=True)
                for k in range(steps))))
    return nn.ModuleList(layers)


class PoseHighResolutionNet(nn.Module):
    """HRNet; ``forward`` returns one ``(B, J, H/4, W/4)`` heatmap tensor
    in at least float32 (bf16 compute under autocast is cast up, as
    ``fhpe_tpu`` does)."""

    flow_blocks = (BasicBlock, Bottleneck, UpsampleNearest, BranchChain)

    def __init__(self, stage2: dict, stage3: dict, stage4: dict,
                 num_joints: int = 17, final_conv_kernel: int = 1):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, bias=False)
        self.bn1 = batch_norm(64, relu=True)
        self.conv2 = conv(64, 64, 3, 2, bias=False)
        self.bn2 = batch_norm(64, relu=True)
        self.layer1 = _branch(Bottleneck, 64, 64, 4)

        prev = [256]
        for s, scfg in ((2, stage2), (3, stage3), (4, stage4)):
            exp = BLOCKS[scfg["BLOCK"]].expansion
            cur = [c * exp for c in scfg["NUM_CHANNELS"]]
            setattr(self, f"transition{s - 1}", _transition(prev, cur))
            n = scfg["NUM_MODULES"]
            setattr(self, f"stage{s}", nn.Sequential(*(
                HighResolutionModule(
                    scfg["BLOCK"], scfg["NUM_BLOCKS"], scfg["NUM_CHANNELS"],
                    cur, multi_scale_output=not (s == 4 and m == n - 1))
                for m in range(n))))
            prev = cur

        self.final_layer = nn.Conv2d(
            prev[0], num_joints, final_conv_kernel,
            padding=1 if final_conv_kernel == 3 else 0)
        self.init_weights()

    def init_weights(self) -> None:
        """Reference init: conv kernels normal(0, 0.001), conv biases 0,
        BatchNorm weight 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, std=0.001)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        x = self.bn2(self.conv2(x))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            xs = [xs[i] if t is None else t(xs[-1])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s}")(xs)
        out = self.final_layer(xs[0])
        return out.to(torch.promote_types(torch.float32, out.dtype))


def get_pose_net(cfg) -> PoseHighResolutionNet:
    extra = cfg.MODEL.EXTRA
    return PoseHighResolutionNet(
        stage2=dict(extra.STAGE2),
        stage3=dict(extra.STAGE3),
        stage4=dict(extra.STAGE4),
        num_joints=cfg.MODEL.NUM_JOINTS,
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
    )
