"""PoseResNet (SimpleBaseline, Xiao et al., ECCV 2018), NCHW PyTorch.

Counterpart of ``fhpe_tpu/models/pose_resnet.py``: a ResNet-{18,34,50,
101,152} trunk, transposed convs that each double H and W, and a heatmap
head.  Module names follow the reference's torch layout, so
``state_dict()`` keys are exactly what
``fhpe_tpu.utils.torch_import.import_pose_resnet`` reads and the
reference's published ``.pth`` files load as they are:

* stem ``conv1`` (7x7/s2), ``bn1``, then ReLU and a 3x3/s2 max pool;
* ``layer{i}.{b}.{conv,bn}{1,2,3}`` (Bottleneck for 50/101/152,
  BasicBlock for 18/34, stride on the 3x3 conv), ``layer{i}.0.downsample.
  {0,1}`` where the first block changes stride or width;
* ``deconv_layers.{3i,3i+1}``: ``ConvTranspose2d`` and BatchNorm, which
  applies the ReLU the reference has at ``3i+2`` (an ``nn.Identity``
  here);
* ``final_layer``: the conv with bias that writes the heatmaps.

Every 3x3 stride-1 conv of the trunk (13 in PoseResNet-50) runs its
forward on the conv3x3_fwd kernel (``ops/conv3x3_fwd.py``) and, in
training, its filter gradient on P4 (``models/common.py::Conv3x3``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BasicBlock, Bottleneck, batch_norm, deconv_decoder,
                     init_decoder)

RESNET_SPEC = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


class PoseResNet(nn.Module):
    """PoseResNet; ``forward`` returns one ``(B, J, H/4, W/4)`` heatmap
    tensor in at least float32 (bf16 compute under autocast is cast up, as
    ``fhpe_tpu`` does)."""

    flow_blocks = (BasicBlock, Bottleneck, nn.ConvTranspose2d)

    def __init__(self, num_layers: int = 50, num_joints: int = 17,
                 num_deconv_layers: int = 3,
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 num_deconv_kernels: Sequence[int] = (4, 4, 4),
                 deconv_with_bias: bool = False,
                 final_conv_kernel: int = 1):
        super().__init__()
        block, layers = RESNET_SPEC[num_layers]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64, relu=True)
        inplanes = 64
        for i, (planes, stride) in enumerate(zip((64, 128, 256, 512),
                                                 (1, 2, 2, 2))):
            out_ch = planes * block.expansion
            blocks = [block(inplanes, planes, stride,
                            downsample=stride != 1 or inplanes != out_ch,
                            fwd_kernel=True)]
            blocks += [block(out_ch, planes, fwd_kernel=True)
                       for _ in range(1, layers[i])]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            inplanes = out_ch

        self.deconv_layers, self.final_layer = deconv_decoder(
            inplanes, num_joints, num_deconv_filters[:num_deconv_layers],
            num_deconv_kernels[:num_deconv_layers], deconv_with_bias,
            final_conv_kernel)
        self.init_weights()

    def init_weights(self) -> None:
        """Reference init (from scratch): conv and transposed-conv kernels
        normal(0, 0.001), their biases 0, BatchNorm weight 1 and bias 0."""
        init_decoder(self.modules())

    def forward(self, x) -> torch.Tensor:
        x = F.max_pool2d(self.bn1(self.conv1(x)), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        out = self.final_layer(self.deconv_layers(x))
        return out.to(torch.promote_types(torch.float32, out.dtype))


def get_pose_net(cfg) -> PoseResNet:
    extra = cfg.MODEL.EXTRA
    return PoseResNet(
        num_layers=extra.NUM_LAYERS,
        num_joints=cfg.MODEL.NUM_JOINTS,
        num_deconv_layers=extra.NUM_DECONV_LAYERS,
        num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
        num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
        deconv_with_bias=extra.DECONV_WITH_BIAS,
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
    )
