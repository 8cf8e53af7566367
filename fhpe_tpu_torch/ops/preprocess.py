"""Device preprocessing: uint8 NHWC crops -> normalized float NCHW.

Counterpart of ``fhpe_tpu.ops.preprocess.normalize_images_jax`` (an XLA
fusion there, not a Pallas kernel): ToTensor (/255) then Normalize with
the ImageNet mean/std, computed in float32 and cast at the end.
"""

from __future__ import annotations

import torch

from ..utils.graph import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) ``dtype``, on ``images.device``."""
    mean, std = (constant(v, torch.float32, images.device).view(1, 3, 1, 1)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))
    x = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype).contiguous()
