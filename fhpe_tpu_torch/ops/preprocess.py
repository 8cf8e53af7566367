"""Device preprocessing: uint8 NHWC crops -> normalized float NCHW, and
the crop of ``TPU.DEVICE_WARP`` from a letterbox canvas.

Counterparts of ``fhpe_tpu.ops.preprocess``'s ``normalize_images_jax``
and ``warp_affine_jax`` (XLA fusions there, not Pallas kernels; plain
PyTorch here, inside the captured step):

* :func:`normalize_images`: ToTensor (/255) then Normalize with the
  ImageNet mean/std, computed in float32 and cast at the end;
* :func:`warp_affine`: a batched bilinear affine warp with a constant-0
  border, ``cv2.warpAffine(..., INTER_LINEAR)``'s sampling in float32:
  output pixel (x, y) samples the source at ``inv_trans @ (x, y, 1)``
  with four gathers, the arithmetic in ``fhpe_tpu``'s order.
"""

from __future__ import annotations

import torch

from ..utils.graph import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8, or float in [0, 255] -> (B, 3, H, W)
    ``dtype``, on ``images.device``."""
    mean, std = (constant(v, torch.float32, images.device).view(1, 3, 1, 1)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))
    x = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype).contiguous()


def warp_affine(images: torch.Tensor, inv_trans: torch.Tensor,
                out_size) -> torch.Tensor:
    """(B, H, W, C) uint8 or float sources and (B, 2, 3) dst->src
    matrices -> (B, oh, ow, C) float32 crops; ``out_size`` is (width,
    height).  Taps outside the source read 0."""
    ow, oh = int(out_size[0]), int(out_size[1])
    b, h, w, _ = images.shape
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    t = inv_trans.to(torch.float32)[:, :, :, None, None]   # (B, 2, 3, 1, 1)
    sx = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    sy = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    bi = torch.arange(b, device=dev)[:, None, None]

    def sample(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return vals.to(torch.float32) * inb[..., None].to(torch.float32)

    v00, v01 = sample(y0, x0), sample(y0, x0 + 1)
    v10, v11 = sample(y0 + 1, x0), sample(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
