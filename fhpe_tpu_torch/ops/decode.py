"""Heatmap -> keypoint decoding, NCHW.

Counterpart of ``fhpe_tpu/ops/decode.py`` (``get_max_preds_jax``,
``quarter_offset_jax``, ``decode_heatmaps_jax``) and of its Pallas kernel
``fhpe_tpu/ops/decode_pallas.py`` (K1).  Two forms of the per-row work,
the flat argmax (first maximum wins ties), the <= 0 mask and the
quarter-pixel offset:

* the plain PyTorch version, :func:`get_max_preds_torch` +
  :func:`quarter_offset_torch`;
* the CUDA kernel ``ops/csrc/decode.cu``, bit-equal to it.

:func:`decode_argmax` sends a CUDA tensor to the kernel (it never falls
back) and a CPU tensor to the plain version.  :func:`decode_heatmaps`
then maps the result back to source-image coordinates.
:func:`get_max_preds` is ``fhpe_tpu``'s numpy argmax, copied (pinned by
``tests/test_torch_port_hygiene.py``): the debug images
(``utils/vis.py``) decode on the host with it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.affine import get_affine_transform
from . import _build

# Launches of the decode kernel in this process (one per call that reaches
# the kernel; a captured step takes back its capture's calls and adds them
# again at each replay, utils/graph.py); a run reads it to show the main
# path went through the kernel.
decode_kernel_launches = 0


def get_max_preds_torch(heatmaps: torch.Tensor):
    """(B, J, H, W) -> coords (B, J, 2) float32 (x, y), maxvals (B, J)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    idx = torch.argmax(flat, dim=-1)
    maxvals = flat.gather(-1, idx[..., None])[..., 0]
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    coords = torch.stack([x, y], dim=-1)
    return coords * (maxvals > 0.0)[..., None].to(torch.float32), maxvals


def get_max_preds(batch_heatmaps: np.ndarray):
    """(B, J, H, W) -> preds (B, J, 2) in (x, y), maxvals (B, J, 1)."""
    assert batch_heatmaps.ndim == 4
    b, j, _, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape((b, j, -1))
    idx = np.argmax(flat, 2).reshape((b, j, 1))
    maxvals = np.amax(flat, 2).reshape((b, j, 1))

    preds = np.tile(idx, (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = preds[:, :, 0] % w
    preds[:, :, 1] = np.floor(preds[:, :, 1] / w)
    preds *= np.tile(np.greater(maxvals, 0.0), (1, 1, 2)).astype(np.float32)
    return preds, maxvals


def quarter_offset_torch(coords: torch.Tensor, heatmaps: torch.Tensor):
    """+-0.25 px shift toward the larger neighbour where 1 < p < size - 1."""
    b, j, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).to(torch.int64)
    py = torch.floor(coords[..., 1] + 0.5).to(torch.int64)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    flat = heatmaps.reshape(b, j, h * w)
    base = torch.where(ok, py * w + px, torch.zeros_like(px))

    def take(i):  # indices are in range wherever ok; clamp the rest
        return flat.gather(-1, i.clamp(0, h * w - 1)[..., None])[..., 0]

    dx = take(base + 1) - take(base - 1)
    dy = take(base + w) - take(base - w)
    delta = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + delta.to(coords.dtype) * ok[..., None].to(coords.dtype)


def decode_argmax_plain(heatmaps: torch.Tensor, post_process: bool = True):
    """The plain version of the decode kernel, on any device."""
    coords, maxvals = get_max_preds_torch(heatmaps)
    if post_process:
        coords = quarter_offset_torch(coords, heatmaps)
    return coords, maxvals


def _decode_kernel(heatmaps: torch.Tensor, post_process: bool):
    global decode_kernel_launches
    if heatmaps.dtype != torch.float32:
        raise ValueError(f"decode kernel takes float32 heatmaps, got "
                         f"{heatmaps.dtype}")
    if not heatmaps.is_contiguous():
        raise ValueError("decode kernel takes contiguous NCHW heatmaps")
    b, j, h, w = heatmaps.shape
    rows = b * j
    if rows >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError(f"decode kernel: shape {tuple(heatmaps.shape)} "
                         f"exceeds 32-bit row indexing")
    coords = torch.empty((b, j, 2), dtype=torch.float32,
                         device=heatmaps.device)
    maxvals = torch.empty((b, j), dtype=torch.float32, device=heatmaps.device)
    if rows == 0:
        return coords, maxvals
    lib = _build.load_library()
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_decode_heatmaps(
            heatmaps.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
            rows, h, w, int(bool(post_process)), stream)
    _build.check(lib, code, "decode kernel launch")
    decode_kernel_launches += 1
    return coords, maxvals


def decode_argmax(heatmaps: torch.Tensor, post_process: bool = True):
    """(B, J, H, W) heatmaps -> coords (B, J, 2) float32, maxvals (B, J).

    A CUDA tensor goes to the kernel (float32, contiguous, else raises);
    a CPU tensor goes to the plain version.
    """
    if heatmaps.dim() != 4 or min(heatmaps.shape[2:]) < 1:
        raise ValueError(f"heatmaps must be (B, J, H, W) with H, W >= 1; "
                         f"got {tuple(heatmaps.shape)}")
    if heatmaps.device.type == "cuda":
        return _decode_kernel(heatmaps, post_process)
    if heatmaps.device.type == "cpu":
        return decode_argmax_plain(heatmaps, post_process)
    raise ValueError(f"decode: unsupported device {heatmaps.device}")


def decode_heatmaps(heatmaps: torch.Tensor, inv_trans=None,
                    post_process: bool = True):
    """Full decode: argmax [+ quarter offset] [-> inverse affine].

    heatmaps: (B, J, H, W) NCHW.  inv_trans: (B, 2, 3) heatmap -> source
    affines (:func:`make_inverse_transforms`), or None to keep heatmap
    coordinates.  The affine is written as separate multiplies and adds
    in float32, so no matmul precision setting (TF32) reaches it and the
    card and the CPU round alike.  Returns (preds (B, J, 2), maxvals (B, J)).
    """
    coords, maxvals = decode_argmax(heatmaps, post_process)
    if inv_trans is not None:
        t = inv_trans.to(coords.dtype)
        x, y = coords[..., 0], coords[..., 1]
        px = t[:, 0, 0, None] * x + t[:, 0, 1, None] * y + t[:, 0, 2, None]
        py = t[:, 1, 0, None] * x + t[:, 1, 1, None] * y + t[:, 1, 2, None]
        coords = torch.stack([px, py], dim=-1)
    return coords, maxvals


def make_inverse_transforms(centers, scales, heatmap_size) -> np.ndarray:
    """(N, 2, 3) float32 heatmap -> source affines for a batch (host)."""
    n = len(centers)
    out = np.zeros((n, 2, 3), dtype=np.float32)
    for i in range(n):
        out[i] = get_affine_transform(centers[i], scales[i], 0, heatmap_size,
                                      inv=True)
    return out
