"""Filter gradient of a 3x3, stride-1, same-pad convolution, NCHW.

Counterpart of the Pallas kernel ``scripts/probe/dw_pallas_probe.py``
(``dw_pallas``, P4), which computes ``dW[r, c] = sum_{b,h,w}
xpad[b, h+r, w+c, :]^T . dy[b, h, w, :]`` in float32 for NHWC inputs with
C_in = C_out = C.  Here x and dy are NCHW and dW comes out in torch's OIHW
weight layout, ``(C, C, 3, 3)`` float32.  Two forms:

* the plain PyTorch version, :func:`conv3x3_wgrad_plain` (nine tap
  products in float32, in the Pallas kernel's order);
* the CUDA kernel ``ops/csrc/conv_wgrad.cu`` (split-K implicit GEMM with
  a fixed-order reduction: two runs give the same bits).

:func:`conv3x3_wgrad` sends CUDA tensors to the kernel (it never falls
back) and CPU tensors to the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# Launches of the wgrad kernel in this process (one per call that reaches
# the kernel); a run reads it to show the main path went through the kernel.
conv_wgrad_launches = 0

_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# Tile sizes of conv_wgrad.cu, and the blocks split-K aims for: about three
# resident blocks on each of an H100's 132 SMs.
TILE, K_STEP = 64, 32
TARGET_BLOCKS = 396
MIN_STEPS_PER_SLICE = 4


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"x and dy must be (B, C, H, W); got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.shape != dy.shape:
        raise ValueError(f"3x3 stride-1 same-pad conv with C_in == C_out: x "
                         f"and dy must have one shape; got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    if x.dtype != dy.dtype:
        raise ValueError(f"x and dy must share a dtype; got {x.dtype} and "
                         f"{dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"x and dy must be on one device; got {x.device} "
                         f"and {dy.device}")


def conv3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel, on any device.

    Accumulates in float32 (float64 for float64 inputs, for gradcheck);
    returns ``(C, C, 3, 3)``.
    """
    _check(x, dy)
    acc = torch.promote_types(x.dtype, torch.float32)
    b, c, h, w = x.shape
    xpad = F.pad(x.to(acc), (1, 1, 1, 1))
    dyf = dy.to(acc).transpose(0, 1).reshape(c, b * h * w)
    dw = torch.empty((c, c, 3, 3), dtype=acc, device=x.device)
    for r in range(3):
        for s in range(3):
            tap = xpad[:, :, r:r + h, s:s + w].transpose(0, 1)
            dw[:, :, r, s] = dyf @ tap.reshape(c, b * h * w).T
    return dw


def split_k(c: int, k_total: int):
    """(pixels per slice, slices) for ``c`` channels over ``k_total`` =
    B*H*W pixels: enough slices to give about ``TARGET_BLOCKS`` blocks,
    each slice at least ``MIN_STEPS_PER_SLICE`` steps of ``K_STEP``."""
    tiles = -(-c // TILE) * -(-9 * c // TILE)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    most = max(1, k_total // (MIN_STEPS_PER_SLICE * K_STEP))
    slices = min(want, most)
    chunk = -(-k_total // slices)
    chunk = -(-chunk // K_STEP) * K_STEP
    return chunk, -(-k_total // chunk)


def _wgrad_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    global conv_wgrad_launches
    if x.dtype not in _CUDA_DTYPES:
        raise ValueError(f"conv wgrad kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv wgrad kernel takes contiguous NCHW x and dy")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"conv wgrad kernel: shape {tuple(x.shape)} "
                         f"exceeds 32-bit indexing")
    b, c, h, w = x.shape
    out = torch.empty((c, c, 3, 3), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    chunk, slices = split_k(c, b * h * w)
    ws = torch.empty((slices if slices > 1 else 0, c, 9 * c),
                     dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr(),
            b, c, h, w, int(x.dtype == torch.bfloat16), chunk, slices,
            stream)
    _build.check(lib, code, "conv wgrad kernel launch")
    conv_wgrad_launches += 1
    return out


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x, dy (B, C, H, W) -> dW (C, C, 3, 3) float32 of the 3x3 stride-1
    pad-1 conv ``y = conv2d(x, W)`` with ``dy = dL/dy``.

    CUDA tensors go to the kernel (float32 or bfloat16, contiguous, else
    raises); CPU tensors (float32, bfloat16 or float64) to the plain
    version.
    """
    _check(x, dy)
    if x.device.type == "cuda":
        return _wgrad_kernel(x, dy)
    if x.device.type == "cpu":
        if x.dtype not in _CPU_DTYPES:
            raise ValueError(f"conv wgrad takes {_CPU_DTYPES} on the CPU, "
                             f"got {x.dtype}")
        return conv3x3_wgrad_plain(x, dy)
    raise ValueError(f"conv wgrad: unsupported device {x.device}")
