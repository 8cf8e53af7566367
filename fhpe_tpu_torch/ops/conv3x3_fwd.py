"""A 3x3, stride-1, same-pad convolution without bias, C -> C, NCHW.

Counterpart of the Pallas conv probes P1-P3, which all compute ``y =
conv3x3_same(x, W)`` with float32 sums for NHWC x and HWIO W (C_in =
C_out = C) and differ only in their layout for the TPU's matrix unit and
in the output dtype: float32 for P1 (``scripts/probe/pallas_conv_probe.py``
``conv_a``, ``conv_b``), bfloat16 for P2 (``scripts/probe/pc_test.py``
``conv_c``) and P3 (``scripts/probe/pallas_conv_probe2.py`` ``conv_c``,
``conv_a2``, ``conv_b2``).  Here x is NCHW and W torch's OIHW, as the
port's other conv kernels take them.  Two forms:

* the plain PyTorch version, :func:`conv3x3_fwd_plain` (nine shifted-tap
  products accumulated in float32, as P2's ``conv_c`` does, rounded once);
* the CUDA kernel ``ops/csrc/conv3x3_fwd.cu``: for bfloat16 inputs an
  implicit GEMM on the tensor cores (``mma.sync``) whose tiles are patches
  of pixels staged once per chunk of input channels for all nine taps
  (:func:`bf16_plan`), for float32 inputs an implicit GEMM on the CUDA
  cores; two runs give the same bits.

:func:`conv3x3_fwd` sends CUDA tensors to the kernel (it never falls back)
and CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernel in this process, by output dtype (one per call
# that reaches the kernel; a captured step takes back its capture's calls
# and adds them again at each replay, utils/graph.py): bf16 out (P2, P3)
# and float32 out (P1).  A run reads them to show the main path went
# through the kernel.
conv3x3_fwd_launches = 0
conv3x3_fwd_f32_launches = 0

_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# The bf16 kernel (conv3x3_fwd_bf16 in conv3x3_fwd.cu, whose compile-time
# constants kTileM, kSlots, kChunk, kPitch and kMaxPatch these are; a test
# holds them to the source).  A block owns BF16_TILE_M output channels by
# at most BF16_SLOTS output pixels; each chunk of BF16_CHUNK input channels
# of the tile's patch (the pixels with their one-pixel halo, at most
# BF16_MAX_PATCH) is staged pixel-major at BF16_PITCH values per pixel,
# beside the chunk's weights as 9 x BF16_TILE_M rows of BF16_PITCH.
BF16_TILE_M = 64
BF16_SLOTS = 128
BF16_CHUNK = 32
BF16_PITCH = 40
BF16_MAX_PATCH = 256
BF16_WEIGHT_BYTES = 9 * BF16_TILE_M * BF16_PITCH * 2
# The plan's cost of a tile beside its BF16_SLOTS pixel slots of MMAs: the
# weights' staging, and per patch pixel the x staging (a chunk of weights
# is 18,432 values, of x 32 per patch pixel).
TILE_COST = 48
PATCH_COST = 0.25


class Bf16Plan(NamedTuple):
    """How the bf16 kernel tiles one call, computed here only: the kernel
    takes it as its ``Plan`` struct, whose fields are these ints in this
    order.  A tile is ``rows`` x ``cols`` output pixels of ``samples``
    consecutive samples (more than one only when a tile is a whole image);
    its patch is ``samples`` blocks of ``rows + 2`` rows of ``patch_w`` =
    ``cols + 2`` pixels, ``patch`` in all; ``bands`` x ``col_tiles`` tiles
    cover a sample, ``tiles`` the batch (the grid's x); ``smem`` is a
    block's dynamic shared memory in bytes."""
    samples: int
    rows: int
    cols: int
    patch_w: int
    patch: int
    bands: int
    col_tiles: int
    tiles: int
    smem: int


def plan_smem(patch: int) -> int:
    """A block's bytes: the chunk's weights, its x patch and the patch's
    pixel table (one int per pixel)."""
    return BF16_WEIGHT_BYTES + patch * (2 * BF16_PITCH + 4)


@functools.lru_cache(maxsize=None)
def bf16_plan(b: int, h: int, w: int) -> Bf16Plan:
    """The bf16 kernel's tiles of a call on (b, C, h, w), for any C: of
    every tile shape within ``BF16_SLOTS`` pixels and ``BF16_MAX_PATCH``
    patch pixels, the one whose tiles cost least (``TILE_COST`` + the slots +
    ``PATCH_COST`` per patch pixel, per tile); of equal costs the last in
    order of columns, rows and samples, so the widest (longer runs of
    pixels to load and store)."""
    best = None
    for cols in range(1, min(w, BF16_SLOTS) + 1):
        for rows in range(1, min(h, BF16_SLOTS // cols) + 1):
            whole = rows == h and cols == w
            most = min(b, BF16_SLOTS // (rows * cols)) if whole else 1
            for samples in range(1, most + 1):
                patch = samples * (rows + 2) * (cols + 2)
                if patch > BF16_MAX_PATCH:
                    break
                tiles = -(-b // samples) * -(-h // rows) * -(-w // cols)
                cost = tiles * (TILE_COST + BF16_SLOTS + PATCH_COST * patch)
                if best is None or cost <= best[0]:
                    best = (cost, samples, rows, cols)
    _, samples, rows, cols = best
    patch = samples * (rows + 2) * (cols + 2)
    bands, col_tiles = -(-h // rows), -(-w // cols)
    return Bf16Plan(samples, rows, cols, cols + 2, patch, bands, col_tiles,
                    -(-b // samples) * bands * col_tiles, plan_smem(patch))


def _check(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding,
           out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """Raise on what the kernel does not compute; return the output
    dtype."""
    if bias is not None:
        raise ValueError("conv3x3_fwd has no bias")
    if stride not in (1, (1, 1)) or padding not in (1, (1, 1)):
        raise ValueError(f"conv3x3_fwd is stride 1, pad 1; got stride "
                         f"{stride}, padding {padding}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W); got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, c, 3, 3):
        raise ValueError(f"weight must be (C, C, 3, 3) = ({c}, {c}, 3, 3) "
                         f"for x {tuple(x.shape)}; got "
                         f"{tuple(weight.shape)}")
    if x.dtype != weight.dtype:
        raise ValueError(f"x and weight must share a dtype; got {x.dtype} "
                         f"and {weight.dtype}")
    if x.device != weight.device:
        raise ValueError(f"x and weight must be on one device; got "
                         f"{x.device} and {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("conv3x3_fwd takes contiguous NCHW x and OIHW "
                         "weight")
    if out_dtype not in (None, x.dtype, torch.float32):
        raise ValueError(f"conv3x3_fwd writes x's dtype ({x.dtype}) or "
                         f"float32; got out_dtype {out_dtype}")
    return out_dtype or x.dtype


def conv3x3_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The plain version of the kernel, on any device: the nine shifted
    taps' products with ``weight[:, :, r, s]`` accumulated in float32
    (float64 for float64 inputs), rounded once to ``out_dtype`` (default
    x's dtype), autocast or not."""
    out_dtype = _check(x, weight, None, 1, 1, out_dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    b, c, h, w = x.shape
    xpad = F.pad(x.to(acc), (1, 1, 1, 1))
    wf = weight.to(acc)
    y = torch.zeros((b, c, h * w), dtype=acc, device=x.device)
    # autocast would run the products in bf16
    with torch.autocast(x.device.type, enabled=False):
        for r in range(3):
            for s in range(3):
                tap = xpad[:, :, r:r + h, s:s + w].reshape(b, c, h * w)
                y += torch.matmul(wf[:, :, r, s], tap)
    return y.view(b, c, h, w).to(out_dtype)


def _fwd_kernel(x: torch.Tensor, weight: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    global conv3x3_fwd_launches, conv3x3_fwd_f32_launches
    if x.dtype not in _CUDA_DTYPES:
        raise ValueError(f"conv3x3_fwd kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if max(x.numel(), weight.numel()) >= 2 ** 31:
        raise ValueError(f"conv3x3_fwd kernel: shape {tuple(x.shape)} "
                         f"exceeds 32-bit indexing")
    b, c, h, w = x.shape
    y = torch.empty((b, c, h, w), dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    plan = None
    if x.dtype == torch.bfloat16:
        plan = (ctypes.c_int * len(Bf16Plan._fields))(*bf16_plan(b, h, w))
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_conv3x3_fwd(
            x.data_ptr(), weight.data_ptr(), y.data_ptr(), b, c, h, w,
            int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), plan, stream)
    _build.check(lib, code, "conv3x3_fwd kernel launch")
    if out_dtype == torch.bfloat16:
        conv3x3_fwd_launches += 1
    else:
        conv3x3_fwd_f32_launches += 1
    return y


def conv3x3_fwd(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride=1, padding=1,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (B, C, H, W), weight (C, C, 3, 3) -> y (B, C, H, W) of the 3x3
    stride-1 pad-1 conv without bias, in x's dtype or ``out_dtype``
    float32.

    Raises on a bias, a stride or padding other than 1, C_in != C_out, or
    non-contiguous tensors.  CUDA tensors go to the kernel (float32 or
    bfloat16, else raises); CPU tensors (float32, bfloat16 or float64) to
    the plain version.
    """
    out_dtype = _check(x, weight, bias, stride, padding, out_dtype)
    if x.device.type == "cuda":
        return _fwd_kernel(x, weight, out_dtype)
    if x.device.type == "cpu":
        if x.dtype not in _CPU_DTYPES:
            raise ValueError(f"conv3x3_fwd takes {_CPU_DTYPES} on the CPU, "
                             f"got {x.dtype}")
        return conv3x3_fwd_plain(x, weight, out_dtype)
    raise ValueError(f"conv3x3_fwd: unsupported device {x.device}")
