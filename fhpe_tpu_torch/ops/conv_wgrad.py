"""Filter gradient of a 3x3, stride-1, same-pad convolution, NCHW.

Counterpart of the Pallas kernel ``scripts/probe/dw_pallas_probe.py``
(``dw_pallas``, P4), which computes ``dW[r, c] = sum_{b,h,w}
xpad[b, h+r, w+c, :]^T . dy[b, h, w, :]`` in float32 for NHWC inputs with
C_in = C_out = C.  Here x and dy are NCHW and dW comes out in torch's OIHW
weight layout, ``(C, C, 3, 3)`` float32.  Two forms:

* the plain PyTorch version, :func:`conv3x3_wgrad_plain` (nine tap
  products in float32, in the Pallas kernel's order);
* the CUDA kernel ``ops/csrc/conv_wgrad.cu``: for bfloat16 a split-K GEMM
  on the tensor cores whose K tiles are patches of one sample's pixels
  (:func:`bf16_plan`), for float32 a split-K implicit GEMM on the CUDA
  cores (:func:`split_k`); both with a fixed-order reduction of the
  slices, so two runs give the same bits.

:func:`conv3x3_wgrad` sends CUDA tensors to the kernel (it never falls
back) and CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

# Launches of the wgrad kernel in this process (one per call that reaches
# the kernel; a captured step takes back its capture's calls and adds them
# again at each replay, utils/graph.py); a run reads it to show the main
# path went through the kernel.
conv_wgrad_launches = 0

_CUDA_DTYPES = (torch.float32, torch.bfloat16)
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# Tile sizes of conv_wgrad.cu's float32 kernel, and the blocks split-K aims
# for: about three resident blocks on each of an H100's 132 SMs.
TILE, K_STEP = 64, 32
TARGET_BLOCKS = 396
MIN_STEPS_PER_SLICE = 4
# The bf16 kernel (wgrad_bf16 in conv_wgrad.cu, whose compile-time
# constants kCi, kStages, kFront and kOutPitch these four are; a test holds
# them to the source).  A block owns BF16_TILE_CI input channels with all
# nine taps (the wide side, 9 x 32 columns of dW) by tile_m output channels
# (32 for C <= 32, else 64), and a run of K tiles: ``rows`` image rows by
# ``cols`` columns of one sample, staged in shared memory with a one-pixel
# halo in a ring of BF16_STAGES buffers.  Split-K aims for at most two
# resident blocks on each of the 132 SMs (one wave).
BF16_TILE_CI = 32
BF16_STAGES = 3
BF16_FRONT = 8                # bf16 values before a run layout's x run
BF16_OUT_PITCH = 73           # floats per output row a warp stages (72 + 1)
BF16_MAX_COLS = 128           # widest column span of a K tile
BF16_MAX_KPAD = 160           # most pixels of a K tile (padded to 16)
BF16_SMEM_BUDGET = 113 * 1024  # bytes a block may take so two fit on an SM
BF16_SMEM_MAX = 227 * 1024    # an H100's most dynamic shared memory a block
BF16_TARGET_BLOCKS = 264


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


class Bf16Geometry(NamedTuple):
    """The shared-memory layout of one bf16 call, computed here only: the
    kernel takes it as given, as its ``Geometry`` struct, whose fields are
    these ints in this order.  A K tile is ``rows`` x ``cols`` pixels of
    one sample, ``cwp`` = cols rounded up to even, padded to ``kpad``
    pixels; per ring stage (``stage`` bf16 values) the dy tile (tile_m
    rows of pitch ``dy_pitch``) and BF16_TILE_CI x planes (pitch
    ``x_pitch``) of ``x_rows`` image rows of ``row_pitch``.  Run layout:
    each plane is the 16-byte-aligned run of ``x_run`` 16-byte chunks
    from the tile's top halo row, after BF16_FRONT values.  Halo layout:
    each row has ``lpad`` = 2 halo columns on either side.  ``bands`` x
    ``col_tiles`` K tiles cover a sample; ``smem`` is a block's bytes."""
    rows: int
    cols: int
    cwp: int
    kpad: int
    lpad: int
    row_pitch: int
    dy_rows: int
    dy_pitch: int
    x_rows: int
    x_pitch: int
    x_run: int
    stage: int
    bands: int
    col_tiles: int
    smem: int


class Bf16Plan(NamedTuple):
    """How the bf16 kernel cuts one call: dW into ``tile_m`` x
    ``BF16_TILE_CI``-channel tiles; the B*H*W pixels into ``k_tiles`` K
    tiles laid out as ``geometry``, ``tiles_per_slice`` consecutive K
    tiles to each of ``slices`` split-K slices.  ``runs``: the tile's rows
    load through ``cp.async`` as 16-byte copies of one contiguous run per
    channel (W even and at most ``BF16_MAX_COLS``, H*W and rows*W
    multiples of 8, 16-byte aligned pointers), else element by element
    into rows with halo columns, register-staged."""
    tile_m: int
    runs: bool
    geometry: Bf16Geometry
    k_tiles: int
    tiles_per_slice: int
    slices: int


def _round_words(elems: int) -> int:
    """A shared-memory row pitch of at least ``elems`` bf16 values whose
    32-bit word count is an odd multiple of 4: eight rows read together
    (ldmatrix, or one x plane per lane group) fall in eight different
    groups of four banks."""
    words = -(-elems // 2)
    return 2 * (-(-words // 8) * 8 + 4)


def bf16_geometry(tile_m: int, rows: int, cols: int, runs: bool, h: int,
                  w: int) -> Bf16Geometry:
    """The layout of K tiles of ``rows`` x ``cols`` pixels of an h x w
    image for ``tile_m`` output channels; pixel k of a tile is (k // cwp,
    k % cwp), so a pixel pair never straddles a row."""
    cwp = cols + (cols & 1)
    kpad = -(-rows * cwp // 16) * 16
    x_rows = (kpad - 1) // cwp + 3
    if runs:
        lpad, row_pitch, dy_rows = 0, cwp, 1
        dy_pitch = _round_words(kpad)
        # the run starts at the 16-byte boundary at most 3 pairs before
        # row y0 - 1
        x_run = -(-((rows + 2) * cwp + 6) // 8)
        x_pitch = _round_words(max(BF16_FRONT + x_rows * cwp + 8,
                                   BF16_FRONT + 8 * x_run))
    else:
        lpad, x_run = 2, 0
        row_pitch = cwp + 2 * lpad
        dy_rows = -(-kpad // cwp)
        dy_pitch = _round_words(dy_rows * cwp)
        x_pitch = _round_words(x_rows * row_pitch)
    stage = tile_m * dy_pitch + BF16_TILE_CI * x_pitch
    # the ring and the pair table, or each warp's 8 staged output rows
    warps = (tile_m // 32) * (BF16_TILE_CI // 8)
    smem = max(BF16_STAGES * stage * 2 + 4 * (kpad // 2),
               warps * 8 * BF16_OUT_PITCH * 4)
    return Bf16Geometry(rows, cols, cwp, kpad, lpad, row_pitch, dy_rows,
                        dy_pitch, x_rows, x_pitch, x_run, stage,
                        -(-h // rows), -(-w // cols), smem)


@functools.lru_cache(maxsize=None)
def bf16_plan(b: int, c: int, h: int, w: int, align: int = 16) -> Bf16Plan:
    """The bf16 kernel's cut of a (b, c, h, w) call whose x and dy start
    at addresses that are multiples of ``align`` bytes.  The K tile's rows
    minimise the work of the tiles (padded pixels, halo rows and a fixed
    cost per tile) within ``BF16_MAX_KPAD`` pixels and
    ``BF16_SMEM_BUDGET`` bytes, in the run layout where the shape allows
    one that fits, else with halo columns; where not even one row fits
    the budget, one row of halo columns (then one block per SM)."""
    tile_m = 32 if c <= 32 else 64
    cols = min(w, BF16_MAX_COLS)
    can_run = cols == w and w % 2 == 0 and (h * w) % 8 == 0 and align >= 16
    best = None
    for runs in ((True, False) if can_run else (False,)):
        for rows in range(1, h + 1):
            if runs and (rows * w) % 8:
                continue
            g = bf16_geometry(tile_m, rows, cols, runs, h, w)
            if g.kpad > BF16_MAX_KPAD or g.smem > BF16_SMEM_BUDGET:
                break
            cost = g.bands * (g.kpad + 2 * (cols + 4) + 64)
            if best is None or cost <= best[0]:
                best = (cost, runs, g)
        if best:
            break
    _, runs, g = best or (0, False,
                          bf16_geometry(tile_m, 1, cols, False, h, w))
    if g.smem > BF16_SMEM_MAX:
        raise ValueError(f"conv wgrad kernel: no bf16 tile of shape "
                         f"{(b, c, h, w)} fits {BF16_SMEM_MAX} bytes")
    k_tiles = b * g.bands * g.col_tiles
    tiles = -(-c // tile_m) * -(-c // BF16_TILE_CI)
    per = -(-k_tiles // min(max(1, BF16_TARGET_BLOCKS // tiles), k_tiles))
    return Bf16Plan(tile_m, runs, g, k_tiles, per, -(-k_tiles // per))

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
    if x.dtype == torch.bfloat16:
        # The plan depends on the addresses.  A captured step
        # (utils/graph.py) bakes this plan into its graph, which is sound
        # because the graph's memory pool gives x and dy the same
        # addresses on every replay.
        align = min(16, *(p & -p for p in (x.data_ptr(), dy.data_ptr())))
        plan = bf16_plan(b, c, h, w, align)
        chunk, slices = plan.tiles_per_slice, plan.slices
        tiling = (ctypes.c_int * (2 + len(plan.geometry)))(
            plan.tile_m, plan.runs, *plan.geometry)
    else:
        chunk, slices = split_k(c, b * h * w)
        tiling = None
    ws = torch.empty((slices if slices > 1 else 0, c, 9 * c),
                     dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), ws.data_ptr(),
            b, c, h, w, int(x.dtype == torch.bfloat16), chunk, slices,
            tiling, stream)
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
