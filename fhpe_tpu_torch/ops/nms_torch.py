"""On-device NMS: the pairwise OKS / IoU matrix, then greedy selection.

Counterpart of ``fhpe_tpu/ops/nms_jax.py``.  Three kernels of
``ops/csrc/nms.cu``, each with its plain PyTorch version beside it:

* :func:`pairwise_oks` — the (N, N) OKS matrix, the port of the Pallas
  kernel ``pairwise_oks_pallas`` (K2); :func:`pairwise_oks_plain` writes
  out K2's formula in K2's order;
* :func:`greedy_nms_mask` — score-ordered greedy suppression, the port of
  the ``lax.while_loop`` ``greedy_nms_mask``: one CTA runs a ranked
  bitmask scan (rank, thresholded bits, one warp walking the ranks);
  :func:`greedy_nms_mask_plain` is the greedy loop itself;
* :func:`oks_nms_segments` — the two fused for a whole evaluated set: the
  hard OKS-NMS of G images packed in CSR form in one launch, one CTA per
  image, the OKS bits in shared memory and no (N, N) matrix in device
  memory; :func:`oks_nms_segments_plain` loops the two plain versions over
  the images.

Each wrapper sends a CUDA tensor to its kernel (it never falls back) and
a CPU tensor to the plain version.  :func:`pairwise_iou_torch` is plain
PyTorch, as ``pairwise_iou_jnp`` is plain XLA.  :func:`oks_nms_device_batched`
(one keep-list per image of a set: one pack, one upload, one launch, one
download) and its one-image case :func:`oks_nms_device`, and
:func:`box_nms_device`, are drop-ins for ``ops/nms.py``'s ``oks_nms`` and
``nms``, keep-lists ordered by descending score (equal scores by ascending
index), as in ``fhpe_tpu``.  They run in float32 where the host versions
run in float64, so the two can differ only where a similarity lies within
float32 rounding of the threshold.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from . import _build
from .nms import COCO_SIGMAS

EPS = float(np.spacing(1))
MAX_JOINTS = 32          # ops/csrc/nms.cu kMaxJoints
MAX_OKS_N = 65535 * 16   # the grid's y extent in 16-row tiles
# The scan's suppression bits live in shared memory up to SCAN_SHMEM_MAX_N
# detections per image (nms.cu kShmemMaxN), above it in device scratch,
# up to MAX_SCAN_N (32 lanes x 32 bits x kScanSlots words per lane).
SCAN_SHMEM_MAX_N = 512
SCAN_SLOTS = 8
MAX_SCAN_N = 32 * 32 * SCAN_SLOTS

# Launches of each kernel in this process (one per call that reaches the
# kernel); a run reads them to show the main path went through the kernels.
pairwise_oks_launches = 0
greedy_nms_launches = 0
oks_nms_segment_launches = 0


def inv_two_vars(sigmas=None) -> np.ndarray:
    """(J,) float32 ``1 / (2 (2 sigma)^2)``, K2's per-joint weights."""
    sigmas = COCO_SIGMAS if sigmas is None else np.asarray(sigmas)
    return (1.0 / (2.0 * (sigmas * 2.0) ** 2)).astype(np.float32)


# -- pairwise OKS (K2) ----------------------------------------------------

def pairwise_oks_plain(xs: torch.Tensor, ys: torch.Tensor,
                       areas: torch.Tensor, sigmas=None) -> torch.Tensor:
    """The plain version of the OKS kernel, on any device.

    xs, ys: (N, J) float32; areas: (N,).  ``oks[i, j]`` is the similarity
    of detection j to detection i, in K2's order of operations.
    """
    iv = inv_two_vars(sigmas)
    inv_denom = 1.0 / ((areas[:, None] + areas[None, :]) / 2.0 + EPS)
    acc = torch.zeros_like(inv_denom)
    for k in range(xs.shape[1]):
        dx = xs[None, :, k] - xs[:, None, k]
        dy = ys[None, :, k] - ys[:, None, k]
        e = (dx * dx + dy * dy) * float(iv[k]) * inv_denom
        acc = acc + torch.exp(-e)
    return acc / xs.shape[1]


def _check_oks_inputs(xs, ys, areas):
    if xs.dim() != 2 or ys.shape != xs.shape or areas.shape != xs.shape[:1]:
        raise ValueError(f"pairwise_oks takes xs, ys (N, J) and areas (N,); "
                         f"got {tuple(xs.shape)}, {tuple(ys.shape)}, "
                         f"{tuple(areas.shape)}")
    for name, t in (("xs", xs), ("ys", ys), ("areas", areas)):
        if t.device != xs.device:
            raise ValueError(f"pairwise_oks: {name} on {t.device}, xs on "
                             f"{xs.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"pairwise_oks takes float32; {name} is "
                             f"{t.dtype}")


def _pairwise_oks_kernel(xs, ys, areas, sigmas) -> torch.Tensor:
    global pairwise_oks_launches
    n, j = xs.shape
    if not 1 <= j <= MAX_JOINTS or n > MAX_OKS_N:
        raise ValueError(f"OKS kernel takes 1..{MAX_JOINTS} joints and N <= "
                         f"{MAX_OKS_N}; got N={n}, J={j}")
    xs, ys, areas = xs.contiguous(), ys.contiguous(), areas.contiguous()
    out = torch.empty((n, n), dtype=torch.float32, device=xs.device)
    if n == 0:
        return out
    iv = inv_two_vars(sigmas)
    if len(iv) != j:
        raise ValueError(f"{len(iv)} sigmas for {j} joints")
    lib = _build.load_library()
    iv_host = (ctypes.c_float * j)(*iv.tolist())
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_pairwise_oks(xs.data_ptr(), ys.data_ptr(),
                                     areas.data_ptr(), out.data_ptr(), n, j,
                                     iv_host, EPS, stream)
    _build.check(lib, code, "pairwise OKS kernel launch")
    pairwise_oks_launches += 1
    return out


def pairwise_oks(xs: torch.Tensor, ys: torch.Tensor, areas: torch.Tensor,
                 sigmas=None) -> torch.Tensor:
    """(N, N) float32 OKS matrix.  A CUDA tensor goes to the kernel (else
    raises); a CPU tensor goes to the plain version."""
    _check_oks_inputs(xs, ys, areas)
    if xs.device.type == "cuda":
        return _pairwise_oks_kernel(xs, ys, areas, sigmas)
    if xs.device.type == "cpu":
        return pairwise_oks_plain(xs, ys, areas, sigmas)
    raise ValueError(f"pairwise_oks: unsupported device {xs.device}")


def pairwise_iou_torch(boxes: torch.Tensor) -> torch.Tensor:
    """Box IoU matrix with the reference's +1 pixel-area convention."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (torch.clamp(xx2 - xx1 + 1, min=0.0)
             * torch.clamp(yy2 - yy1 + 1, min=0.0))
    return inter / (areas[:, None] + areas[None, :] - inter)


# -- greedy selection -------------------------------------------------------

def greedy_nms_mask_plain(sim: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """The plain version of the greedy kernel: (N,) bool keep mask.

    Keeps the alive detection with the highest score (the larger index
    among equal scores; NaN counts as -inf), drops every alive one whose
    ``sim`` to it is > ``thresh``, and repeats while any is alive.
    """
    n = scores.shape[0]
    thresh = float(np.float32(thresh))   # the kernel compares in float32
    key = torch.where(torch.isnan(scores), float("-inf"), scores)
    index = torch.arange(n, device=scores.device)
    alive = valid.clone()
    keep = torch.zeros(n, dtype=torch.bool, device=scores.device)
    for _ in range(n):
        if not bool(alive.any()):
            break
        top = key[alive].max()
        i = int(torch.where(alive & (key == top), index, -1).max())
        keep[i] = True
        alive &= ~(sim[i] > thresh)
        alive[i] = False
    return keep


def _check_scan_size(what: str, n: int) -> None:
    if n > MAX_SCAN_N:
        raise ValueError(f"{what} takes at most {MAX_SCAN_N} detections per "
                         f"image; got {n}")


def _scratch(sizes, device) -> Optional[torch.Tensor]:
    """Device scratch for the bits of the images above the shared-memory
    cap: ``n * ceil(n / 32)`` uint32 words each (as int32), or None."""
    big = [int(n) for n in sizes if n > SCAN_SHMEM_MAX_N]
    words = sum(n * -(-n // 32) for n in big)
    if not words:
        return None
    return torch.empty(words, dtype=torch.int32, device=device)


def _check_greedy_inputs(sim, scores, valid):
    n = scores.shape[0] if scores.dim() == 1 else -1
    if n < 0 or sim.shape != (n, n) or valid.shape != (n,):
        raise ValueError(f"greedy_nms_mask takes sim (N, N), scores (N,) and "
                         f"valid (N,); got {tuple(sim.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(valid.shape)}")
    if sim.dtype != torch.float32 or scores.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise ValueError(f"greedy_nms_mask takes float32 sim and scores and "
                         f"bool valid; got {sim.dtype}, {scores.dtype}, "
                         f"{valid.dtype}")
    if not sim.device == scores.device == valid.device:
        raise ValueError("greedy_nms_mask: inputs on different devices")
    _check_scan_size("greedy_nms_mask", n)


def _greedy_kernel(sim, scores, valid, thresh) -> torch.Tensor:
    global greedy_nms_launches
    n = scores.shape[0]
    keep = torch.empty(n, dtype=torch.bool, device=scores.device)
    if n == 0:
        return keep
    sim, scores, valid = sim.contiguous(), scores.contiguous(), \
        valid.contiguous()
    scratch = _scratch([n], scores.device)
    lib = _build.load_library()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_greedy_nms_mask(
            sim.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), n, float(thresh),
            None if scratch is None else scratch.data_ptr(), stream)
    _build.check(lib, code, "greedy NMS kernel launch")
    greedy_nms_launches += 1
    return keep


def greedy_nms_mask(sim: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """(N,) bool keep mask, N <= ``MAX_SCAN_N``.  A CUDA tensor goes to
    the kernel (else raises); a CPU tensor goes to the plain version."""
    _check_greedy_inputs(sim, scores, valid)
    if scores.device.type == "cuda":
        return _greedy_kernel(sim, scores, valid, thresh)
    if scores.device.type == "cpu":
        return greedy_nms_mask_plain(sim, scores, valid, thresh)
    raise ValueError(f"greedy_nms_mask: unsupported device {scores.device}")


# -- the segmented OKS-NMS (K2 and the greedy selection in one launch) ------

def oks_nms_segments_plain(xs: torch.Tensor, ys: torch.Tensor,
                           areas: torch.Tensor, scores: torch.Tensor,
                           offsets, thresh: float,
                           sigmas=None) -> torch.Tensor:
    """The plain version of the segmented kernel: (T,) bool keep mask,
    image by image :func:`pairwise_oks_plain` then
    :func:`greedy_nms_mask_plain` (every detection valid)."""
    keep = torch.zeros(scores.shape[0], dtype=torch.bool,
                       device=scores.device)
    bounds = [int(v) for v in offsets]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            sim = pairwise_oks_plain(xs[lo:hi], ys[lo:hi], areas[lo:hi],
                                     sigmas)
            keep[lo:hi] = greedy_nms_mask_plain(
                sim, scores[lo:hi],
                torch.ones(hi - lo, dtype=torch.bool, device=scores.device),
                thresh)
    return keep


def _check_segment_inputs(xs, ys, areas, scores, offsets, host):
    _check_oks_inputs(xs, ys, areas)
    t = xs.shape[0]
    if scores.shape != (t,) or scores.dtype != torch.float32 \
            or scores.device != xs.device:
        raise ValueError(f"oks_nms_segments takes float32 scores ({t},) on "
                         f"{xs.device}; got {tuple(scores.shape)} "
                         f"{scores.dtype} on {scores.device}")
    if offsets.dim() != 1 or offsets.dtype != torch.int32 \
            or offsets.device != xs.device:
        raise ValueError(f"oks_nms_segments takes int32 offsets (G + 1,) on "
                         f"{xs.device}; got {tuple(offsets.shape)} "
                         f"{offsets.dtype} on {offsets.device}")
    if len(host) != offsets.shape[0] or len(host) < 1 or host[0] != 0 \
            or host[-1] != t or (np.diff(host) < 0).any():
        raise ValueError(f"oks_nms_segments: offsets must rise from 0 to "
                         f"{t}; got {host.tolist()}")
    if len(host) > 1:
        _check_scan_size("oks_nms_segments", int(np.diff(host).max()))


def _segments_kernel(xs, ys, areas, scores, offsets, host, thresh,
                     sigmas) -> torch.Tensor:
    global oks_nms_segment_launches
    t, j = xs.shape
    keep = torch.zeros(t, dtype=torch.bool, device=xs.device)
    if t == 0:
        return keep
    iv = inv_two_vars(sigmas)
    if len(iv) != j:
        raise ValueError(f"{len(iv)} sigmas for {j} joints")
    sizes = np.diff(host)
    staged = sizes[sizes <= SCAN_SHMEM_MAX_N]
    big = sizes[sizes > SCAN_SHMEM_MAX_N]
    scratch = _scratch(big, xs.device)
    xs, ys, areas, scores, offsets = (a.contiguous() for a in
                                      (xs, ys, areas, scores, offsets))
    lib = _build.load_library()
    iv_host = (ctypes.c_float * j)(*iv.tolist())
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_oks_nms_segments(
            xs.data_ptr(), ys.data_ptr(), areas.data_ptr(), scores.data_ptr(),
            offsets.data_ptr(), keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), len(sizes), j,
            iv_host, EPS, float(thresh), int(staged.max(initial=0)),
            int(big.max(initial=0)), stream)
    _build.check(lib, code, "segmented OKS-NMS kernel launch")
    oks_nms_segment_launches += 1
    return keep


def oks_nms_segments(xs: torch.Tensor, ys: torch.Tensor, areas: torch.Tensor,
                     scores: torch.Tensor, offsets: torch.Tensor,
                     thresh: float, sigmas=None,
                     host_offsets=None) -> torch.Tensor:
    """(T,) bool keep mask of the hard OKS-NMS of every image of a CSR pack.

    xs, ys: (T, J) float32; areas, scores: (T,) float32; offsets: (G + 1,)
    int32 on the same device, image g being rows ``offsets[g]`` to
    ``offsets[g + 1]``, at most ``MAX_SCAN_N`` each.  ``host_offsets`` (a
    numpy copy of ``offsets``) spares the kernel's launch plan a download.
    A CUDA tensor goes to the kernel (else raises); a CPU tensor goes to the
    plain version.
    """
    host = np.asarray(offsets.cpu() if host_offsets is None
                      else host_offsets, np.int64)
    _check_segment_inputs(xs, ys, areas, scores, offsets, host)
    if xs.device.type == "cuda":
        return _segments_kernel(xs, ys, areas, scores, offsets, host, thresh,
                                sigmas)
    if xs.device.type == "cpu":
        return oks_nms_segments_plain(xs, ys, areas, scores, host, thresh,
                                      sigmas)
    raise ValueError(f"oks_nms_segments: unsupported device {xs.device}")


# -- drop-ins for ops/nms.py --------------------------------------------------

Device = Union[str, torch.device]


def _padded(n: int, pad_to: int) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


def pack_groups(groups, joints: int):
    """One int32 buffer for the upload: xs (T, J), ys (T, J), areas (T,)
    and scores (T,) as float32 bits, then the int32 offsets (G + 1,).
    Returns (buffer, offsets as int64 numpy, T).  One ``np.concatenate``
    of all keypoints, so every detection's keypoints have one shape: all
    (J, 3) or all (3 J,), never a mix (``fhpe_tpu``'s per-detection pack
    took a mix); each value rounds to float32 once, as the per-image
    packing did."""
    sizes = np.fromiter(map(len, groups), np.int64, len(groups))
    offsets = np.zeros(len(groups) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    t = int(offsets[-1])
    buf = np.empty(2 * t * joints + 2 * t + len(offsets), np.int32)
    f = buf[:2 * t * joints + 2 * t].view(np.float32)
    if t:
        dets = [k for g in groups for k in g]
        try:
            kp = np.concatenate([k["keypoints"] for k in dets]
                                ).reshape(t, -1)[:, :3 * joints]
        except ValueError as e:
            raise ValueError("oks_nms_device_batched: every detection's "
                             "keypoints must have one shape, all (J, 3) or "
                             "all (3 J,)") from e
        f[:t * joints] = kp[:, 0::3].ravel()
        f[t * joints:2 * t * joints] = kp[:, 1::3].ravel()
        f[2 * t * joints:2 * t * joints + t] = [k["area"] for k in dets]
        f[2 * t * joints + t:] = [k["score"] for k in dets]
    buf[2 * t * joints + 2 * t:] = offsets
    return buf, offsets, t


def packed_views(buf: torch.Tensor, t: int, joints: int):
    """(xs, ys, areas, scores, offsets) views of :func:`pack_groups`'s
    buffer (on any device)."""
    n = t * joints
    f = buf[:2 * n + 2 * t].view(torch.float32)
    return (f[:n].view(t, joints), f[n:2 * n].view(t, joints),
            f[2 * n:2 * n + t], f[2 * n + t:], buf[2 * n + 2 * t:])


def keep_lists(keep: np.ndarray, scores: np.ndarray,
               offsets: np.ndarray) -> list:
    """(T,) keep mask -> one list per image of its kept indices, by
    descending score, equal scores in ascending index (as ``fhpe_tpu``'s
    drop-ins order them)."""
    kept = np.flatnonzero(keep)
    image = np.searchsorted(offsets, kept, side="right") - 1
    order = np.lexsort((-scores[kept], image))     # stable
    kept, image = kept[order], image[order]
    cuts = np.searchsorted(image, np.arange(1, len(offsets) - 1))
    return [a.tolist() for a in np.split(kept - offsets[image], cuts)]


def oks_nms_device_batched(groups, thresh, sigmas=None,
                           device: Device = "cuda") -> list:
    """Drop-in ``oks_nms`` for a whole evaluated set: ``groups`` is a list
    of per-image ``kpts_db`` lists ({"score", "keypoints" (J, 3), "area"});
    returns one keep-list per image, ordered by descending score.  One
    pack, one upload, one launch of the segmented kernel, one keep-mask
    download.  Narrower than ``fhpe_tpu``'s per-image drop-in: every
    detection's keypoints have one shape (:func:`pack_groups`), there is
    no ``pad_to`` (nothing is padded), and an image holds at most
    ``MAX_SCAN_N`` detections (else ValueError)."""
    j = len(COCO_SIGMAS if sigmas is None else sigmas)
    buf, offsets, t = pack_groups(groups, j)
    if t == 0:
        return [[] for _ in groups]
    xs, ys, areas, scores, d_offsets = packed_views(
        torch.from_numpy(buf).to(device), t, j)
    keep = oks_nms_segments(xs, ys, areas, scores, d_offsets, float(thresh),
                            sigmas, host_offsets=offsets)
    host_scores = buf[2 * t * j + t:2 * t * j + 2 * t].view(np.float32)
    return keep_lists(keep.cpu().numpy(), host_scores, offsets)


def oks_nms_device(kpts_db, thresh, sigmas=None, device: Device = "cuda"):
    """Drop-in ``oks_nms`` for one image: the one-image case of
    :func:`oks_nms_device_batched`."""
    return oks_nms_device_batched([kpts_db], thresh, sigmas, device)[0]


def box_nms_device(dets, thresh, pad_to: int = 128,
                   device: Device = "cuda"):
    """Drop-in box ``nms`` with the IoU matrix (plain PyTorch) and the
    greedy kernel on ``device``; dets (N, 5) = [x1, y1, x2, y2, score]."""
    n = len(dets)
    if n == 0:
        return []
    total = _padded(n, pad_to)
    buf = np.zeros((total, 5), np.float32)
    buf[:, 4] = -np.inf
    buf[:n] = np.asarray(dets)[:, :5]
    dev = torch.from_numpy(buf).to(device)
    valid = torch.arange(total, device=dev.device) < n
    sim = pairwise_iou_torch(dev[:, :4])
    keep = greedy_nms_mask(sim, dev[:, 4].contiguous(), valid, float(thresh))
    return keep_lists(keep[:n].cpu().numpy(), buf[:n, 4], np.array([0, n]))[0]
