"""On-device NMS: the pairwise OKS / IoU matrix, then greedy selection.

Counterpart of ``fhpe_tpu/ops/nms_jax.py``.  Two kernels, each with its
plain PyTorch version beside it:

* :func:`pairwise_oks` — the (N, N) OKS matrix, the port of the Pallas
  kernel ``pairwise_oks_pallas`` (K2) as ``ops/csrc/nms.cu``;
  :func:`pairwise_oks_plain` writes out K2's formula in K2's order;
* :func:`greedy_nms_mask` — score-ordered greedy suppression, the port of
  the ``lax.while_loop`` ``greedy_nms_mask`` as one CTA of
  ``ops/csrc/nms.cu`` (a loop on the host would wait once per kept
  detection); :func:`greedy_nms_mask_plain` is a loop of at most N steps.

Each wrapper sends a CUDA tensor to its kernel (it never falls back) and
a CPU tensor to the plain version.  :func:`pairwise_iou_torch` is plain
PyTorch, as ``pairwise_iou_jnp`` is plain XLA.  :func:`oks_nms_device` and
:func:`box_nms_device` are drop-ins for ``ops/nms.py``'s ``oks_nms`` and
``nms``: detections padded to a multiple of 128 with ``-inf`` scores and a
``valid`` mask, keep-lists ordered by descending score, as in
``fhpe_tpu``.  They run in float32 where the host versions run in
float64, so the two can differ only where a similarity lies within
float32 rounding of the threshold.
"""

from __future__ import annotations

import ctypes
from typing import Union

import numpy as np
import torch

from . import _build
from .nms import COCO_SIGMAS

EPS = float(np.spacing(1))
MAX_JOINTS = 32          # ops/csrc/nms.cu kMaxJoints
MAX_OKS_N = 65535 * 16   # the grid's y extent in 16-row tiles

# Launches of each kernel in this process (one per call that reaches the
# kernel); a run reads them to show the main path went through the kernels.
pairwise_oks_launches = 0
greedy_nms_launches = 0


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


def _greedy_kernel(sim, scores, valid, thresh) -> torch.Tensor:
    global greedy_nms_launches
    n = scores.shape[0]
    keep = torch.empty(n, dtype=torch.bool, device=scores.device)
    if n == 0:
        return keep
    sim, scores, valid = sim.contiguous(), scores.contiguous(), \
        valid.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fhpe_greedy_nms_mask(sim.data_ptr(), scores.data_ptr(),
                                        valid.data_ptr(), keep.data_ptr(), n,
                                        float(thresh), stream)
    _build.check(lib, code, "greedy NMS kernel launch")
    greedy_nms_launches += 1
    return keep


def greedy_nms_mask(sim: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """(N,) bool keep mask.  A CUDA tensor goes to the kernel (else
    raises); a CPU tensor goes to the plain version."""
    _check_greedy_inputs(sim, scores, valid)
    if scores.device.type == "cuda":
        return _greedy_kernel(sim, scores, valid, thresh)
    if scores.device.type == "cpu":
        return greedy_nms_mask_plain(sim, scores, valid, thresh)
    raise ValueError(f"greedy_nms_mask: unsupported device {scores.device}")


# -- drop-ins for ops/nms.py --------------------------------------------------

Device = Union[str, torch.device]


def _padded(n: int, pad_to: int) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


def _keep_list(keep: torch.Tensor, scores: np.ndarray, n: int) -> list:
    """Keep mask (one device-to-host copy) -> indices by descending score."""
    kept = np.nonzero(keep[:n].cpu().numpy())[0]
    return kept[np.argsort(-scores[kept], kind="stable")].tolist()


def oks_nms_device(kpts_db, thresh, sigmas=None, pad_to: int = 128,
                   device: Device = "cuda"):
    """Drop-in ``oks_nms`` with the OKS matrix and the greedy pass on
    ``device``; returns the keep list ordered by descending score.

    kpts_db: list of {"score", "keypoints" (J, 3), "area"}.  One upload of
    the padded detections, one download of the keep mask.
    """
    n = len(kpts_db)
    if n == 0:
        return []
    j = len(COCO_SIGMAS if sigmas is None else sigmas)
    total = _padded(n, pad_to)
    # one float32 buffer: xs (total, j), ys (total, j), areas, scores
    buf = np.zeros(2 * total * j + 2 * total, np.float32)
    xs = buf[:total * j].reshape(total, j)
    ys = buf[total * j:2 * total * j].reshape(total, j)
    areas = buf[2 * total * j:2 * total * j + total]
    scores = buf[2 * total * j + total:]
    areas[:] = 1.0
    scores[:] = -np.inf
    for i, k in enumerate(kpts_db):
        kp = np.asarray(k["keypoints"], dtype=np.float64).reshape(-1)[:3 * j]
        xs[i] = kp[0::3]
        ys[i] = kp[1::3]
        areas[i] = k["area"]
        scores[i] = k["score"]

    dev = torch.from_numpy(buf).to(device)
    d_xs = dev[:total * j].view(total, j)
    d_ys = dev[total * j:2 * total * j].view(total, j)
    d_areas = dev[2 * total * j:2 * total * j + total]
    d_scores = dev[2 * total * j + total:]
    valid = torch.arange(total, device=dev.device) < n
    sim = pairwise_oks(d_xs, d_ys, d_areas, sigmas)
    keep = greedy_nms_mask(sim, d_scores, valid, float(thresh))
    return _keep_list(keep, scores, n)


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
    return _keep_list(keep, buf[:, 4], n)
