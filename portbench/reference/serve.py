"""The reference serving path: normalisation, the flip test, and the
comparison of served keypoints with the reference's heatmaps.

As the reference code (Xiao et al. / Sun et al. ``validate``) serves a
person's crop with its centre and scale: /255 and the ImageNet mean and
std, the network on the crop and on its mirror, the mirror's heatmaps
flipped back with left and right joints swapped and shifted one column
right, the two averaged; then each joint's argmax, moved a quarter pixel
towards the larger neighbour, and mapped back to the frame.  The affine
maps are written in closed form (no rotation: a uniform scale and a
shift).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import final_heatmaps

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PIXEL_STD = 200.0


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def merged_heatmaps(model, images: torch.Tensor, flip_pairs,
                    shift: bool = True) -> torch.Tensor:
    """The flip test's heatmaps of (B, H, W, 3) uint8 crops, float32."""
    x = normalize(images)
    with torch.no_grad():
        hm = final_heatmaps(model, x)
        flipped = final_heatmaps(model, x.flip(3)).flip(3)
    perm = list(range(hm.shape[1]))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    flipped = flipped[:, perm]
    if shift:
        flipped = torch.cat([flipped[..., :1], flipped[..., :-1]], dim=3)
    return (hm + flipped) * 0.5


def to_heatmap(preds, centers, scales, heatmap_size):
    """Frame coordinates (N, J, 2) -> heatmap coordinates, float64."""
    preds = np.asarray(preds, np.float64)
    c = np.asarray(centers, np.float64)[:, None, :]
    k = heatmap_size[0] / (np.asarray(scales, np.float64)[:, 0]
                           * PIXEL_STD)[:, None, None]
    half = np.array(heatmap_size, np.float64) / 2
    return (preds - c) * k + half


def decode(heatmaps, centers, scales):
    """Keypoints of (N, J, h, w) heatmaps (numpy) in frame coordinates:
    (preds (N, J, 2), maxvals (N, J)); the argmax (the first of equal
    maxima) moved a quarter pixel towards the larger neighbour off the
    border, the origin where the maximum is not above 0."""
    hm = np.asarray(heatmaps, np.float64)
    n, j, h, w = hm.shape
    flat = hm.reshape(n, j, -1)
    idx = flat.argmax(-1)
    top = flat.max(-1)
    x, y = (idx % w).astype(np.float64), (idx // w).astype(np.float64)
    ni, ji = np.meshgrid(np.arange(n), np.arange(j), indexing="ij")
    ok = (x > 1) & (x < w - 1) & (y > 1) & (y < h - 1) & (top > 0)
    xi, yi = x.astype(np.int64), y.astype(np.int64)
    dx = (hm[ni, ji, yi, (xi + 1).clip(0, w - 1)]
          - hm[ni, ji, yi, (xi - 1).clip(0, w - 1)])
    dy = (hm[ni, ji, (yi + 1).clip(0, h - 1), xi]
          - hm[ni, ji, (yi - 1).clip(0, h - 1), xi])
    x = np.where(top > 0, x + ok * 0.25 * np.sign(dx), 0.0)
    y = np.where(top > 0, y + ok * 0.25 * np.sign(dy), 0.0)
    c = np.asarray(centers, np.float64)
    k = w / (np.asarray(scales, np.float64)[:, 0] * PIXEL_STD)
    preds = np.stack([(x - w / 2) / k[:, None] + c[:, :1],
                      (y - h / 2) / k[:, None] + c[:, 1:]], -1)
    return preds, top


def keypoint_gaps(heatmaps, preds, maxvals, centers, scales, tie: float):
    """How far served keypoints lie from the reference's heatmaps.

    heatmaps: (N, J, h, w) reference float32 (numpy); preds (N, J, 2) in
    frame coordinates and maxvals (N, J), the program's.  Each joint's
    program pixel is its heatmap coordinate rounded (the quarter offset is
    less than half a pixel).  With R the reference heatmap's range:

    * ``peak_gap``: how far the reference's value at that pixel lies below
      its maximum, / R (an argmax the reference would not take);
    * ``conf_gap``: the program's confidence against the reference's
      maximum, / R;
    * ``coord_gap``: heatmap pixels between the program's coordinate and
      that pixel moved by the reference's quarter offset; on an axis whose
      two neighbours differ by no more than ``tie`` R, either sign or none
      is taken.

    A confidence <= 0 means the program found no positive peak and
    returned the origin; its peak term is then the reference's maximum
    above 0, / R.  A coordinate off the heatmap reads a peak gap of 1 and
    a coordinate gap of the heatmap's longer side.  Returns the widest of
    each over the joints."""
    hm = np.asarray(heatmaps, np.float64)
    n, j, h, w = hm.shape
    xy = to_heatmap(preds, centers, scales, (w, h))
    conf = np.asarray(maxvals, np.float64)
    flat = hm.reshape(n, j, -1)
    top, low = flat.max(-1), flat.min(-1)
    rng = np.maximum(top - low, 1e-12)
    px = np.rint(xy[..., 0]).astype(np.int64)
    py = np.rint(xy[..., 1]).astype(np.int64)
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc, pyc = px.clip(0, w - 1), py.clip(0, h - 1)
    ni, ji = np.meshgrid(np.arange(n), np.arange(j), indexing="ij")
    at = hm[ni, ji, pyc, pxc]
    peak = np.where(conf > 0, (top - at) / rng, np.maximum(top, 0) / rng)
    peak = np.where(inside, peak, 1.0)
    coord = np.zeros((n, j))
    for axis, p in enumerate((pxc, pyc)):
        interior = (pxc > 1) & (pxc < w - 1) & (pyc > 1) & (pyc < h - 1)
        interior &= conf > 0
        if axis == 0:
            d = (hm[ni, ji, pyc, (pxc + 1).clip(0, w - 1)]
                 - hm[ni, ji, pyc, (pxc - 1).clip(0, w - 1)])
        else:
            d = (hm[ni, ji, (pyc + 1).clip(0, h - 1), pxc]
                 - hm[ni, ji, (pyc - 1).clip(0, h - 1), pxc])
        got = xy[..., axis] - p
        want = np.where(interior, 0.25 * np.sign(d), 0.0)
        miss = np.abs(got - want)
        tied = interior & (np.abs(d) <= tie * rng)
        either = np.min(np.abs(got[..., None] - np.array([-.25, 0, .25])), -1)
        coord = np.maximum(coord, np.where(tied, either, miss))
    coord = np.where(inside, coord, float(max(w, h)))
    return {"peak_gap": float(peak.max()),
            "conf_gap": float((np.abs(conf - top) / rng).max()),
            "coord_gap": float(coord.max())}
