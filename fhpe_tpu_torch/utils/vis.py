"""Debug image dumps: annotated joints and heatmap grids, without cv2.

Counterpart of ``fhpe_tpu/utils/vis.py`` (the reference's
``lib/utils/vis.py``), pixel for pixel: a grid of batch samples with
their joints drawn, and per sample a row of the resized image and one
JET-coloured heatmap per joint with its peak marked; gated by the
``DEBUG.*`` flags (vis.py:119-141).  Where ``fhpe_tpu`` calls cv2, this
module uses the port's own pieces, each held to cv2 by
``tests/test_torch_vis.py``:

* the two dots are fixed masks at integer centres
  (``native_image.stamp``): :data:`JOINT_DOT` is ``cv2.circle(img, c, 2,
  color, 2)`` (with cv2's clipping at the top-left edge,
  :func:`_joint_dot`), :data:`PEAK_RING` ``cv2.circle(img, c, 1, color,
  1)``;
* :data:`JET_BGR` is ``cv2.applyColorMap(..., COLORMAP_JET)`` as a
  256-entry lookup table;
* ``native_image.resize`` is ``cv2.resize`` (INTER_LINEAR) and
  ``native_image.imwrite`` is ``cv2.imwrite`` of a ``.jpg`` (quality 95).

The arithmetic is ``fhpe_tpu``'s: heatmaps to uint8 by ``np.clip(h *
255, 0, 255)``, ``colored * 0.7 + img * 0.3`` in float64 with the peak
drawn on that float array, then a truncating cast into the uint8 grid.
Heatmaps come NCHW, as the port's steps return them (``fhpe_tpu`` takes
NHWC); images as the host batch holds them, (B, H, W, 3) uint8, or
normalized float NHWC.  Grids are BGR HWC uint8.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import native_image
from ..ops.decode import get_max_preds
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

_MEAN = np.array(IMAGENET_MEAN, dtype=np.float32)
_STD = np.array(IMAGENET_STD, dtype=np.float32)


def _mask(rows) -> np.ndarray:
    return np.array([[ch == "#" for ch in row] for row in rows])


# cv2.circle(img, c, 2, color, 2) (8-connected, not anti-aliased): the
# pixels of the 7 x 7 box around c that it sets
JOINT_DOT = _mask(("..###..",
                   ".#####.",
                   "#######",
                   "#######",
                   "#######",
                   ".#####.",
                   "..###.."))
# cv2.circle(img, c, 1, color, 1)
PEAK_RING = _mask((".#.",
                   "#.#",
                   ".#."))


def _jet_bgr() -> np.ndarray:
    """OpenCV's COLORMAP_JET, (256, 3) BGR uint8: each channel a ramp of 4
    per level, rising then falling, saturated to 0-255.  OpenCV builds it
    by float32 interpolation, which ends blue's fall at 1 where the ramp
    gives 2 (level 159); every other entry is the ramp's."""
    i = 4 * np.arange(256)
    b = np.minimum(i + 128, 638 - i)
    b[159] = 1
    g = np.minimum(i - 128, 892 - i)
    r = np.minimum(i - 382, 1148 - i)
    return np.clip(np.stack([b, g, r], axis=1), 0, 255).astype(np.uint8)


JET_BGR = _jet_bgr()


def _joint_dot(x: int, y: int) -> np.ndarray:
    """:data:`JOINT_DOT` as cv2 draws it at (x, y): it fills the dot as a
    polygon, and that fill, clipped at the image's top-left, leaves out
    the bottom row's pixels beside the centre, (x -+ 1, y + 3), where that
    row is row 0, and (x + 1, y + 3) where it is column 0 (held over every
    centre near each edge by tests/test_torch_vis.py)."""
    if y != -3 and x != -1:
        return JOINT_DOT
    mask = JOINT_DOT.copy()
    mask[6, 4] = False
    if y == -3:
        mask[6, 2] = False
    return mask


def _denormalize(images: np.ndarray) -> np.ndarray:
    """Accept uint8 or normalized float NHWC; return uint8 NHWC."""
    if images.dtype == np.uint8:
        return images
    img = (images * _STD + _MEAN) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def joints_grid(batch_image, batch_joints, batch_joints_vis,
                nrow=8, padding=2) -> np.ndarray:
    """Grid of images with green joint dots (vis.py:20-51); BGR HWC uint8.
    ``batch_joints_vis`` is (B, J) or (B, J, 1); a joint is drawn where
    its first value is > 0."""
    images = _denormalize(np.asarray(batch_image))
    b, h, w, _ = images.shape
    nrow = min(nrow, b)
    ncol = int(math.ceil(b / nrow))
    grid = np.zeros((ncol * (h + padding), nrow * (w + padding), 3), np.uint8)
    green = np.array([0, 255, 0], np.uint8)
    k = 0
    for y in range(ncol):
        for x in range(nrow):
            if k >= b:
                break
            img = images[k].copy()
            for joint, vis in zip(batch_joints[k], batch_joints_vis[k]):
                if float(np.atleast_1d(vis)[0]) > 0:
                    c = (int(joint[0]), int(joint[1]))
                    native_image.stamp(img, _joint_dot(*c), c, green)
            ys, xs = y * (h + padding), x * (w + padding)
            grid[ys:ys + h, xs:xs + w] = img
            k += 1
    return grid


def save_batch_image_with_joints(batch_image, batch_joints, batch_joints_vis,
                                 file_name, nrow=8, padding=2):
    native_image.imwrite(file_name, joints_grid(
        batch_image, batch_joints, batch_joints_vis, nrow, padding))


def heatmaps_grid(batch_image, batch_heatmaps) -> np.ndarray:
    """Per-sample row: the image resized to the heatmaps, then each
    joint's JET heatmap over it with its peak ringed in red
    (vis.py:54-116); heatmaps (B, J, h, w); BGR HWC uint8."""
    images = _denormalize(np.asarray(batch_image))
    hm = np.asarray(batch_heatmaps)
    b, j, hh, hw = hm.shape
    grid = np.zeros((b * hh, (j + 1) * hw, 3), np.uint8)
    preds, _ = get_max_preds(hm)
    red = np.array([0.0, 0.0, 255.0])
    for i in range(b):
        img = native_image.resize(images[i], (hw, hh))
        heatmaps = np.clip(hm[i] * 255, 0, 255).astype(np.uint8)
        row0 = i * hh
        grid[row0:row0 + hh, 0:hw] = img
        for ji in range(j):
            masked = JET_BGR[heatmaps[ji]] * 0.7 + img * 0.3
            native_image.stamp(masked, PEAK_RING,
                               (int(preds[i][ji][0]), int(preds[i][ji][1])),
                               red)
            xs = (ji + 1) * hw
            grid[row0:row0 + hh, xs:xs + hw] = masked
    return grid


def save_batch_heatmaps(batch_image, batch_heatmaps, file_name):
    native_image.imwrite(file_name, heatmaps_grid(batch_image,
                                                  batch_heatmaps))


def tb_log_images(writer, tag_prefix, cfg, batch_image, batch_joints,
                  batch_joints_vis, batch_target, batch_output, step):
    """TensorBoard image summaries of the DEBUG.*-gated grids, as HWC RGB
    images tagged ``{tag_prefix}_gt``, ``_hm_pred`` and ``_hm_gt``
    (``fhpe_tpu``'s addition to the reference, which writes scalars
    only).  A failure here never stops a run."""
    if writer is None or not cfg.DEBUG.DEBUG:
        return
    try:
        if cfg.DEBUG.SAVE_BATCH_IMAGES_GT:
            g = joints_grid(batch_image, batch_joints, batch_joints_vis)
            writer.add_image(f"{tag_prefix}_gt", g[..., ::-1], step,
                             dataformats="HWC")
        if cfg.DEBUG.SAVE_HEATMAPS_PRED:
            g = heatmaps_grid(batch_image, batch_output)
            writer.add_image(f"{tag_prefix}_hm_pred", g[..., ::-1], step,
                             dataformats="HWC")
        if cfg.DEBUG.SAVE_HEATMAPS_GT:
            g = heatmaps_grid(batch_image, batch_target)
            writer.add_image(f"{tag_prefix}_hm_gt", g[..., ::-1], step,
                             dataformats="HWC")
    except Exception:  # TB image encoding must never kill a run
        pass


def save_debug_images(cfg, batch_image, batch_joints, batch_joints_vis,
                      batch_target, batch_output, prefix):
    """The DEBUG.*-gated dumps ``{prefix}_gt.jpg``, ``_pred.jpg``,
    ``_hm_gt.jpg`` and ``_hm_pred.jpg`` (vis.py:119-141); heatmaps
    (B, J, h, w), the predicted joints their argmax scaled to the image."""
    if not cfg.DEBUG.DEBUG:
        return
    if cfg.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(batch_image, batch_joints,
                                     batch_joints_vis, f"{prefix}_gt.jpg")
    if cfg.DEBUG.SAVE_BATCH_IMAGES_PRED:
        output = np.asarray(batch_output)
        preds, _ = get_max_preds(output)
        stride = np.asarray(batch_image).shape[1] / output.shape[2]
        save_batch_image_with_joints(
            batch_image, preds * stride,
            np.ones((preds.shape[0], preds.shape[1], 1)),
            f"{prefix}_pred.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_GT:
        save_batch_heatmaps(batch_image, batch_target, f"{prefix}_hm_gt.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_PRED:
        save_batch_heatmaps(batch_image, batch_output, f"{prefix}_hm_pred.jpg")
