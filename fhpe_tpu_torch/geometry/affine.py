"""Affine-transform geometry for top-down pose cropping (numpy).

A copy of ``fhpe_tpu/geometry/affine.py`` (``get_affine_transform``,
``affine_transform``, ``transform_preds``): ``fhpe_tpu.geometry`` imports
JAX in its package ``__init__``.  The two are held bit-equal by
``tests/test_torch_port_hygiene.py``.  ``fhpe_tpu`` solves the
correspondence with ``cv2.getAffineTransform`` where cv2 imports; the
port replays that solve's arithmetic in Python instead.

Conventions (identical to the reference):
* ``scale`` is in units of 200 px (``pixel_std``): box side = scale * 200.
* ``output_size`` is (width, height).
* rotation is in degrees, counter-clockwise about the box center.
"""

from __future__ import annotations

import numpy as np


def _rotate(point: np.ndarray, rad: float) -> np.ndarray:
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([point[0] * cs - point[1] * sn,
                     point[0] * sn + point[1] * cs], dtype=np.float64)


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Third corner completing a right triangle: b + perp(a - b).

    Arithmetic happens in the inputs' dtype (float32 in the transform
    construction) to mirror the reference's get_3rd_point exactly.
    """
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=d.dtype)


# OpenCV's LU (matrix_decomp.cpp::LUImpl) gives up on a pivot below this
_LU_EPS = np.finfo(np.float64).eps * 100


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine T with T @ [src_i, 1]^T = dst_i for three point pairs.

    ``cv2.getAffineTransform``'s arithmetic, replayed in float64 without
    cv2 (the port imports none): the points quantized to float32, as the
    reference's float32 point arrays reach cv2; the 6x6 system of
    imgwarp.cpp; OpenCV's LU solve (partial pivoting, first largest pivot,
    ``alpha = a[j][i] * (-1 / a[i][i])`` row updates, back substitution
    dividing by the pivot).  The same operations in the same order give
    the same bits as cv2 (held to it in
    ``tests/test_torch_port_hygiene.py``): the last bits decide isolated
    warped pixels at exact bilinear ties.  A singular system gives zeros,
    as ``cv2.solve`` does.
    """
    src32 = np.asarray(src, dtype=np.float32)
    dst32 = np.asarray(dst, dtype=np.float32)
    a, b = [], []
    for i in range(3):
        x, y = float(src32[i, 0]), float(src32[i, 1])
        a += [[x, y, 1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, x, y, 1.0]]
        b += [float(dst32[i, 0]), float(dst32[i, 1])]
    m = len(a)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < _LU_EPS:
            return np.zeros((2, 3))
        a[i], a[k] = a[k], a[i]
        b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for col in range(i + 1, m):
                a[j][col] += alpha * a[i][col]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for col in range(i + 1, m):
            s -= a[i][col] * b[col]
        b[i] = s / a[i][i]
    return np.array(b, dtype=np.float64).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0), inv=False):
    """Affine matrix mapping the (center, scale, rot) person box to output pixels.

    Correspondence points are the box center, a point half a box-width
    above it (rotated by ``rot``), and the perpendicular third point; the
    source box width is ``scale[0] * 200``.  ``inv=True`` returns the
    output->source transform (maps predictions back to the source image).
    """
    # Dtype flow follows numpy promotion of the inputs: float32 COCO
    # records round the box width to float32 before the point
    # construction, float64 MPII records stay float64.
    center = np.asarray(center)
    scale = np.asarray(scale)
    if not np.issubdtype(scale.dtype, np.floating):
        scale = scale.astype(np.float64)
    if not np.issubdtype(center.dtype, np.floating):
        center = center.astype(np.float64)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=scale.dtype)
    shift = np.asarray(shift, dtype=np.float32)

    box = scale * 200.0
    src_w = box[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate(np.array([0.0, src_w * np.asarray(-0.5, src_w.dtype)],
                               dtype=np.float64), rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5])

    # rows 0/1 are float64 expressions stored into float32 arrays; the
    # third point is derived from the stored float32 values in float32
    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + box * shift
    src[1] = center + src_dir + box * shift
    src[2] = _third_point(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t) -> np.ndarray:
    """Apply a 2x3 affine to a single (x, y) point."""
    p = np.array([pt[0], pt[1], 1.0])
    return (t @ p)[:2]


def transform_preds(coords, center, scale, output_size) -> np.ndarray:
    """Map heatmap-space keypoints back to source-image coordinates.

    coords: (num_joints, 2+) array; only [:, :2] is transformed.
    """
    coords = np.asarray(coords)
    t = get_affine_transform(center, scale, 0, output_size, inv=True)
    ones = np.ones((coords.shape[0], 1))
    homo = np.concatenate([coords[:, :2], ones], axis=1)  # (J, 3)
    out = np.zeros(coords.shape)
    out[:, :2] = homo @ t.T
    return out
