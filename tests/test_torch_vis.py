"""The port's debug images (``fhpe_tpu_torch/utils/vis.py``) against
``fhpe_tpu.utils.vis`` (which draws with cv2) on the CPU.

cv2 is imported here, in the test process only, as the oracle of the
port's pieces: the two dot masks, clipped at every edge, and the JET
table.  The grids and the dumps' arrays must be bit-equal to
``fhpe_tpu``'s on seeded batches: 5 samples (3 to a row, the grid's
last row is partial), uint8 and normalized float images, joints inside the image,
on its border and off it, visibility 0 and 1, 16 and 17 joints, heatmaps
as large as the image and a quarter of it, some with their maximum on an
edge and one all below 0.  ``fhpe_tpu`` takes NHWC heatmaps, the port
NCHW.  Arrays are compared, not JPEG bytes.
"""

import os

import numpy as np
import pytest

import fhpe_tpu.utils.vis as vis_jax
from fhpe_tpu.config import get_default_config as default_cfg_jax
from fhpe_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from fhpe_tpu_torch.config import get_default_config
from fhpe_tpu_torch.ops import native_image
from fhpe_tpu_torch.utils import vis

from torch_threads import torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

B = 5
# (image H, W, heatmap h, w, joints)
SHAPES = [(64, 64, 16, 16, 16), (64, 48, 64, 48, 17), (256, 192, 64, 48, 17)]


def _batch(seed, shape, float_images):
    """(images NHWC, joints (B, J, 2), vis (B, J), heatmaps NCHW)."""
    h, w, hh, hw, j = shape
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, h, w, 3)).astype(np.uint8)
    if float_images:
        img = ((img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
            np.float32)
    joints = rng.uniform(-6, max(h, w) + 6, (B, j, 2)).astype(np.float32)
    # on the borders, just off them (int() truncates -0.5 to 0) and past
    # the far edges
    joints[0, :8] = [[0, 0], [w - 1, h - 1], [-0.5, 3], [w, h],
                     [-1.5, 10], [10, -2.5], [w + 1.5, 5], [-3, -3]]
    vis_ = (rng.rand(B, j) > 0.3).astype(np.float32)
    vis_[0, :8] = 1
    hm = (rng.rand(B, j, hh, hw) * 1.3 - 0.1).astype(np.float32)
    hm[1, 2] = -1.0                     # no positive maximum: the peak at 0
    hm[2, 3, 0, 0] = 5.0                # maxima on the corners
    hm[2, 4, hh - 1, hw - 1] = 5.0
    hm[3, 0, hh // 2, 0] = 5.0
    return img, joints, vis_, hm


def _nhwc(hm):
    return np.ascontiguousarray(hm.transpose(0, 2, 3, 1))


def _debug_cfgs(**flags):
    cfgs = []
    for make in (default_cfg_jax, get_default_config):
        cfg = make()
        cfg.DEBUG.DEBUG = True
        for k in ("SAVE_BATCH_IMAGES_GT", "SAVE_BATCH_IMAGES_PRED",
                  "SAVE_HEATMAPS_GT", "SAVE_HEATMAPS_PRED"):
            cfg.DEBUG[k] = flags.get(k, True)
        cfgs.append(cfg)
    return cfgs


def test_dots_equal_cv2_circle_at_every_edge():
    """``_joint_dot`` (cv2.circle(img, c, 2, color, 2)) and ``PEAK_RING``
    (cv2.circle(img, c, 1, color, 1) on float64) against cv2 at every
    centre from 8 pixels off each edge, on images of several sizes (the
    clipped polygon fill at the top-left edge included)."""
    n = 0
    for h, w in [(20, 20), (13, 17), (7, 5), (3, 3)]:
        for x in range(-8, w + 8):
            for y in range(-8, h + 8):
                ref = np.zeros((h, w), np.uint8)
                cv2.circle(ref, (x, y), 2, 1, 2)
                got = np.zeros((h, w), np.uint8)
                native_image.stamp(got, vis._joint_dot(x, y), (x, y), 1)
                assert np.array_equal(got, ref), ("dot", h, w, x, y)
                ref = np.zeros((h, w, 3))
                cv2.circle(ref, (x, y), 1, [0, 0, 255], 1)
                got = np.zeros((h, w, 3))
                native_image.stamp(got, vis.PEAK_RING, (x, y),
                                   np.array([0.0, 0.0, 255.0]))
                assert np.array_equal(got, ref), ("ring", h, w, x, y)
                n += 1
    assert n > 2000
    ref = np.zeros((9, 9), np.uint8)
    cv2.circle(ref, (4, 4), 2, 1, 2)
    np.testing.assert_array_equal(vis.JOINT_DOT, ref[1:8, 1:8].astype(bool))


def test_jet_table_equals_cv2():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        vis.JET_BGR[levels], cv2.applyColorMap(levels, cv2.COLORMAP_JET))


@pytest.mark.parametrize("float_images", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grids_equal_fhpe_tpu(shape, float_images):
    img, joints, vis_, hm = _batch(sum(shape), shape, float_images)
    for jv in (vis_, vis_[..., None]):
        got = vis.joints_grid(img, joints, jv)
        np.testing.assert_array_equal(got, vis_jax.joints_grid(
            img, joints, vis_[..., None]))
    assert got.shape == (shape[0] + 2, B * (shape[1] + 2), 3)
    # 3 to a row: the second row holds 2 samples and a blank slot
    got = vis.joints_grid(img, joints, vis_, nrow=3)
    np.testing.assert_array_equal(got, vis_jax.joints_grid(
        img, joints, vis_[..., None], nrow=3))
    assert got.shape == (2 * (shape[0] + 2), 3 * (shape[1] + 2), 3)
    got = vis.heatmaps_grid(img, hm)
    np.testing.assert_array_equal(got, vis_jax.heatmaps_grid(img, _nhwc(hm)))
    assert got.shape == (B * shape[2], (shape[4] + 1) * shape[3], 3)


def _captured(monkeypatch, module, attr):
    """{file name: array} of the images handed to ``module.attr``."""
    seen = {}

    def write(path, img, *args):
        seen[os.path.basename(path)] = np.array(img)
        return True
    monkeypatch.setattr(module, attr, write)
    return seen


@pytest.mark.parametrize("flags", [{}, {"SAVE_BATCH_IMAGES_PRED": False,
                                        "SAVE_HEATMAPS_GT": False}],
                         ids=["all", "some"])
@pytest.mark.parametrize("float_images", [False, True])
def test_save_debug_images_equal_fhpe_tpu(monkeypatch, float_images, flags):
    """The four dumps (``_gt``, ``_pred``: the heatmaps' argmax scaled to
    the image, ``_hm_gt``, ``_hm_pred``) as each flag asks, and none with
    ``DEBUG.DEBUG`` off."""
    shape = SHAPES[2]
    img, joints, vis_, out = _batch(7, shape, float_images)
    target = _batch(8, shape, False)[3]
    cfg_jax, cfg = _debug_cfgs(**flags)
    ref = _captured(monkeypatch, cv2, "imwrite")
    got = _captured(monkeypatch, native_image, "imwrite")
    vis_jax.save_debug_images(cfg_jax, img, joints, vis_[..., None],
                              _nhwc(target), _nhwc(out), "/x/val_3")
    vis.save_debug_images(cfg, img, joints, vis_[..., None], target, out,
                          "/x/val_3")
    want = {f"val_3_{s}.jpg" for s, k in (
        ("gt", "SAVE_BATCH_IMAGES_GT"), ("pred", "SAVE_BATCH_IMAGES_PRED"),
        ("hm_gt", "SAVE_HEATMAPS_GT"), ("hm_pred", "SAVE_HEATMAPS_PRED"))
        if flags.get(k, True)}
    assert got.keys() == ref.keys() == want
    for name in want:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    cfg.defrost()
    cfg.DEBUG.DEBUG = False
    got.clear()
    vis.save_debug_images(cfg, img, joints, vis_, target, out, "/x/val_4")
    assert not got


def test_dump_reads_back(tmp_path):
    """A written dump is the grid's JPEG (quality 95) and decodes at the
    grid's shape through the port's image library."""
    img, joints, vis_, hm = _batch(3, SHAPES[0], False)
    cfg = _debug_cfgs()[1]
    vis.save_debug_images(cfg, img, joints, vis_, hm, hm,
                          str(tmp_path / "train_0_0"))
    grid = vis.heatmaps_grid(img, hm)
    path = tmp_path / "train_0_0_hm_pred.jpg"
    assert path.read_bytes() == native_image.encode_jpeg(grid)
    assert native_image.imread(str(path)).shape == grid.shape
    assert sorted(os.listdir(tmp_path)) == [
        f"train_0_0_{s}.jpg" for s in ("gt", "hm_gt", "hm_pred", "pred")]


class _Writer:
    def __init__(self, fail=False):
        self.images, self.fail = [], fail

    def add_image(self, tag, img, step, dataformats):
        if self.fail:
            raise RuntimeError("encoding failed")
        self.images.append((tag, np.array(img), step, dataformats))


def test_tb_log_images():
    """The DEBUG-gated grids as HWC RGB images: tags, order and pixels as
    ``fhpe_tpu``'s; nothing without a writer or with ``DEBUG.DEBUG`` off;
    a writer that raises does not stop the run."""
    img, joints, vis_, out = _batch(11, SHAPES[0], True)
    target = _batch(12, SHAPES[0], False)[3]
    cfg_jax, cfg = _debug_cfgs()
    got, ref = _Writer(), _Writer()
    vis.tb_log_images(got, "valid", cfg, img, joints, vis_[..., None],
                      target, out, 7)
    vis_jax.tb_log_images(ref, "valid", cfg_jax, img, joints,
                          vis_[..., None], _nhwc(target), _nhwc(out), 7)
    assert [g[0] for g in got.images] == ["valid_gt", "valid_hm_pred",
                                          "valid_hm_gt"]
    for (tag, a, step, fmt), (rtag, r, rstep, rfmt) in zip(got.images,
                                                           ref.images):
        assert (tag, step, fmt) == (rtag, rstep, rfmt) == (tag, 7, "HWC")
        np.testing.assert_array_equal(a, r)
    # RGB: the BGR grid with its channels reversed
    np.testing.assert_array_equal(
        got.images[1][1], vis.heatmaps_grid(img, out)[..., ::-1])
    vis.tb_log_images(None, "valid", cfg, img, joints, vis_, target, out, 0)
    vis.tb_log_images(_Writer(fail=True), "valid", cfg, img, joints, vis_,
                      target, out, 0)
    cfg.defrost()
    cfg.DEBUG.DEBUG = False
    off = _Writer()
    vis.tb_log_images(off, "valid", cfg, img, joints, vis_, target, out, 0)
    assert not off.images
