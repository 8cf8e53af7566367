"""``TPU.DEVICE_WARP`` in the port against ``fhpe_tpu``'s, on the CPU.

Mirrors ``tests/test_device_warp.py``:

* ``native_image.resize`` (the letterbox canvas's resize) bit-equal to
  ``cv2.resize`` INTER_LINEAR: up and down scales, odd sizes, an exact
  halving (cv2 takes INTER_AREA there) and scale 1;
* ``ops/preprocess.py::warp_affine`` against ``warp_affine_jax`` in
  float32;
* a training sample of ``PoseDataSource``: canvas, matrix, joints and
  flips equal to ``fhpe_tpu``'s on the same synthetic set and seed, and
  its device-warped crop within ``tests/test_device_warp.py``'s bars of
  the host-warped crop; evaluation keeps the host warp;
* the canvas branch of ``make_batch_preprocessor``, and one float64 train
  step on a ``BatchLoader`` canvas batch, against ``fhpe_tpu``'s;
* ``load_config``'s two checks, as ``fhpe_tpu``'s.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhpe_tpu.config import get_default_config as default_cfg_jax
from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.data import loader as loader_jax
from fhpe_tpu.ops.preprocess import warp_affine_jax
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import get_mesh, shard_batch
from fhpe_tpu.train import state as state_jax
from fhpe_tpu.utils.torch_import import import_hourglass
from fhpe_tpu.train import step as step_jax
from fhpe_tpu_torch.config import MODEL_EXTRAS, get_default_config, \
    load_config
from fhpe_tpu_torch.data import (BatchLoader, PoseDataSource, dataset_meta,
                                 loader,
                                 make_synthetic_db)
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.ops import native_image
from fhpe_tpu_torch.ops.preprocess import warp_affine
from fhpe_tpu_torch.train import (create_train_state,
                                  make_batch_preprocessor, make_train_step)

from test_torch_train import (HW, X64_RTOL, _both, _check_adam,
                              _check_stats, _port_model)
from torch_threads import torch_threads  # noqa: F401

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_YAML = os.path.join(
    REPO, "experiments/fpd_mpii/hourglass/hg4_128_fpd_student.yaml")
CROP = 128            # the samples' model input, as tests/test_device_warp.py
IMAGE_HW = (200, 240)
# float32 warps: the same operations in the same order on both sides;
# a floor that differed would move a pixel by a whole tap (tens of levels
# on these noise images), far above this bar
WARP_ATOL = 1e-4


# -- the resize ---------------------------------------------------------------

RESIZE_CASES = [
    ((480, 640), (512, 384)),     # down, both axes (a MPII frame -> canvas)
    ((100, 120), (512, 427)),     # up
    ((1024, 1024), (512, 512)),   # an exact halving: cv2's INTER_AREA path
    ((50, 64), (32, 25)),         # an exact halving, non-square
    ((64, 64), (64, 64)),         # scale 1: a copy
    ((64, 80), (80, 32)),         # one axis at scale 1, the other halved
    ((37, 53), (77, 101)),        # odd, up
    ((255, 333), (166, 127)),     # odd, down by just over 2
    ((51, 50), (25, 25)),         # one axis exactly 2, the other not
    ((720, 1280), (512, 288)),    # a 720p frame
    ((7, 5), (2, 3)),
    ((1, 1), (4, 5)),
    ((3, 9), (1, 1)),
]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src_hw,dsize", RESIZE_CASES)
def test_resize_bit_equal_to_cv2(src_hw, dsize, channels):
    rng = np.random.RandomState(src_hw[0] * 7 + dsize[0])
    shape = src_hw + (channels,) if channels > 1 else src_hw
    img = rng.randint(0, 256, size=shape).astype(np.uint8)
    got = native_image.resize(img, dsize)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resize_rejects_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        native_image.resize(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="uint8"):
        native_image.resize(np.zeros((4, 4, 5), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="resize of"):
        native_image.resize(np.zeros((4, 4, 3), np.uint8), (0, 2))


# -- the warp -----------------------------------------------------------------

def _matrices(b, rng):
    """dst->src matrices: rotations, scales, one mirror, offsets that put
    parts of the crops outside the source."""
    inv = np.zeros((b, 2, 3), np.float32)
    for i in range(b):
        a, s = rng.uniform(-np.pi, np.pi), rng.uniform(0.3, 1.6)
        inv[i, :, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                      [np.sin(a), np.cos(a)]])
        if i == 1:
            inv[i, 0, :2] *= -1
        inv[i, :, 2] = rng.uniform(-20, 80, 2)
    return inv


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_affine_matches_jax(dtype):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 70, 90, 3)).astype(dtype)
    inv = _matrices(4, rng)
    got = warp_affine(torch.from_numpy(images), torch.from_numpy(inv),
                      (40, 50))
    want = np.asarray(warp_affine_jax(jnp.asarray(images), jnp.asarray(inv),
                                      (40, 50)))
    assert got.shape == (4, 50, 40, 3) and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert (diff > 0.5).sum() == 0          # no floor differed
    assert diff.max() <= WARP_ATOL
    assert (want == 0).mean() > 0.05        # the border was reached


# -- the samples ----------------------------------------------------------------

def _cfgs(device_warp=True, canvas=(256, 256)):
    """The same sample config for both packages: 16 MPII joints, a 128 x
    128 crop, ``fhpe_tpu``'s native decode (its device-warp branch
    resizes with cv2 whatever NATIVE_WARP says)."""
    out = []
    for make, extras in ((default_cfg_jax, None), (get_default_config,
                                                   MODEL_EXTRAS)):
        cfg = make()
        cfg.MODEL.NUM_JOINTS = 16
        cfg.MODEL.IMAGE_SIZE = [CROP, CROP]
        cfg.MODEL.HEATMAP_SIZE = [CROP // 4, CROP // 4]
        cfg.TPU.DEVICE_WARP = device_warp
        cfg.TPU.CANVAS_SIZE = list(canvas)
        cfg.TPU.NATIVE_DECODE = cfg.TPU.NATIVE_WARP = True
        if extras is not None:
            cfg.MODEL.EXTRA = extras["hourglass"]()
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return make_synthetic_db(str(tmp_path_factory.mktemp("syn")),
                             num_samples=8, image_hw=IMAGE_HW)


def _source(mod, cfg, db, is_train=True, seed=9):
    meta = dataset_meta("mpii")
    return mod.PoseDataSource(cfg, db, is_train=is_train,
                              flip_pairs=meta["flip_pairs"],
                              upper_body_ids=meta["upper_body_ids"],
                              seed=seed)


# (256, 256) upscales the 200 x 240 images, (128, 160) shrinks them
@pytest.mark.parametrize("canvas", [(256, 256), (128, 160)])
def test_device_warp_sample_matches_jax(db, canvas):
    cfg_j, cfg_t = _cfgs(True, canvas)
    got_src = _source(loader, cfg_t, db)
    ref_src = _source(loader_jax, cfg_j, db)
    flips = 0
    for i in range(len(db)):
        got, ref = got_src.get_sample(i), ref_src.get_sample(i)
        assert "image" not in got and got.keys() == ref.keys()
        assert got["canvas"].shape == (canvas[1], canvas[0], 3)
        np.testing.assert_array_equal(got["canvas"], ref["canvas"])
        assert got["warp_inv"].dtype == ref["warp_inv"].dtype == np.float32
        np.testing.assert_array_equal(got["warp_inv"], ref["warp_inv"])
        for k in ("joints", "joints_vis", "center", "scale", "rotation",
                  "flipped"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        if got["flipped"]:
            flips += 1
            assert np.linalg.det(got["warp_inv"][:, :2]) < 0
    assert flips > 0, "the seed drew no flip: the mirror went untested"


def test_device_warp_crop_near_host_warp(db):
    """The crop warped from the canvas against the host warp of the same
    augmentation draws (the port's own sources, the same seed): one more
    bilinear resample, within ``tests/test_device_warp.py``'s bars."""
    dev = _source(loader, _cfgs(True)[1], db)
    host = _source(loader, _cfgs(False)[1], db)
    for i in range(len(db)):
        s_dev, s_host = dev.get_sample(i), host.get_sample(i)
        assert s_dev["flipped"] == s_host["flipped"]
        warped = warp_affine(torch.from_numpy(s_dev["canvas"][None]),
                             torch.from_numpy(s_dev["warp_inv"][None]),
                             (CROP, CROP))[0].numpy()
        diff = np.abs(warped - s_host["image"].astype(np.float32))
        assert diff.mean() < 6.0, diff.mean()
        assert np.median(diff) < 3.0
        np.testing.assert_array_equal(s_dev["joints"], s_host["joints"])


def test_eval_ignores_device_warp(db):
    src = _source(loader, _cfgs(True)[1], db, is_train=False)
    s = src.get_sample(0)
    assert "image" in s and "canvas" not in s
    assert s["image"].shape == (CROP, CROP, 3)


# -- the step -------------------------------------------------------------------

def _canvas_batch(cfg, db, host_targets=False, batch=4):
    """The first ``BatchLoader`` batch of a DEVICE_WARP source."""
    meta = dataset_meta("mpii")
    src = PoseDataSource(cfg, db, is_train=True,
                         flip_pairs=meta["flip_pairs"],
                         upper_body_ids=meta["upper_body_ids"], seed=5)
    bl = BatchLoader(src, batch_size=batch, drop_last=True,
                     host_targets=host_targets, num_threads=2)
    out = next(iter(bl))
    bl.close()
    return out


def test_canvas_preprocessor_matches_jax(db):
    cfg_j, cfg_t = _both(1, 16, **{"TPU.DEVICE_WARP": True,
                                   "TPU.CANVAS_SIZE": [128, 128]})
    raw = _canvas_batch(cfg_t, db)
    assert raw["canvas"].shape == (4, 128, 128, 3)
    keys = ("canvas", "warp_inv", "joints", "joints_vis")
    got = make_batch_preprocessor(cfg_t)(
        {k: torch.from_numpy(raw[k]) for k in keys})
    ref = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(raw[k]) for k in keys})
    nchw = (lambda a: np.moveaxis(np.asarray(a), -1, -3))
    assert got["image"].shape == (4, 3, HW, HW)
    np.testing.assert_allclose(got["image"].numpy(), nchw(ref["image"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.asarray(ref["target_weight"]))
    np.testing.assert_allclose(got["target"].numpy(), nchw(ref["target"]),
                               rtol=0, atol=1e-6)


def _seeded_variables(cfg_t, seed):
    """float64 weights for both sides without a JAX init (seconds op by
    op): the port's hourglass drawn by torch from ``seed``, its BN scale,
    bias, mean and var redrawn with numpy (as
    ``test_torch_hourglass._jax_variables`` does, so that eval-mode BN is
    not the identity), imported by ``fhpe_tpu``'s own torch importer."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_pose_net(cfg_t).double()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for t, draw in ((m.weight, "scale"), (m.running_var, "scale"),
                                (m.bias, "shift"), (m.running_mean, "shift")):
                    t.copy_(torch.from_numpy(
                        rng.uniform(0.5, 1.5, t.shape) if draw == "scale"
                        else rng.normal(0, 0.1, t.shape)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return import_hourglass(sd, int(cfg_t.MODEL.EXTRA.NUM_STACKS))


def _jax_train_state(cfg_j, variables):
    """``fhpe_tpu``'s train state on ``variables`` without a second init:
    what ``create_train_state`` builds around the variables it draws."""
    tx = state_jax.make_optimizer(cfg_j)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return state_jax.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)


def test_canvas_train_step_matches_jax(db):
    """One float64 ``make_train_step`` (Adam, MSE) on a ``BatchLoader``
    canvas batch, the port's crop inside its step, against
    ``fhpe_tpu``'s step: loss, BN running stats, Adam moments and
    parameters at ``tests/test_torch_train.py``'s bars.

    Both sides start from one float32 crop and one set of targets, as
    that file feeds its steps.  The targets are the loader's (host).
    ``fhpe_tpu``'s jitted step fuses its warp with what follows and rounds
    it differently from its own eager warp (by float32 ulps), so its side
    takes the crops of its eager preprocessor, which equal the port's
    warp bit for bit (checked here, and held above).  Only the step is
    float64 on the JAX side (``jax.enable_x64``): the preprocessing and
    the weights' draw are the float32 ones of the tests above."""
    cfg_j, cfg_t = _both(1, 16, dtype="float64", **{
        "TPU.DEVICE_WARP": True, "TPU.CANVAS_SIZE": [128, 128]})
    raw = _canvas_batch(cfg_t, db, host_targets=True)
    svars = _seeded_variables(cfg_t, seed=61)
    keys = ("canvas", "warp_inv", "target", "target_weight")
    batch_j = step_jax.make_batch_preprocessor(cfg_j)(
        {k: jnp.asarray(raw[k]) for k in keys})
    batch_j = {k: np.asarray(batch_j[k])
               for k in ("image", "target", "target_weight")}

    state_t = create_train_state(
        cfg_t, _port_model(cfg_t, svars, torch.float64), device="cpu")
    batch_t = {k: torch.from_numpy(raw[k]) for k in keys}
    batch_t["target"] = batch_t["target"].permute(0, 3, 1, 2).contiguous()
    prepare = make_batch_preprocessor(cfg_t)
    np.testing.assert_array_equal(prepare(batch_t)["image"].numpy(),
                                  np.moveaxis(batch_j["image"], -1, -3))
    step_t = make_train_step(cfg_t, prepare=prepare)
    state_t, m_t = step_t(state_t, batch_t)

    with jax.enable_x64(True):
        mesh = get_mesh(1)
        model_j = get_pose_net_jax(cfg_j, dtype=jnp.float64)
        state_j = _jax_train_state(cfg_j, svars)
        step_j = step_jax.make_train_step(model_j, cfg_j, mesh, True)
        state_j, m_j = step_j(state_j, shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in batch_j.items()}))

    np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                               rtol=X64_RTOL)
    _check_stats(cfg_t, state_t.model, state_j.params, state_j.batch_stats)
    _check_adam(cfg_t, state_t, state_j, float(cfg_t.TRAIN.LR))


# -- load_config --------------------------------------------------------------

@pytest.mark.parametrize("opts,raises,warns", [
    (["TPU.DEVICE_WARP", "True", "TPU.DEVICE_PREPROCESS", "False"],
     ValueError, None),
    (["TPU.DEVICE_WARP", "True"], None, None),
    (["TPU.FUSED_EVAL", "True"], None, UserWarning),
])
def test_load_config_checks_match_jax(opts, raises, warns):
    """The same overrides give the same exception or warning, text and
    all, in both packages."""
    seen = []
    for load in (load_config_jax, load_config):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                load(STUDENT_YAML, opts)
                err = None
            except Exception as e:    # compared between the packages below
                err = (type(e), str(e))
        seen.append((err, [(w.category, str(w.message)) for w in caught]))
    assert seen[0] == seen[1]
    err, caught = seen[1]
    assert (err and err[0]) is (raises or None)
    if raises is ValueError:
        assert "requires TPU.DEVICE_PREPROCESS" in err[1]
    assert [c for c, _ in caught] == ([warns] if warns else [])
