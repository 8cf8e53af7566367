"""The port's host data path against ``fhpe_tpu``'s, on one on-disk
synthetic MPII set and one COCO set that ``fhpe_tpu``'s writers made
(32 images each, 96 x 128).

* ``build_db`` (MPII; COCO gt and detector boxes; the pickle cache) and
  ``select_data``: equal field by field, dtypes included;
* ``PoseDataSource.get_sample``, train mode (half-body and flip hit) and
  eval mode: geometry, joints, visibility and targets exact; the image
  bit-equal to ``fhpe_tpu``'s native path and within
  ``tests/test_native_image.py``'s tie budget of its cv2 path;
* two epochs of ``BatchLoader`` batches for a seed: the same order,
  augmentation and ``valid`` padding;
* ``TPU.DECODE_CACHE_MB`` and the zip path;
* the slice: ``build_loaders`` -> ``device_batch`` -> a tiny
  ``make_eval_step`` (flip test) -> MPII ``evaluate``, against the same
  through ``fhpe_tpu``.
"""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhpe_tpu import data as data_jax
from fhpe_tpu.cli import common as common_jax
from fhpe_tpu.config import get_default_config as default_cfg_jax
from fhpe_tpu.config import load_config as load_config_jax
from fhpe_tpu.data import loader as loader_jax
from fhpe_tpu.geometry.flip import flip_pair_permutation
from fhpe_tpu.models import get_pose_net as get_pose_net_jax
from fhpe_tpu.parallel.mesh import get_mesh
from fhpe_tpu.train import step as step_jax
from fhpe_tpu_torch import data
from fhpe_tpu_torch.cli import common
from fhpe_tpu_torch.config import get_default_config, load_config
from fhpe_tpu_torch.data import loader
from fhpe_tpu_torch.models import get_pose_net
from fhpe_tpu_torch.train import make_batch_preprocessor, make_eval_step
from fhpe_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_hourglass import _jax_variables
from test_torch_image import _tie_close
from torch_threads import torch_threads  # noqa: F401

N, HW = 32, (96, 128)
MPII_SET, COCO_SET = "synval", "syn2017"
STUDENT_YAML = "experiments/fpd_mpii/hourglass/hg4_128_fpd_student.yaml"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """fhpe_tpu's writers: an MPII set, a COCO set, and detector boxes
    for the COCO set (one per person, plus a non-person and a
    low-score box that the builder drops)."""
    root = tmp_path_factory.mktemp("data")
    mpii_root, coco_root = root / "mpii", root / "coco"
    data_jax.make_synthetic_mpii(str(mpii_root), MPII_SET, N, HW, seed=0)
    ann = data_jax.make_synthetic_coco(str(coco_root), COCO_SET, N, HW,
                                       seed=1)
    rng = np.random.RandomState(2)
    dets = [{"image_id": a["image_id"], "category_id": 1,
             "bbox": [float(v) + rng.uniform(-3, 3) for v in a["bbox"]],
             "score": float(rng.uniform(0.2, 1.0))}
            for a in json.load(open(ann))["annotations"]]
    dets += [dict(dets[0], category_id=2), dict(dets[1], score=0.05)]
    boxes = root / "dets.json"
    boxes.write_text(json.dumps(dets))
    return mpii_root, coco_root, boxes


def _cfgs(name, root, image_size=(64, 64), native=False, **opts):
    """The same config for both packages (``fhpe_tpu``'s native image path
    when ``native``): no db cache unless asked, 4 loader threads."""
    out = []
    for make in (default_cfg_jax, get_default_config):
        cfg = make()
        cfg.DATASET.DATASET = name
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.TRAIN_SET = cfg.DATASET.TEST_SET = (
            MPII_SET if name == "mpii" else COCO_SET)
        cfg.DATASET.CACHE_ROOT = ""
        cfg.DATASET.PROB_HALF_BODY = 0.5
        cfg.MODEL.NUM_JOINTS = 17 if name == "coco" else 16
        cfg.MODEL.IMAGE_SIZE = list(image_size)
        cfg.MODEL.HEATMAP_SIZE = [v // 4 for v in image_size]
        cfg.WORKERS = 4
        cfg.TPU.NATIVE_DECODE = cfg.TPU.NATIVE_WARP = native
        for key, value in opts.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        out.append(cfg)
    return out


def _same_db(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert type(g[k]) is type(r[k]), k
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("is_train", [True, False])
def test_build_db_mpii(roots, is_train):
    cfg_j, cfg_t = _cfgs("mpii", roots[0])
    _same_db(data.build_db(cfg_t, MPII_SET, is_train),
             data_jax.build_db(cfg_j, MPII_SET, is_train))


@pytest.mark.parametrize("use_gt", [True, False])
def test_build_db_coco_gt_and_detections(roots, use_gt):
    cfg_j, cfg_t = _cfgs("coco", roots[1], (48, 64), **{
        "TEST.USE_GT_BBOX": use_gt, "TEST.COCO_BBOX_FILE": str(roots[2]),
        "TEST.IMAGE_THRE": 0.1})
    got = data.build_db(cfg_t, COCO_SET, False)
    _same_db(got, data_jax.build_db(cfg_j, COCO_SET, False))
    assert len(got) == N and ("score" in got[0]) != use_gt


def test_build_db_cache_and_select_data(roots, tmp_path):
    """The pickle cache round-trips; ``select_data`` keeps the same
    records (some of them: the centres are moved off the joints)."""
    cfg_j, cfg_t = _cfgs("mpii", roots[0], **{
        "DATASET.CACHE_ROOT": str(tmp_path), "DATASET.SELECT_DATA": True})
    first = data.build_db(cfg_t, MPII_SET, True)
    assert (tmp_path / f"mpii_cached_{MPII_SET}_db.pkl").is_file()
    _same_db(data.build_db(cfg_t, MPII_SET, True), first)
    _same_db(first, data_jax.build_db(cfg_j, MPII_SET, True))
    db = data.build_db(cfg_t, MPII_SET, False)
    rng = np.random.RandomState(0)
    for rec in db:
        rec["center"] = rec["center"] + rng.normal(0, 40, 2)
    kept = data.filters.select_data(db)
    _same_db(kept, data_jax.filters.select_data(db))
    assert 0 < len(kept) < len(db)


def _sources(cfgs, db, is_train, seed=11):
    meta = data.dataset_meta("mpii")
    return [mod.PoseDataSource(cfg, db, is_train=is_train,
                               flip_pairs=meta["flip_pairs"],
                               upper_body_ids=meta["upper_body_ids"],
                               seed=seed)
            for mod, cfg in zip((loader_jax, loader), cfgs)]


def _same_sample(got, ref, native):
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "image" and not native:
            _tie_close(ref[k], got[k])
        elif k == "image_path":
            assert got[k] == ref[k]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("is_train", [True, False])
def test_get_sample(roots, native, is_train):
    cfgs = _cfgs("mpii", roots[0], native=native)
    db = data.build_db(cfgs[1], MPII_SET, is_train)
    ref_src, src = _sources(cfgs, db, is_train)
    flips = half_body = 0
    for i in range(16):
        if is_train:
            p_ref = ref_src.draw_augment_params(i)
            params = src.draw_augment_params(i)
            flips += params["flipped"]
            half_body += not np.allclose(params["c"], db[i]["center"])
        else:
            p_ref = params = None
        _same_sample(src.get_sample(i, True, params),
                     ref_src.get_sample(i, True, p_ref), native)
    if is_train:
        assert flips and half_body


def test_batchloader_two_epochs(roots):
    """Shuffled, 30 records in batches of 8 (the last padded to 8 with 6
    valid), host targets, 4 threads: two epochs equal batch for batch."""
    cfgs = _cfgs("mpii", roots[0], native=True)
    db = data.build_db(cfgs[1], MPII_SET, True)[:30]
    epochs = []
    for mod, src in zip((loader_jax, loader), _sources(cfgs, db, True)):
        bl = mod.BatchLoader(src, batch_size=8, shuffle=True,
                             host_targets=True, num_threads=4, seed=5)
        epochs.append([list(bl), list(bl)])
        bl.close()
    ref, got = epochs
    for e in range(2):
        assert len(got[e]) == len(ref[e]) == 4
        for g, r in zip(got[e], ref[e]):
            _same_sample(g, r, native=True)
        assert got[e][-1]["valid"].sum() == 6
    assert got[0][0]["image_path"] != got[1][0]["image_path"]


def test_decode_cache_and_zip(roots, tmp_path, monkeypatch):
    """With ``TPU.DECODE_CACHE_MB`` a second pass decodes nothing and
    gives the same samples; with ``DATA_FORMAT zip`` the images come out
    of ``images.zip`` equal to the files."""
    cfgs = _cfgs("mpii", roots[0], native=True)
    db = data.build_db(cfgs[1], MPII_SET, False)
    uncached = _sources(cfgs, db, False)[1]
    plain = [uncached.get_sample(i) for i in range(4)]
    cached_cfgs = _cfgs("mpii", roots[0], native=True,
                        **{"TPU.DECODE_CACHE_MB": 64})
    src = _sources(cached_cfgs, db, False)[1]
    reads = []
    orig = loader._read_image
    monkeypatch.setattr(loader, "_read_image",
                        lambda *a: reads.append(a[0]) or orig(*a))
    train_src = _sources(cached_cfgs, db, True)[1]
    for _ in range(2):
        for i in range(4):
            _same_sample(src.get_sample(i), plain[i], native=True)
            train_src.get_sample(i)
    assert len(reads) == 8          # one decode per image and source
    assert loader._cache_used[0] > 0

    zroot = tmp_path / "zipped"
    (zroot / "annot").mkdir(parents=True)
    for f in ("annot/synval.json", "annot/gt_synval.mat"):
        (zroot / f).write_bytes((roots[0] / f).read_bytes())
    with zipfile.ZipFile(zroot / "images.zip", "w") as zf:
        for rec in db[:4]:
            zf.write(rec["image"], rec["image"].rsplit("/", 1)[-1])
    zcfgs = _cfgs("mpii", zroot, native=True, **{"DATASET.DATA_FORMAT":
                                                 "zip"})
    zdb = [data.build_db(c, MPII_SET, False)[:4] for c in zcfgs]
    assert ".zip@" in zdb[1][0]["image"]
    meta = data.dataset_meta("mpii")
    for i in range(4):
        srcs = [mod.PoseDataSource(c, d, False, meta["flip_pairs"],
                                   meta["upper_body_ids"])
                for mod, c, d in zip((loader_jax, loader), zcfgs, zdb)]
        got, ref = (s.get_sample(i) for s in srcs[::-1])
        _same_sample(got, ref, native=True)
        np.testing.assert_array_equal(got["image"], plain[i]["image"])
    # TPU.DEVICE_WARP: a training sample is a letterbox canvas and its
    # matrix, fhpe_tpu's (tests/test_torch_device_warp.py holds the rest)
    warp_cfgs = _cfgs("mpii", roots[0], native=True,
                      **{"TPU.DEVICE_WARP": True})
    got, ref = (s.get_sample(0) for s in _sources(warp_cfgs, db, True)[::-1])
    assert "image" not in got and got.keys() == ref.keys()
    assert got["canvas"].shape == (512, 512, 3)
    np.testing.assert_array_equal(got["canvas"], ref["canvas"])
    np.testing.assert_array_equal(got["warp_inv"], ref["warp_inv"])


def test_build_loaders_synthetic_dir(tmp_path):
    """``build_loaders``' hermetic mode: the same 64 records as
    ``fhpe_tpu``'s, the first 32 validated, batches of the config's
    sizes."""
    cfgs = _cfgs("synthetic", tmp_path, **{"TRAIN.BATCH_SIZE_PER_GPU": 16,
                                           "TEST.BATCH_SIZE_PER_GPU": 8})
    ref = common_jax.build_loaders(cfgs[0], 1, str(tmp_path / "ref"))
    got = common.build_loaders(cfgs[1], str(tmp_path / "port"))
    for r, g in zip(ref[:2], got[:2]):
        _same_db([dict(rec, image=rec["image"].replace("/port/", "/ref/"))
                  for rec in g.source.db], r.source.db)
        r.close()
        g.close()
    assert len(got[0]) == 4 and len(got[1]) == 4
    assert got[2] == data.dataset_meta("mpii")


def test_slice_eval_pckh(roots):
    """The port's loader -> eval step (1-stack, 16-feature hourglass at
    64 x 64, float32, flip test) -> PCKh equals ``fhpe_tpu``'s: preds
    within 1e-3 px (float32 heatmaps differ by ~1e-5), PCKh equal to
    1e-9.  Batches of 12 over 32 people: the last one padded."""
    opts = ["MODEL.IMAGE_SIZE", "[64,64]", "MODEL.HEATMAP_SIZE", "[16,16]",
            "MODEL.EXTRA.NUM_STACKS", "1", "MODEL.EXTRA.NUM_FEATURES", "16",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.NUM_DEVICES", "1",
            "DATASET.ROOT", str(roots[0]), "DATASET.TEST_SET", MPII_SET,
            "DATASET.CACHE_ROOT", "", "TEST.BATCH_SIZE_PER_GPU", "12",
            "TPU.NATIVE_DECODE", "True", "TPU.NATIVE_WARP", "True",
            "WORKERS", "2"]
    cfg_j = load_config_jax(STUDENT_YAML, opts)
    cfg_t = load_config(STUDENT_YAML, opts)
    perm = flip_pair_permutation(16, data.MPII_FLIP_PAIRS)
    variables = _jax_variables(cfg_j, (64, 64), seed=3)[1]

    mesh = get_mesh(1)
    _, val_j, _ = common_jax.build_loaders(cfg_j, 1, train=False)
    step_j = step_jax.make_eval_step(
        get_pose_net_jax(cfg_j, dtype=jnp.float32), cfg_j, mesh, True, perm,
        prepare=step_jax.make_batch_preprocessor(cfg_j))
    preds_j = [np.concatenate([np.asarray(o["preds"]),
                               np.asarray(o["maxvals"])[..., None]], -1)
               for o in (step_j(variables, common_jax.device_batch(
                   cfg_j, b, mesh, for_eval=True)) for b in val_j)]

    _, val_t, meta = common.build_loaders(cfg_t, train=False)
    model = get_pose_net(cfg_t)
    model.load_state_dict(state_dict_from_jax(cfg_t, variables))
    step_t = make_eval_step(cfg_t, perm, prepare=make_batch_preprocessor(
        cfg_t))
    batches = list(val_t)
    assert [int(b["valid"].sum()) for b in batches] == [12, 12, 8]
    outs = [step_t(model, common.device_batch(cfg_t, b, torch.device("cpu"),
                                              for_eval=True))
            for b in batches]
    preds_t = [torch.cat([o["preds"], o["maxvals"][..., None]], -1).numpy()
               for o in outs]
    preds_t, preds_j = (np.concatenate(p)[:N] for p in (preds_t, preds_j))
    np.testing.assert_allclose(preds_t[..., :2], preds_j[..., :2], rtol=0,
                               atol=1e-3)

    nv, perf = common.make_evaluate_fn(cfg_t, device="cpu")(
        cfg_t, preds_t, None, None, None)
    nv_j, perf_j = common_jax.make_evaluate_fn(cfg_j)(cfg_j, preds_j, None,
                                                      None, None)
    assert list(nv) == list(nv_j)
    np.testing.assert_allclose(list(nv.values()), list(nv_j.values()),
                               rtol=0, atol=1e-9)
    assert meta["num_joints"] == 16 and np.isfinite(perf) and perf == \
        pytest.approx(perf_j, abs=1e-9)
    val_t.close()
    val_j.close()
