"""The port stands without JAX, cv2 or PIL, and its copies of fhpe_tpu's
host code (config, affine geometry, dataset constants, host NMS, COCO glue
and evaluator, MPII PCKh, the LR schedule, the host data path: db
builders, filters, loader, zip reader, the warp's C text) stay equal to
the originals."""

import ast
import copy
import glob
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import fhpe_tpu.data as data_jax
from fhpe_tpu import config as config_jax
from fhpe_tpu.cli import common as common_jax
from fhpe_tpu.data import coco as coco_jax
from fhpe_tpu.data import dataset_meta as dataset_meta_jax
from fhpe_tpu.data import filters as filters_jax
from fhpe_tpu.data import loader as loader_jax
from fhpe_tpu.data import mpii as mpii_jax
from fhpe_tpu.eval import coco_eval as coco_eval_jax
from fhpe_tpu.geometry import affine as affine_jax
from fhpe_tpu.geometry import flip as flip_jax
from fhpe_tpu.geometry import targets as targets_jax
from fhpe_tpu.ops import decode as decode_jax
from fhpe_tpu.ops import native_image as native_image_jax
from fhpe_tpu.ops import nms as nms_jax
from fhpe_tpu.train import state as state_jax
from fhpe_tpu.config import node as node_jax
from fhpe_tpu.utils import logger as logger_jax
from fhpe_tpu.utils import torch_import as torch_import_jax
from fhpe_tpu.utils import zipreader as zipreader_jax
import fhpe_tpu_torch.data as data
from fhpe_tpu_torch import config
from fhpe_tpu_torch.cli import common
from fhpe_tpu_torch.data import coco, dataset_meta, filters, loader, mpii
from fhpe_tpu_torch.eval import coco_eval
from fhpe_tpu_torch.geometry import affine, flip, targets
from fhpe_tpu_torch.ops import decode, native_image, nms
from fhpe_tpu_torch.train import state
from fhpe_tpu_torch.utils import logger, pretrained, zipreader

from torch_threads import child_env, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "experiments", "**", "*.yaml"), recursive=True))


def shared(d: dict) -> dict:
    """A config dict less the keys only the port's schema has
    (``config.PORT_ONLY``)."""
    d = copy.deepcopy(d)
    for group, keys in config.PORT_ONLY.items():
        for k in keys:
            d[group].pop(k)
    return d


def test_port_imports_no_jax():
    """In a fresh interpreter (this one already holds JAX via conftest),
    with ``FHPE_PLATFORM`` set: ``import fhpe_tpu`` imports JAX then, so
    the port must not touch the JAX package at all, nor the probes under
    ``scripts/`` whose kernels it ports (P4, P5).  Every module of the
    port is imported (found by walking the package), and ``chip_smoke.py``
    by its path, without running its ``main``."""
    code = ("import importlib, importlib.util, pkgutil, sys\n"
            "import fhpe_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "fhpe_tpu_torch.__path__, 'fhpe_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "spec = importlib.util.spec_from_file_location("
            "'chip_smoke', 'chip_smoke.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "fhpe_tpu_torch.config.load_config("
            "'experiments/coco/hrnet/w32_256x192_adam_lr1e-3.yaml')\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'fhpe_tpu', "
            "'scripts', 'fused_block', 'fused_block_kernels', "
            "'dw_pallas_probe', 'cv2', 'PIL', 'msgpack'))\n"
            "assert not bad, bad\n"
            "assert 'fhpe_tpu_torch.parallel.mesh' in names\n"
            "assert 'fhpe_tpu_torch.tools.ddp_parity' in names\n"
            "assert 'fhpe_tpu_torch.utils.vis' in names\n"
            "assert 'fhpe_tpu_torch.utils.summary' in names\n"
            "print(len(names))\n")
    env = child_env(dict(os.environ, FHPE_PLATFORM="cpu"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the port, the CLI slice's cli/train.py,
    # cli/fpd_train.py, cli/test.py and utils/{checkpoint,logger,
    # pretrained}.py among them, and the data-parallel slice's
    # parallel/{__init__,mesh}.py and tools/ddp_parity.py, and the last
    # module slice's utils/{vis,summary}.py
    assert int(proc.stdout.split()[-1]) >= 67, proc.stdout


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_config_copy_equal(path):
    """Equal on every key both schemas have (the port's own keys,
    ``config.PORT_ONLY``, are set by no file of ``experiments/``)."""
    path = os.path.join(REPO, path)
    got = shared(config.load_config(path).to_dict())
    assert got == config_jax.load_config(path).to_dict()


def test_config_defaults_and_overrides_equal():
    """The port's defaults are ``fhpe_tpu``'s plus its own keys, whose
    defaults leave a run as it was (no layer decay, no clipping), and its
    own models' EXTRA."""
    defaults = config.get_default_config().to_dict()
    assert shared(defaults) == config_jax.get_default_config().to_dict()
    assert defaults["TRAIN"]["LAYER_DECAY"] == 1.0
    assert defaults["TRAIN"]["CLIP_GRAD_NORM"] == 0.0
    assert config.MODEL_EXTRAS.keys() - set(config.PORT_ONLY_MODELS) == \
        config_jax.MODEL_EXTRAS.keys()
    for name, make in config.MODEL_EXTRAS.items():
        if name not in config.PORT_ONLY_MODELS:
            assert make().to_dict() == \
                config_jax.MODEL_EXTRAS[name]().to_dict()
    path = os.path.join(REPO, "experiments/mpii/hourglass/"
                        "hg4_128_student.yaml")
    opts = ["TEST.FLIP_TEST", "True", "GPUS", "(0,1)",
            "TPU.COMPUTE_DTYPE", "float32", "MODEL.IMAGE_SIZE", "[128,256]"]
    got = config.load_config(path, opts, data_dir="data")
    assert shared(got.to_dict()) == config_jax.load_config(
        path, opts, data_dir="data").to_dict()
    assert got.is_frozen()
    with pytest.raises(KeyError):
        config.load_config(path, ["TEST.NO_SUCH_KEY", "1"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_affine_copy_bit_equal(dtype):
    rng = np.random.RandomState(0)
    for _ in range(200):
        center = rng.uniform(0, 640, 2).astype(dtype)
        scale = rng.uniform(0.3, 3.0, 2).astype(dtype)
        rot = float(rng.uniform(-45, 45))
        size = (int(rng.choice([48, 64, 192, 256])),
                int(rng.choice([64, 256, 384])))
        for inv in (False, True):
            np.testing.assert_array_equal(
                affine.get_affine_transform(center, scale, rot, size, inv=inv),
                affine_jax.get_affine_transform(center, scale, rot, size,
                                                inv=inv))
        t = affine.get_affine_transform(center, scale, rot, size)
        pts = rng.uniform(0, 64, (17, 2))
        np.testing.assert_array_equal(affine.affine_transform(pts[0], t),
                                      affine_jax.affine_transform(pts[0], t))
        np.testing.assert_array_equal(
            affine.transform_preds(pts, center, scale, size),
            affine_jax.transform_preds(pts, center, scale, size))


def test_affine_solve_equals_cv2():
    """``_solve_affine`` replays ``cv2.getAffineTransform`` bit for bit:
    random triangles at several magnitudes, and a singular one."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    for i in range(1000):
        src = rng.normal(300, 200, (3, 2)) * (1e-3, 1.0, 1e3)[i % 3]
        dst = rng.uniform(-50, 300, (3, 2))
        np.testing.assert_array_equal(
            affine._solve_affine(src, dst),
            cv2.getAffineTransform(src.astype(np.float32),
                                   dst.astype(np.float32)))
    line = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]])
    np.testing.assert_array_equal(affine._solve_affine(line, line),
                                  np.zeros((2, 3)))


@pytest.mark.parametrize("name", ["mpii", "coco", "synthetic"])
def test_dataset_meta_copy_equal(name):
    got, ref = dataset_meta(name), dataset_meta_jax(name)
    assert got.keys() == ref.keys() == {
        "num_joints", "flip_pairs", "upper_body_ids", "lower_body_ids",
        "joints_weight"}
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(KeyError):
        dataset_meta("lsp")


def _same_source(port_obj, ref_obj):
    assert inspect.getsource(port_obj) == inspect.getsource(ref_obj), \
        port_obj.__qualname__


@pytest.mark.parametrize("name", ["nms", "oks_iou", "oks_nms", "_rescore",
                                  "soft_oks_nms"])
def test_host_nms_copy_equal(name):
    """``ops/nms.py`` is a copy: the same source, the same sigmas, and the
    same keep-lists on random detections."""
    _same_source(getattr(nms, name), getattr(nms_jax, name))
    np.testing.assert_array_equal(nms.COCO_SIGMAS, nms_jax.COCO_SIGMAS)
    rng = np.random.RandomState(0)
    db = [{"keypoints": rng.uniform(0, 200, (17, 3)), "area":
           rng.uniform(1e3, 1e4), "score": rng.uniform()} for _ in range(12)]
    for k in db[::3]:
        k["keypoints"] = db[0]["keypoints"] + rng.normal(0, 1, (17, 3))
    assert nms.oks_nms(db, 0.5) == nms_jax.oks_nms(db, 0.5)
    assert nms.soft_oks_nms(db, 0.5) == nms_jax.soft_oks_nms(db, 0.5)


@pytest.mark.parametrize("name", ["CocoIndex", "xywh2cs",
                                  "write_results_json",
                                  "image_path_from_index", "_ann_file",
                                  "build_gt_db", "build_detection_db"])
def test_coco_host_copy_equal(name):
    """The host parts of ``data/coco.py`` are copies; ``rescore_and_nms``
    differs only in running its hard NMS through ``oks_nms_device``
    (held equal in tests/test_torch_coco_eval.py)."""
    _same_source(getattr(coco, name), getattr(coco_jax, name))
    assert coco.NUM_JOINTS == coco_jax.NUM_JOINTS
    for const in ("FLIP_PAIRS", "UPPER_BODY_IDS", "LOWER_BODY_IDS",
                  "JOINTS_WEIGHT"):
        np.testing.assert_array_equal(getattr(coco, const),
                                      getattr(coco_jax, const))
    for box in ([10, 20, 30, 90], [0, 0, 200, 50], [5.5, 6, 48, 64]):
        for got, ref in zip(coco.xywh2cs(*box, 0.75),
                            coco_jax.xywh2cs(*box, 0.75)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["_dt_area_bbox", "compute_oks",
                                  "_evaluate_img", "_accumulate",
                                  "CocoKeypointEval"])
def test_coco_eval_copy_equal(name):
    """``eval/coco_eval.py`` is a copy: the same source and constants."""
    _same_source(getattr(coco_eval, name), getattr(coco_eval_jax, name))
    for const in ("OKS_THRS", "RECALL_THRS", "AREA_RNGS", "MAX_DETS",
                  "STATS_NAMES"):
        np.testing.assert_array_equal(getattr(coco_eval, const),
                                      getattr(coco_eval_jax, const))


def test_mpii_eval_copy_equal():
    """``data/mpii.py`` is a copy of ``build_db``, ``evaluate`` and their
    constants."""
    _same_source(mpii.evaluate, mpii_jax.evaluate)
    _same_source(mpii.build_db, mpii_jax.build_db)
    for const in ("NUM_JOINTS", "FLIP_PAIRS", "JOINT_NAMES", "PARENT_IDS",
                  "UPPER_BODY_IDS", "LOWER_BODY_IDS",
                  "PCKH_HEADSIZE_BIAS", "PCKH_THRESHOLD", "PCKH_EXCLUDED",
                  "PCKH_AT_01_BIN", "PCKH_SUMMARY_GROUPS"):
        assert getattr(mpii, const) == getattr(mpii_jax, const), const


def test_lr_schedule_copy_equal():
    _same_source(state.lr_for_epoch, state_jax.lr_for_epoch)


# the host data path: (port object, fhpe_tpu object) pinned by source
DATA_PATH_COPIES = {
    "select_data": (filters.select_data, filters_jax.select_data),
    "dataset_meta": (data.dataset_meta, data_jax.dataset_meta),
    "build_db": (data.build_db, data_jax.build_db),
    "_build_db_raw": (data._build_db_raw, data_jax._build_db_raw),
    "fliplr_joints": (flip.fliplr_joints, flip_jax.fliplr_joints),
    "generate_target_np": (targets.generate_target_np,
                           targets_jax.generate_target_np),
    "_jpeg_dims_fast": (native_image._jpeg_dims_fast,
                        native_image_jax._jpeg_dims_fast),
    **{f"zipreader.{n}": (getattr(zipreader, n), getattr(zipreader_jax, n))
       for n in ("split_path", "_get_zip", "read_bytes", "xmlread")},
    **{f"loader.{n}": (getattr(loader, n), getattr(loader_jax, n))
       for n in ("_return_cache_bytes", "half_body_transform",
                 "compose_mirror", "collate", "BatchLoader")},
    **{f"PoseDataSource.{n}": (getattr(loader.PoseDataSource, n),
                               getattr(loader_jax.PoseDataSource, n))
       for n in ("_cache_reserve", "_cache_put", "__len__",
                 "draw_augment_params")},
    **{f"common.{n}": (getattr(common, n), getattr(common_jax, n))
       for n in ("train_batch_keys", "eval_batch_transform")},
}


@pytest.mark.parametrize("name", sorted(DATA_PATH_COPIES))
def test_data_path_copy_equal(name):
    _same_source(*DATA_PATH_COPIES[name])


# what the CLIs take from fhpe_tpu: (port object, fhpe_tpu object)
CLI_COPIES = {
    **{f"logger.{n}": (getattr(logger, n), getattr(logger_jax, n))
       for n in ("create_logger", "AverageMeter", "WindowedMeters",
                 "print_name_value", "save_config_yaml")},
    "common.load_cfg_from_args": (common.load_cfg_from_args,
                                  common_jax.load_cfg_from_args),
    "CfgNode.dump_yaml": (config.CfgNode.dump_yaml,
                          node_jax.CfgNode.dump_yaml),
    "filter_pretrained_layers": (pretrained.filter_pretrained_layers,
                                 torch_import_jax.filter_pretrained_layers),
    # the debug images' host argmax (utils/vis.py)
    "decode.get_max_preds": (decode.get_max_preds, decode_jax.get_max_preds),
}


@pytest.mark.parametrize("name", sorted(CLI_COPIES))
def test_cli_copy_equal(name):
    _same_source(*CLI_COPIES[name])


def _warp_text(path):
    """``fhpe_warp_affine_u8``'s text, signature to closing brace."""
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    start = src.index("void fhpe_warp_affine_u8(")
    return src[start:src.index("\n}\n", start) + 3]


def test_warp_c_text_equal():
    assert _warp_text("fhpe_tpu_torch/ops/cpp/imagedec.cpp") == \
        _warp_text("fhpe_tpu/ops/cpp/imagedec.cpp")
    assert native_image_jax._SOF_MARKERS == native_image._SOF_MARKERS


def _sources_importing(*modules):
    """(number of port sources and ``chip_smoke.py``, those of them with
    an ``import`` of one of ``modules`` anywhere)."""
    paths = glob.glob(os.path.join(REPO, "fhpe_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(modules),
                         re.M)
    return len(paths), [os.path.relpath(p, REPO) for p in paths
                        if pattern.search(open(p).read())]


@pytest.mark.parametrize("modules", [
    # the card's machine may have neither
    ("cv2", "PIL"),
    # fhpe_tpu's weight files are read and written by the port's own
    # utils/msgpack.py: nobody has seen the msgpack package on the card's
    # machine, and flax is JAX's
    ("msgpack", "flax")], ids="-".join)
def test_port_sources_import_none_of(modules):
    """Not at import time (``test_port_imports_no_jax``) and not inside a
    function either."""
    n, found = _sources_importing(*modules)
    assert n > 50 and not found, found


PORT_TESTS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "tests", "test_torch_*.py")))


@pytest.mark.parametrize("name", PORT_TESTS)
def test_port_test_takes_the_shared_thread_cap(name):
    """Every port test module takes ``tests/torch_threads.py``'s fixture by
    a top-level import and sets torch's thread count nowhere itself."""
    tree = ast.parse(open(os.path.join(REPO, "tests", name)).read())
    takes = any(isinstance(n, ast.ImportFrom) and n.module == "torch_threads"
                and "torch_threads" in {a.name for a in n.names}
                for n in tree.body)
    own = [n.lineno for n in ast.walk(tree)
           if isinstance(n, (ast.Attribute, ast.Name))
           and getattr(n, "attr", getattr(n, "id", None)) ==
           "set_num_threads"]
    assert takes, f"{name} does not import torch_threads.torch_threads"
    assert not own, f"{name} sets torch's threads itself at lines {own}"


def test_the_cap_holds_inside_a_module():
    import torch
    from torch_threads import THREADS
    assert len(PORT_TESTS) >= 33
    assert torch.get_num_threads() == THREADS
    assert child_env({})["OMP_NUM_THREADS"] == str(THREADS)
