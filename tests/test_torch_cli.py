"""The port's CLIs (``fhpe_tpu_torch.cli.train``, ``fpd_train``, ``test``)
on the CPU, and its checkpoints.

* CLI against CLI: ``fhpe_tpu_torch.cli.train.main`` (float64, in this
  process) against ``fhpe_tpu.cli.train.main`` (float64, in a subprocess
  through ``tests/epoch_loop_child.py ours``) on one YAML, one synthetic
  MPII root and one init, 3 epochs across an LR milestone: the same
  per-epoch LR, PCKh and best-checkpoint decisions, and final weights
  within the float64 Adam envelope of ``tests/test_epoch_loop_parity.py``.
* The port alone: train -> test on the ``synthetic`` dataset, what the
  CLIs refuse (and ``DEBUG.DEBUG``'s dumps and the summary lines, which
  replaced its refusal), every experiment YAML accepted, AUTO_RESUME, ``EVAL_FREQ`` / ``CKPT_FREQ``, the weight
  file layouts ``load_model_weights`` reads, the checkpoint writer, and
  the FPD CLI with its teacher from a ``.pth``; ``fhpe_tpu``'s ``.msgpack``
  weight files (written here by flax) as ``TEST.MODEL_FILE``,
  ``KD.TEACHER`` and ``TRAIN.CHECKPOINT``.

The FPD step itself is held against ``fhpe_tpu`` by
``tests/test_torch_train.py``.
"""

import glob
import json
import logging
import os
import re
import subprocess
import sys
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from fhpe_tpu_torch.cli import common
from fhpe_tpu_torch.cli import fpd_train as fpd_cli
from fhpe_tpu_torch.cli import test as test_cli
from fhpe_tpu_torch.cli import train as train_cli
from fhpe_tpu_torch.config import load_config
from fhpe_tpu_torch.data import make_synthetic_mpii
from fhpe_tpu_torch.models import get_pose_net, param_count
from fhpe_tpu_torch.ops import native_image
from fhpe_tpu_torch.train import create_train_state
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils.convert import variables_from_state_dict

from torch_threads import child_env, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "epoch_loop_child.py")
EXPERIMENTS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "experiments", "**", "*.yaml"), recursive=True))
HG = {"NAME": "hourglass", "NUM_JOINTS": 16, "IMAGE_SIZE": [64, 64],
      "HEATMAP_SIZE": [16, 16], "SIGMA": 2, "PRETRAINED": "",
      "INIT_WEIGHTS": False, "TARGET_TYPE": "gaussian",
      "EXTRA": {"NUM_FEATURES": 16, "NUM_STACKS": 1, "NUM_BLOCKS": 1}}


def _write_yaml(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _synthetic_cfg(tmp_path, **over):
    """test_cli.py's hermetic config (the ``synthetic`` dataset: 8 train
    images, 2 steps of 4 per epoch; 4 validation images), a 16-feature
    hourglass, float32, DEBUG off."""
    cfg = {
        "OUTPUT_DIR": str(tmp_path / "out"),
        "LOG_DIR": str(tmp_path / "log"),
        "PRINT_FREQ": 2,
        "AUTO_RESUME": True,
        "DATASET": {"DATASET": "synthetic", "ROOT": str(tmp_path / "data"),
                    "TEST_SET": "valid", "TRAIN_SET": "train",
                    "SYNTH_SIZE": 8},
        "MODEL": HG,
        "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "END_EPOCH": 1, "LR": 0.001},
        "TEST": {"BATCH_SIZE_PER_GPU": 4, "FLIP_TEST": True,
                 "POST_PROCESS": True, "SHIFT_HEATMAP": True},
        "TPU": {"COMPUTE_DTYPE": "float32"},
        "DEBUG": {"DEBUG": False},
    }
    for k, v in over.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    return _write_yaml(tmp_path / "cfg.yaml", cfg)


def _run_dir(tmp_path, dataset="synthetic"):
    (run,) = (tmp_path / "out" / dataset / "hourglass").iterdir()
    return run


@contextmanager
def _recorded(module, *names):
    """Wrap ``module``'s functions ``names`` (they stay functional): yields
    {name: [(args, kwargs, result), ...]}."""
    calls = {n: [] for n in names}
    patches = []
    for n in names:
        orig = getattr(module, n)

        def rec(*a, _orig=orig, _n=n, **k):
            r = _orig(*a, **k)
            calls[_n].append((a, k, r))
            return r
        patches.append(mock.patch.object(module, n, rec))
    for p in patches:
        p.start()
    try:
        yield calls
    finally:
        for p in patches:
            p.stop()


# -- CLI against CLI -----------------------------------------------------------

def _parity_yaml(tmp_path, root):
    """``tests/test_epoch_loop_parity.py::_shared_yaml``'s keys, plus the
    native decode and warp, with which the port's batches equal
    ``fhpe_tpu``'s bit for bit."""
    cfg = {
        "AUTO_RESUME": False, "GPUS": "(0,)", "OUTPUT_DIR": "output",
        "LOG_DIR": "log", "WORKERS": 0, "PRINT_FREQ": 1,
        "DATASET": {
            "CACHE_ROOT": str(tmp_path / "db_cache"),
            "COLOR_RGB": False, "DATASET": "mpii", "DATA_FORMAT": "jpg",
            "FLIP": False, "NUM_JOINTS_HALF_BODY": 8, "PROB_HALF_BODY": -1.0,
            "ROOT": root, "ROT_FACTOR": 0, "SCALE_FACTOR": 0.0,
            "TEST_SET": "valid", "TRAIN_SET": "train"},
        "MODEL": HG,
        "LOSS": {"USE_TARGET_WEIGHT": True},
        "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "SHUFFLE": False,
                  "BEGIN_EPOCH": 0, "END_EPOCH": 3, "OPTIMIZER": "adam",
                  "LR": 0.001, "LR_FACTOR": 0.1, "LR_STEP": [2]},
        "TEST": {"BATCH_SIZE_PER_GPU": 4, "FLIP_TEST": False,
                 "POST_PROCESS": True, "SHIFT_HEATMAP": False,
                 "USE_GT_BBOX": True},
        "DEBUG": {"DEBUG": False},
        "TPU": {"NATIVE_DECODE": True, "NATIVE_WARP": True},
    }
    return _write_yaml(tmp_path / "epoch_loop.yaml", cfg)


def _start_jax_child(args):
    """``epoch_loop_child.py ours`` in a subprocess (it enables JAX's
    x64), started before the port's run so that the two overlap."""
    env = child_env({k: v for k, v in os.environ.items()
                     if not k.startswith(("JAX_", "XLA_"))})
    env.update(JAX_COMPILATION_CACHE_DIR=os.environ[
        "JAX_COMPILATION_CACHE_DIR"], FHPE_PLATFORM="cpu", FHPE_DUMP_HLO="0")
    return subprocess.Popen([sys.executable, CHILD, "ours", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _child_result(proc):
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, (f"stdout:\n{out[-4000:]}\n"
                                  f"stderr:\n{err[-4000:]}")
    for line in out.splitlines():
        if line.startswith("EPOCH_LOOP_RESULT "):
            return json.loads(line[len("EPOCH_LOOP_RESULT "):])
    raise AssertionError(f"no result line in child stdout:\n{out}")


def test_train_cli_against_fhpe_tpu(tmp_path):
    from flax import serialization

    from fhpe_tpu_torch.utils.convert import state_dict_from_jax

    root = str(tmp_path / "mpii")
    make_synthetic_mpii(root, "train", 8, (128, 128), seed=5)
    make_synthetic_mpii(root, "valid", 8, (128, 128), seed=6)
    cfg_yaml = _parity_yaml(tmp_path, root)
    cfg = load_config(cfg_yaml)
    torch.manual_seed(31)
    sd0 = str(tmp_path / "init_sd.pth")
    torch.save(get_pose_net(cfg).double().state_dict(), sd0)

    child = _start_jax_child([cfg_yaml, sd0, str(tmp_path / "jax_out"),
                              str(tmp_path / "jax_log"), root,
                              str(tmp_path / "warm.msgpack")])
    try:
        with _recorded(train_cli, "set_lr", "validate",
                       "save_checkpoint") as c:
            train_cli.main(["--cfg", cfg_yaml, "--device", "cpu",
                            "OUTPUT_DIR", str(tmp_path / "out"),
                            "LOG_DIR", str(tmp_path / "log"),
                            "DATASET.CACHE_ROOT", str(tmp_path / "db_port"),
                            "TPU.COMPUTE_DTYPE", "float64",
                            "TRAIN.CHECKPOINT", sd0])
    except BaseException:
        child.kill()
        child.communicate()
        raise
    ref = _child_result(child)
    ours = {"lr": [a[1] for a, _, _ in c["set_lr"]],
            "perf": [r[0] for _, _, r in c["validate"]],
            "best": [a[4] for a, _, _ in c["save_checkpoint"]]}

    assert len(ours["lr"]) == len(ref["lr"]) == 3
    np.testing.assert_allclose(ours["lr"], ref["lr"], rtol=1e-12)
    assert len(ours["perf"]) == len(ref["perf"]) == 3
    # PCKh Mean bins are >= 0.4 apart here: 1e-9 means the same binning
    np.testing.assert_allclose(ours["perf"], ref["perf"], rtol=0, atol=1e-9)
    assert ours["best"] == ref["best"]

    with open(ref["final_state"], "rb") as f:
        jax_final = state_dict_from_jax(
            cfg, serialization.msgpack_restore(f.read()))
    our_final = torch.load(_run_dir(tmp_path, "mpii") / ck.FINAL_NAME)
    assert our_final.keys() == jax_final.keys()
    # 6 float64 Adam steps: the envelope of test_epoch_loop_parity.py
    # (reduction-order noise amplified by Adam; a wiring bug moves the
    # weights by ~lr * steps = 6e-3)
    dev = max(float((our_final[k].double() - jax_final[k].double()).abs()
                    .max()) for k in our_final
              if not k.endswith("num_batches_tracked"))
    assert dev < 1e-3, dev


# -- the port alone --------------------------------------------------------------

def test_train_then_test_cli(tmp_path, monkeypatch):
    """The run dir's files; the test CLI on ``final_state.pth`` gives the
    last validation's perf and predictions; FHPE_PROFILE_DIR writes a
    trace with the step's spans (a short epoch: 3 steps)."""
    monkeypatch.setenv("FHPE_PROFILE_DIR", str(tmp_path / "prof"))
    cfg_path = _synthetic_cfg(tmp_path, DATASET={"SYNTH_SIZE": 12})
    with _recorded(train_cli, "validate") as c:
        train_cli.main(["--cfg", cfg_path, "--device", "cpu"])
    run = _run_dir(tmp_path)
    for name in (ck.CKPT_NAME, ck.BEST_NAME, ck.FINAL_NAME, ck.META_NAME,
                 "config.yaml"):
        assert (run / name).exists(), name
    assert not [f for f in os.listdir(run) if f.endswith(".tmp")]
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "fhpe.train.step"
               for e in trace["traceEvents"])
    assert json.loads((run / ck.META_NAME).read_text())["epoch"] == 1
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert {"epoch", "model", "state_dict", "best_state_dict", "perf",
            "optimizer", "step"} <= saved.keys()
    assert saved["model"] == "hourglass" and saved["step"] == 3

    with _recorded(test_cli, "validate") as t:
        perf = test_cli.main(["--cfg", cfg_path, "--device", "cpu",
                              "TEST.MODEL_FILE", str(run / ck.FINAL_NAME)])
    last, again = c["validate"][-1][2], t["validate"][0][2]
    assert perf == last[0]
    np.testing.assert_array_equal(again[2], last[2])    # all_preds


def _weight_files(tmp_path, cfg, seed):
    """A seeded model of ``cfg`` and its weights as a ``.pth`` and as the
    ``.msgpack`` fhpe_tpu writes at the end of a run (flax's
    ``{"params", "batch_stats"}``)."""
    torch.manual_seed(seed)
    model = get_pose_net(cfg)
    pth = str(tmp_path / "weights.pth")
    ck.save_weights(pth, model)
    mp = str(tmp_path / "final_state.msgpack")
    with open(mp, "wb") as f:
        f.write(serialization.msgpack_serialize(
            variables_from_state_dict(cfg, model.state_dict())))
    return model, pth, mp


def test_test_cli_on_msgpack(tmp_path):
    """``cli.test`` with ``TEST.MODEL_FILE`` the ``.msgpack`` of a model
    reproduces the run on its ``.pth``: perf and predictions exactly."""
    cfg_path = _synthetic_cfg(tmp_path)
    _, pth, mp = _weight_files(tmp_path, load_config(cfg_path), seed=11)
    with _recorded(test_cli, "validate") as t:
        perfs = [test_cli.main(["--cfg", cfg_path, "--device", "cpu",
                                "TEST.MODEL_FILE", path])
                 for path in (pth, mp)]
    assert perfs[0] == perfs[1] and np.isfinite(perfs[0])
    (_, _, a), (_, _, b) = t["validate"]
    np.testing.assert_array_equal(a[2], b[2])               # all_preds


@pytest.mark.parametrize("key", ["KD.TEACHER", "TRAIN.CHECKPOINT"])
def test_msgpack_teacher_and_warm_start(tmp_path, key):
    """``KD.TEACHER`` (``fpd_train.load_teacher``, mapped by the teacher's
    config) and ``TRAIN.CHECKPOINT`` (``train.warm_start``) take a
    ``.msgpack``: the model's weights exactly."""
    cfg = load_config(_synthetic_cfg(tmp_path))
    model, _, mp = _weight_files(tmp_path, cfg, seed=12)
    cfg.defrost()
    cfg.KD.TEACHER = cfg.TRAIN.CHECKPOINT = mp
    cfg.freeze()
    if key == "KD.TEACHER":
        got = fpd_cli.load_teacher(cfg, cfg, torch.device("cpu"))
    else:
        state = create_train_state(cfg, seed=0, device="cpu")
        got = train_cli.warm_start(cfg, state,
                                   logging.getLogger(__name__)).model
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got.state_dict()[k], v), k


def _fpd_yamls(tmp_path, root, teacher_features=32):
    base = {
        "OUTPUT_DIR": str(tmp_path / "out"), "LOG_DIR": str(tmp_path / "log"),
        "PRINT_FREQ": 1, "WORKERS": 2,
        "DATASET": {"DATASET": "mpii", "ROOT": root, "TRAIN_SET": "train",
                    "TEST_SET": "valid", "CACHE_ROOT": "", "FLIP": False,
                    "ROT_FACTOR": 0, "SCALE_FACTOR": 0.0},
        "MODEL": HG,
        "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "END_EPOCH": 1, "LR": 0.001,
                  "SHUFFLE": False},
        "TEST": {"BATCH_SIZE_PER_GPU": 4, "FLIP_TEST": True,
                 "POST_PROCESS": True, "SHIFT_HEATMAP": True},
        "TPU": {"COMPUTE_DTYPE": "float32"},
        "DEBUG": {"DEBUG": False},
        "KD": {"TRAIN_TYPE": "FPD", "ALPHA": 0.5},
    }
    teacher = {**base, "MODEL": {**HG, "EXTRA": {
        **HG["EXTRA"], "NUM_FEATURES": teacher_features}}}
    return (_write_yaml(tmp_path / "student.yaml", base),
            _write_yaml(tmp_path / "teacher.yaml", teacher))


@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpii")
    make_synthetic_mpii(str(root), "train", 8, (96, 96), seed=1)
    make_synthetic_mpii(str(root), "valid", 6, (96, 96), seed=2)
    return str(root)


def test_fpd_cli(tmp_path, mpii_root):
    """One epoch of FPD with the teacher from a ``.pth``: both models
    validated before training, one validation after the epoch, and the
    teacher's pre-training perf equal to the test CLI on the same file."""
    scfg, tcfg = _fpd_yamls(tmp_path, mpii_root)
    torch.manual_seed(7)
    teacher_pth = str(tmp_path / "teacher.pth")
    ck.save_weights(teacher_pth, get_pose_net(load_config(tcfg)))
    with _recorded(fpd_cli, "validate") as c:
        fpd_cli.main(["--cfg", scfg, "--tcfg", tcfg, "--device", "cpu",
                      "KD.TEACHER", teacher_pth])
    models = [a[1] for a, _, _ in c["validate"]]
    assert len(models) == 3
    # the teacher (32 features, a 8-channel stem) first, then the student
    # (16 features) before training and after its epoch
    assert [m.conv1.out_channels for m in models] == [8, 4, 4]
    assert not models[0].training and not any(
        p.requires_grad for p in models[0].parameters())
    run = _run_dir(tmp_path, "mpii")
    for name in (ck.CKPT_NAME, ck.FINAL_NAME, "config.yaml",
                 "teacher_config.yaml"):
        assert (run / name).exists(), name
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert saved["step"] == 2 and saved["epoch"] == 1

    tperf = c["validate"][0][2][0]
    alone = test_cli.main(["--cfg", tcfg, "--device", "cpu",
                           "TEST.MODEL_FILE", teacher_pth])
    assert alone == tperf and np.isfinite(tperf)


REFUSALS = {
    "test_model_file": (test_cli, ["TEST.MODEL_FILE", "nope.pth"],
                        SystemExit, "model file not found"),
    "train_checkpoint": (train_cli, ["TRAIN.CHECKPOINT", "nope.pth"],
                         SystemExit, "TRAIN.CHECKPOINT not found"),
    "fpd_train_type": (fpd_cli, ["KD.TRAIN_TYPE", "NORMAL"], SystemExit,
                       "KD.TRAIN_TYPE must be 'FPD'"),
    "fpd_teacher": (fpd_cli, ["KD.TEACHER", "nope.pth"], SystemExit,
                    "KD.TEACHER checkpoint not found"),
}
# DEBUG.DEBUG was refused until the debug images were ported; these cases
# now run the CLI with it on (_debug_run)
DEBUG_RUNS = {"train_debug": train_cli, "test_debug": test_cli}
DUMPS = ("gt", "pred", "hm_gt", "hm_pred")


def _debug_run(tmp_path, caplog, module):
    """The tiny synthetic run with every ``DEBUG.*`` flag on and
    ``PRINT_FREQ`` 1: the ``train_0_{i}`` dumps of both steps (train) and
    the ``val_{i}`` dumps of every validation batch, each decoding at its
    grid's shape (4 samples of 64x64 in one row; 16 joints of 16x16
    heatmaps), the TensorBoard images of train's validation, and the
    summary lines: the model's parameters and its FLOPs."""
    cfg_path = _synthetic_cfg(tmp_path, PRINT_FREQ=1, DEBUG={
        "DEBUG": True, "SAVE_BATCH_IMAGES_GT": True,
        "SAVE_BATCH_IMAGES_PRED": True, "SAVE_HEATMAPS_GT": True,
        "SAVE_HEATMAPS_PRED": True})
    cfg = load_config(cfg_path)
    argv = ["--cfg", cfg_path, "--device", "cpu"]
    if module is test_cli:
        torch.manual_seed(3)
        ck.save_weights(str(tmp_path / "w.pth"), get_pose_net(cfg))
        argv += ["TEST.MODEL_FILE", str(tmp_path / "w.pth")]
    with caplog.at_level(logging.INFO), _recorded(
            common, "tb_log_images") as tb:
        module.main(argv)
    run = _run_dir(tmp_path)
    # the first batch of the validation that has a writer (train's, after
    # its epoch) goes to TensorBoard as 3 images
    writers = [a[0] for a, _, _ in tb["tb_log_images"] if a[0] is not None]
    if module is train_cli:
        assert len(writers) == 1
        (events,) = (tmp_path / "log").rglob("events.*")
        assert events.stat().st_size > 3 * 16 * 272
    else:
        assert not writers
    files = sorted(f for f in os.listdir(run) if f.endswith(".jpg"))
    prefixes = sorted({re.match(r"(.*?)_(hm_gt|hm_pred|gt|pred)\.jpg$",
                                f).group(1) for f in files})
    vals = [p for p in prefixes if p.startswith("val_")]
    trains = ["train_0_0", "train_0_1"] if module is train_cli else []
    assert vals and prefixes == sorted(trains + vals), files
    assert files == sorted(f"{p}_{s}.jpg" for p in prefixes for s in DUMPS)
    shapes = {"gt": (66, 4 * 66, 3), "pred": (66, 4 * 66, 3),
              "hm_gt": (4 * 16, 17 * 16, 3), "hm_pred": (4 * 16, 17 * 16, 3)}
    for p in prefixes:
        for s in DUMPS:
            assert native_image.imread(str(run / f"{p}_{s}.jpg")).shape \
                == shapes[s], (p, s)
    n = param_count(get_pose_net(cfg))
    assert f"Total Parameters: {n:,}" in caplog.text
    assert "Forward GFLOPs (batch=1, FlopCounterMode on a CPU copy" in \
        caplog.text


@pytest.mark.parametrize("case", sorted([*REFUSALS, *DEBUG_RUNS]))
def test_cli_refusals(tmp_path, caplog, case):
    """What the CLIs refuse, with its message; and ``DEBUG.DEBUG``, which
    they refused before the debug images were ported and now run."""
    if case in DEBUG_RUNS:
        _debug_run(tmp_path, caplog, DEBUG_RUNS[case])
        return
    module, opts, exc, match = REFUSALS[case]
    scfg, tcfg = _fpd_yamls(tmp_path, str(tmp_path / "none"))
    teacher = str(tmp_path / "t.pth")
    ck.save_weights(teacher, get_pose_net(load_config(tcfg)))
    argv = ["--cfg", scfg, "--device", "cpu"]
    if module is fpd_cli:
        argv = ["--cfg", scfg, "--tcfg", tcfg, "--device", "cpu",
                "KD.TEACHER", teacher]
    with pytest.raises(exc, match=match):
        module.main(argv + opts)


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_experiment_yaml_accepted(path):
    """Every YAML under ``experiments/`` as shipped (54 of the 65 set
    ``DEBUG.DEBUG``) passes the port's ``load_config`` and
    ``check_supported``."""
    common.check_supported(load_config(os.path.join(REPO, path)))


def test_check_supported_refuses_deconv_kernel_3():
    cfg = load_config(os.path.join(
        REPO, "experiments/coco/resnet/res50_256x192.yaml"),
        ["MODEL.EXTRA.NUM_DECONV_KERNELS", "[4,3,4]"])
    with pytest.raises(NotImplementedError, match="NUM_DECONV_KERNELS 3"):
        common.check_supported(cfg)


@pytest.mark.parametrize("module", [train_cli, test_cli, fpd_cli])
def test_cli_without_card_exits(tmp_path, module, monkeypatch):
    """``--device cuda`` (the default) with no card: a message and an
    exit, never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scfg, tcfg = _fpd_yamls(tmp_path, str(tmp_path / "none"))
    teacher = str(tmp_path / "t.pth")
    ck.save_weights(teacher, get_pose_net(load_config(tcfg)))
    argv = ["--cfg", scfg, "TEST.MODEL_FILE", teacher]
    if module is fpd_cli:
        argv = ["--cfg", scfg, "--tcfg", tcfg, "KD.TEACHER", teacher]
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        module.main(argv)


def _state_snapshot(state):
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "optimizer": ck._to_host(state.optimizer.state_dict()),
            "step": state.step}


def test_auto_resume(tmp_path, monkeypatch):
    """AUTO_RESUME after 1 of 2 epochs restores the epoch, the perf, the
    weights, Adam's moments and steps as saved; the resumed run goes on
    from there (its Adam steps continue from 2)."""
    # both runs in one run directory, whose default suffix is the launch
    # minute: a run crossing a minute would otherwise resume nothing
    monkeypatch.setenv("FHPE_RUN_TAG", "resume")
    cfg_path = _synthetic_cfg(tmp_path)
    saved = []
    orig = ck.save_checkpoint

    def snap(output_dir, state, epoch, perf, is_best, **k):
        saved.append((epoch, perf, _state_snapshot(state)))
        return orig(output_dir, state, epoch, perf, is_best, **k)

    with mock.patch.object(train_cli, "save_checkpoint", snap):
        train_cli.main(["--cfg", cfg_path, "--device", "cpu"])
    (epoch, perf, snapshot), = saved
    run = _run_dir(tmp_path)

    cfg = load_config(cfg_path)
    state = create_train_state(cfg, seed=123, device="cpu")
    state, got_epoch, got_perf = ck.auto_resume(str(run), state)
    assert (got_epoch, got_perf) == (epoch, perf) == (1, perf)
    assert state.step == snapshot["step"] == 2
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, snapshot["model"][k], rtol=0, atol=0)
    restored = state.optimizer.state_dict()["state"]
    assert restored.keys() == snapshot["optimizer"]["state"].keys()
    for i, s in snapshot["optimizer"]["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(restored[i][name], s[name], rtol=0,
                                       atol=0)

    with _recorded(train_cli, "set_lr") as c:
        train_cli.main(["--cfg", cfg_path, "--device", "cpu",
                        "TRAIN.END_EPOCH", "2"])
    assert len(c["set_lr"]) == 1                    # epoch 1 only
    final = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert final["epoch"] == 2 and final["step"] == 4
    assert {float(s["step"]) for s in final["optimizer"]["state"].values()
            } == {4.0}


def test_eval_and_ckpt_freq(tmp_path):
    """END_EPOCH 4, EVAL_FREQ 2, CKPT_FREQ 2: validation after epochs 2
    and 4 only, the rolling checkpoint at epoch 4 only; epoch 2's
    evaluation, a best, writes ``model_best`` alone."""
    cfg_path = _synthetic_cfg(tmp_path, AUTO_RESUME=False, TRAIN={
        "END_EPOCH": 4, "EVAL_FREQ": 2, "CKPT_FREQ": 2})
    with _recorded(train_cli, "validate", "save_checkpoint",
                   "save_best") as c:
        train_cli.main(["--cfg", cfg_path, "--device", "cpu"])
    assert [k["global_step"] for _, k, _ in c["validate"]] == [1, 3]
    assert [a[2] for a, _, _ in c["save_checkpoint"]] == [4]
    assert len(c["save_best"]) == 1
    run = _run_dir(tmp_path)
    assert json.loads((run / ck.META_NAME).read_text())["epoch"] == 4
    assert (run / ck.FINAL_NAME).exists()


def test_model_best_written_on_ckpt_skipped_eval(tmp_path):
    """EVAL_FREQ 1, CKPT_FREQ 4, END_EPOCH 2: epoch 1's evaluation sets a
    best whose rolling checkpoint is skipped, so ``model_best`` is written
    alone; the last epoch checkpoints."""
    cfg_path = _synthetic_cfg(tmp_path, AUTO_RESUME=False, TRAIN={
        "END_EPOCH": 2, "EVAL_FREQ": 1, "CKPT_FREQ": 4})
    with _recorded(train_cli, "save_checkpoint", "save_best") as c:
        train_cli.main(["--cfg", cfg_path, "--device", "cpu"])
    assert len(c["save_best"]) == 1
    assert [a[2] for a, _, _ in c["save_checkpoint"]] == [2]
    run = _run_dir(tmp_path)
    best = ck.load_model_weights(str(run / ck.BEST_NAME))
    assert best.keys() == torch.load(run / ck.FINAL_NAME).keys()


def _layout(kind, sd):
    if kind == "bare":
        return sd
    if kind == "state_dict":
        return {"epoch": 3, "state_dict": sd, "perf": 0.5}
    if kind == "best_state_dict":
        return {"best_state_dict": sd}
    module = {"module." + k: v for k, v in sd.items()}
    if kind == "module_prefix":
        return module
    # the reference's checkpoint.pth under DataParallel: a numpy perf
    return {"epoch": 3, "model": "hourglass", "state_dict": module,
            "best_state_dict": sd, "perf": np.float64(61.5),
            "optimizer": {"state": {}, "param_groups": []}}


@pytest.mark.parametrize("kind", ["bare", "state_dict", "best_state_dict",
                                  "module_prefix", "reference_checkpoint"])
def test_load_model_weights_layouts(tmp_path, kind):
    cfg = load_config(_synthetic_cfg(tmp_path))
    torch.manual_seed(3)
    sd = get_pose_net(cfg).state_dict()
    path = str(tmp_path / "w.pth")
    torch.save(_layout(kind, sd), path)
    got = ck.load_model_weights(path)
    assert list(got) == list(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    model = get_pose_net(cfg)
    model.load_state_dict(got)


def test_load_refuses_other_objects(tmp_path):
    """Weight files go through the weights-only unpickler: an object of
    another kind is refused, not built."""
    import datetime
    import pickle
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": {"w": torch.ones(2)},
                "when": datetime.date(2020, 1, 1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        ck.load_model_weights(path)


def test_checkpoint_async_atomic(tmp_path):
    """An async save is joinable and loadable, leaves no .tmp file, and
    holds a snapshot: a step taken after the call does not reach it."""
    cfg = load_config(_synthetic_cfg(tmp_path))
    state = create_train_state(cfg, seed=0, device="cpu")
    out = str(tmp_path / "ck")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ck.save_checkpoint(out, state, epoch=3, perf=0.5, is_best=True)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    ck.flush_pending(out)
    payload = ck.load_checkpoint_file(os.path.join(out, ck.CKPT_NAME))
    assert payload["epoch"] == 3 and payload["perf"] == 0.5
    best = ck.load_model_weights(os.path.join(out, ck.BEST_NAME))
    for k, v in before.items():
        torch.testing.assert_close(best[k], v, rtol=0, atol=0)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    ck.release_writer(out)


def test_save_best_and_release_writer(tmp_path):
    """save_best writes ONLY ``model_best.pth``; release_writer retires
    the dir's writer, and a later save re-creates one."""
    cfg = load_config(_synthetic_cfg(tmp_path))
    state = create_train_state(cfg, seed=0, device="cpu")
    out = str(tmp_path / "run")
    ck.save_best(out, state)
    ck.flush_pending(out)
    assert sorted(os.listdir(out)) == [ck.BEST_NAME]
    key = os.path.abspath(out)
    assert key in ck._writers
    ck.release_writer(out)
    assert key not in ck._writers
    ck.save_best(out, state)
    ck.release_writer(out)
    assert key not in ck._writers
