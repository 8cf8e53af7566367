"""The port's stall watchdog (``fhpe_tpu_torch/utils/watchdog.py``) and its
wiring into the CLIs, on the CPU.

* The class is ``fhpe_tpu``'s, pinned by source equality but for the
  stall message (which speaks of the card), and behaves as
  ``tests/test_watchdog.py`` holds ``fhpe_tpu``'s: disabled it does
  nothing; armed by a beat it fires after the beats stop (callbacks, then
  exit 86); beats keep it alive, ``disarm`` suspends it; ``stop`` ends it.
* The arming rule: a compiled step's call that captures its graph (the
  eager run, the kernels' build at first use, the recording) runs
  disarmed (``utils/graph.py::before_capture``), so a capture slower than
  the timeout does not fire, where a replay as slow does.
* ``cli.train`` with ``TPU.STALL_TIMEOUT_S`` completes without a fire,
  also when the eval step's capture outlasts the timeout.
* A child (``tests/watchdog_child.py``) whose step blocks the host after
  step 2 exits 86 within timeout + poll + callback budget of the block,
  with the log line and the thread dump; the flushed ``checkpoint.pth``
  loads, and a rerun with the same ``FHPE_RUN_TAG`` resumes from it.
* Under ``torchrun`` with 2 gloo ranks, rank 0's dataset metric outlasts
  the timeout and no rank fires: the other rank disarms while it waits
  in the next epoch's first step.
"""

import inspect
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from unittest import mock

import pytest
import torch
import yaml

from fhpe_tpu.utils import watchdog as watchdog_jax
from fhpe_tpu_torch.cli import common
from fhpe_tpu_torch.cli import train as train_cli
from fhpe_tpu_torch.utils import checkpoint as ck
from fhpe_tpu_torch.utils.graph import CapturedStep, before_capture
from fhpe_tpu_torch.utils.watchdog import StallWatchdog, null_watchdog

from test_torch_graph import stand_in
from torch_threads import child_env, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "watchdog_child.py")
HG = {"NAME": "hourglass", "NUM_JOINTS": 16, "IMAGE_SIZE": [64, 64],
      "HEATMAP_SIZE": [16, 16], "SIGMA": 2, "PRETRAINED": "",
      "INIT_WEIGHTS": False, "TARGET_TYPE": "gaussian",
      "EXTRA": {"NUM_FEATURES": 16, "NUM_STACKS": 1, "NUM_BLOCKS": 1}}
# a CLI's timeout: above what a tiny CPU step, a validation batch or an
# epoch's turn take between two beats on a loaded machine
CLI_TIMEOUT_S = 3.0
CHILD_TIMEOUT_S = 120


def _spin_until(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.01)
    return True


# -- the class ----------------------------------------------------------------

def _without_message(src: str) -> str:
    """A source with the stall message's statement (``msg = (...)``) cut
    out: the one text the port words for the card."""
    return re.sub(r"\n        msg = \(.*?\)\n", "\n", src, flags=re.S)


def test_watchdog_copy_equal():
    port, ref = (inspect.getsource(m.StallWatchdog)
                 for m in (sys.modules[StallWatchdog.__module__],
                           watchdog_jax))
    assert "msg = (" in port and _without_message(port) != port
    assert _without_message(port) == _without_message(ref)
    assert inspect.getsource(null_watchdog) == inspect.getsource(
        watchdog_jax.null_watchdog)
    assert sys.modules[StallWatchdog.__module__].DEFAULT_EXIT_CODE == 86


def _disabled():
    wd = null_watchdog()
    assert not wd.enabled
    wd.beat()
    wd.disarm()
    wd.stop()
    assert not wd.fired


def _fires_after_beats_stop():
    fired = threading.Event()
    calls = []
    wd = StallWatchdog(0.3, on_stall=[lambda: calls.append("flush")],
                       exit_fn=lambda code: (calls.append(code),
                                             fired.set()),
                       poll_s=0.05)
    wd.beat()  # arm
    assert _spin_until(fired.is_set)
    assert wd.fired
    assert calls == ["flush", 86]
    wd.stop()


def _beats_keep_alive_and_disarm_suspends():
    fired = threading.Event()
    wd = StallWatchdog(0.4, exit_fn=lambda code: fired.set(), poll_s=0.05)
    time.sleep(0.6)         # not armed yet: no fire past the timeout
    assert not fired.is_set()
    for _ in range(10):
        wd.beat()
        time.sleep(0.1)
    assert not fired.is_set()
    wd.disarm()
    time.sleep(0.6)
    assert not fired.is_set()
    wd.beat()               # re-armed; silence then fires
    assert _spin_until(fired.is_set, timeout=5.0)
    wd.stop()


def _stop_prevents_firing():
    fired = threading.Event()
    wd = StallWatchdog(0.2, exit_fn=lambda code: fired.set(), poll_s=0.05)
    wd.beat()
    wd.stop()
    time.sleep(0.5)
    assert not fired.is_set()


BEHAVIOURS = {"disabled": _disabled, "fires": _fires_after_beats_stop,
              "beats_and_disarm": _beats_keep_alive_and_disarm_suspends,
              "stop": _stop_prevents_firing}


@pytest.mark.parametrize("name", sorted(BEHAVIOURS))
def test_watchdog_behaviour(name):
    BEHAVIOURS[name]()


# -- the arming rule ------------------------------------------------------------

@pytest.mark.parametrize("slow", ["capture", "replay"])
def test_capture_runs_disarmed(slow):
    """An armed watchdog (0.3 s) around a compiled step whose capture, or
    whose replay, takes 0.8 s: the slow capture does not fire, the slow
    replay does."""
    fired = threading.Event()
    wd = StallWatchdog(0.3, exit_fn=lambda code: fired.set(), poll_s=0.05)
    inner = stand_in(lambda: [])

    def capture(run):
        replay, out = inner(run)
        if slow == "capture":
            time.sleep(0.8)
            return replay, out

        def slow_replay():
            time.sleep(0.8)
            replay()
        return slow_replay, out

    step = CapturedStep(lambda owner, batch: {"y": batch["x"] * 2},
                        lambda owner: (), capture=capture)
    batch = {"x": torch.ones(3)}
    try:
        with before_capture(wd.disarm):
            wd.beat()
            for _ in range(2):          # the capture, then a replay
                assert torch.equal(step(None, batch)["y"], batch["x"] * 2)
                wd.beat()
        assert step.captures == 1
        assert fired.is_set() == (slow == "replay")
    finally:
        wd.stop()


# -- the CLIs -------------------------------------------------------------------

def _cfg(tmp_path, **over):
    """A 16-feature hourglass on the ``synthetic`` dataset (8 train images:
    2 steps of 4 per epoch; 4 validation images), float32, AUTO_RESUME,
    ``TPU.STALL_TIMEOUT_S`` armed."""
    cfg = {
        "OUTPUT_DIR": str(tmp_path / "out"), "LOG_DIR": str(tmp_path / "log"),
        "PRINT_FREQ": 1, "AUTO_RESUME": True, "WORKERS": 0,
        "DATASET": {"DATASET": "synthetic", "ROOT": str(tmp_path / "data"),
                    "TEST_SET": "valid", "TRAIN_SET": "train",
                    "SYNTH_SIZE": 8},
        "MODEL": HG,
        "TRAIN": {"BATCH_SIZE_PER_GPU": 4, "END_EPOCH": 1, "LR": 0.001},
        "TEST": {"BATCH_SIZE_PER_GPU": 4, "FLIP_TEST": False},
        "TPU": {"COMPUTE_DTYPE": "float32",
                "STALL_TIMEOUT_S": CLI_TIMEOUT_S},
        "DEBUG": {"DEBUG": False},
    }
    for k, v in over.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("case", ["healthy", "slow_capture"])
def test_train_cli_does_not_fire(tmp_path, caplog, case):
    """``cli.train`` over 2 epochs with the watchdog armed completes with
    no fire; in ``slow_capture`` (1 epoch) the validation's eval-step
    capture, made while the watchdog is armed by the train steps' beats,
    sleeps past the timeout and still nothing fires."""
    made, exits = [], []

    def watchdog(*a, **k):
        made.append(StallWatchdog(*a, **k, exit_fn=exits.append))
        return made[-1]

    orig_eval = common.make_eval_step

    def slow_eval_step(*a, **k):
        step = orig_eval(*a, **k)
        inner = stand_in(lambda: [])

        def capture(run):
            time.sleep(CLI_TIMEOUT_S + 1.5)
            return inner(run)
        step.captured._capture = capture
        return step

    caplog.set_level(logging.INFO)
    with mock.patch.object(train_cli, "StallWatchdog", watchdog), \
            mock.patch.object(common, "make_eval_step",
                              slow_eval_step if case == "slow_capture"
                              else orig_eval):
        train_cli.main(["--cfg", _cfg(tmp_path), "--device", "cpu",
                        "TRAIN.END_EPOCH", "2" if case == "healthy" else "1"])
    (wd,) = made
    assert wd.enabled and wd.timeout_s == CLI_TIMEOUT_S
    assert not wd.fired and exits == []
    assert wd._stop.is_set()                # stopped at the end of the run
    (run,) = (tmp_path / "out" / "synthetic" / "hourglass").iterdir()
    assert (f"=> stall watchdog armed on first step (timeout "
            f"{CLI_TIMEOUT_S:.0f}s, exit 86)") in caplog.messages
    assert (run / ck.FINAL_NAME).exists()


def _child(args, env, torchrun=False):
    env = child_env(dict(os.environ, **env))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable]
    if torchrun:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2"]
    return subprocess.Popen(cmd + [CHILD, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err, time.time()


def test_stalled_child_exits_86_and_resumes(tmp_path):
    cfg = _cfg(tmp_path)
    env = {"FHPE_RUN_TAG": "stall"}
    code, out, err, end = _finish(_child(
        ["stall", cfg, "TRAIN.END_EPOCH", "2"], env))
    assert code == 86, (out[-3000:], err[-3000:])
    blocked = float(re.search(r"^BLOCKED (\S+)$", out, re.M).group(1))
    wd = StallWatchdog(0)
    poll = min(max(CLI_TIMEOUT_S / 4, 0.05), 30.0)
    # from the block to the exit: at most the timeout, a poll and the
    # callbacks' budget (the process's own exit on top)
    assert end - blocked <= CLI_TIMEOUT_S + poll + wd.callback_timeout_s
    (run,) = (tmp_path / "out" / "synthetic" / "hourglass").iterdir()
    assert run.name == "cfg_stall"
    log = (run / "running.log").read_text()
    fire = re.search(r"STALL WATCHDOG: no progress for (\d+)s \(timeout "
                     r"(\d+)s\)", log)
    assert fire and int(fire.group(1)) >= int(fire.group(2)) == 3, log
    # the thread dump: every thread, the main one blocked in the step
    assert "most recent call first" in err and "in blocking" in err, err
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert (saved["epoch"], saved["step"]) == (1, 2)
    assert not (run / ck.FINAL_NAME).exists()

    code, out, err, _ = _finish(_child(["plain", cfg, "TRAIN.END_EPOCH",
                                        "2"], env))
    assert code == 0, (out[-3000:], err[-3000:])
    log = (run / "running.log").read_text()
    assert re.search(r"=> auto-resumed from epoch 1 \(best perf \S+, step "
                     r"2, parameter sum \S+\)", log)
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert (saved["epoch"], saved["step"]) == (2, 4)
    assert (run / ck.FINAL_NAME).exists()


def test_two_ranks_long_evaluation_does_not_fire(tmp_path):
    """2 gloo ranks, a global batch of 4 (2 per rank), 2 epochs; rank 0's
    dataset metric sleeps past the timeout after epoch 0 while rank 1
    waits in epoch 1's first step; both end with code 0."""
    cfg = _cfg(tmp_path)
    code, out, err, _ = _finish(_child(
        ["slow_eval", cfg, str(CLI_TIMEOUT_S + 1.5), "TRAIN.END_EPOCH", "2",
         "TRAIN.BATCH_SIZE_PER_GPU", "2"], {"FHPE_RUN_TAG": "ddp"},
        torchrun=True))
    assert code == 0, (out[-3000:], err[-3000:])
    (run,) = (tmp_path / "out" / "synthetic" / "hourglass").iterdir()
    log = (run / "running.log").read_text()
    assert "rank 0 of world size 2" in log
    assert "stall watchdog armed" in log and "STALL" not in log
    assert "[rank 1] " in out + err and "STALL" not in out + err
    assert log.count("=> saving checkpoint") == 2
    saved = ck.load_checkpoint_file(str(run / ck.CKPT_NAME))
    assert (saved["epoch"], saved["step"], saved["perf"]) == (2, 4, 0.5)
