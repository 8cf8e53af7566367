"""Child process of ``tests/test_torch_watchdog.py``: ``fhpe_tpu_torch``'s
``cli.train`` on the CPU with one of its steps or its dataset metric
slowed, so that the stall watchdog's exit (``os._exit(86)``) ends this
process and not the test's.

Usage: ``watchdog_child.py MODE CFG [KEY VALUE ...]``

* ``plain``: the CLI as it is.
* ``stall``: from the third train step on (epoch 1 of 2-step epochs,
  after epoch 0's checkpoint), the step blocks the host for good in a
  wait that releases the GIL, as a device wait does; prints ``BLOCKED
  <time.time()>`` first.
* ``slow_eval SECONDS``: the dataset metric of the first validation
  sleeps ``SECONDS`` (run under ``torchrun``: rank 0 validates while the
  other ranks wait in the next epoch's first step).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from fhpe_tpu_torch.cli import train as train_cli  # noqa: E402


def stalling_steps():
    orig = train_cli.make_train_step

    def factory(*a, **k):
        step, calls = orig(*a, **k), [0]

        def blocking(state, batch):
            calls[0] += 1
            if calls[0] > 2:
                print(f"BLOCKED {time.time()!r}", flush=True)
                threading.Event().wait()
            return step(state, batch)
        return blocking
    return mock.patch.object(train_cli, "make_train_step", factory)


def slow_metric(seconds: float):
    calls = []

    def make(cfg, device="cuda"):
        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(seconds)
            return collections.OrderedDict([("Mean", 50.0)]), 0.5
        return fn
    return mock.patch.object(train_cli, "make_evaluate_fn", make)


def main() -> None:
    torch.set_num_threads(2)
    mode, cfg, rest = sys.argv[1], sys.argv[2], sys.argv[3:]
    if mode == "stall":
        patch = stalling_steps()
    elif mode == "slow_eval":
        patch, rest = slow_metric(float(rest[0])), rest[1:]
    else:
        patch = mock.patch.dict(os.environ)
    with patch:
        train_cli.main(["--cfg", cfg, "--device", "cpu", *rest])


if __name__ == "__main__":
    main()
