"""Run-directory layout, logging, meters, and result tables.

A copy of ``fhpe_tpu/utils/logger.py`` (no JAX there; pinned to it by
``tests/test_torch_port_hygiene.py``): the timestamped
``output/<dataset>/<model>/<cfg>_<time>/`` run dir with ``running.log`` and
a TensorBoard dir (reference ``lib/utils/utils.py:23-55``), the
``AverageMeter`` (function.py:356-371), the windowed train meters and the
markdown result-table printer (function.py:336-353).

``WindowedMeters.drain`` reads each queued metric with ``float()``, which
takes the port's 0-d device tensors as it takes JAX arrays: on the card
that read is the one synchronisation per ``PRINT_FREQ`` window.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


def create_logger(cfg, cfg_name: str, phase: str = "train"):
    """(logger, final_output_dir, tb_log_dir)."""
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    root_output_dir.mkdir(parents=True, exist_ok=True)

    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_name = os.path.basename(cfg_name).split(".")[0]
    # The run-dir suffix is the launch timestamp (reference utils.py:36),
    # which means a supervised restart (stall watchdog exit 86 ->
    # supervise.sh) would land in a FRESH dir and AUTO_RESUME would find
    # no checkpoint.  FHPE_RUN_TAG pins the suffix so every restart of a
    # run shares one dir; supervise.sh exports it before the first launch.
    time_str = os.environ.get("FHPE_RUN_TAG") or time.strftime("%Y-%m-%d-%H-%M")

    final_output_dir = root_output_dir / dataset / model / f"{cfg_name}_{time_str}"
    final_output_dir.mkdir(parents=True, exist_ok=True)

    log_file = final_output_dir / "running.log"
    head = "%(asctime)-15s %(message)s"
    logging.basicConfig(filename=str(log_file), format=head)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(head))
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        logger.addHandler(console)

    tb_log_dir = (Path(cfg.LOG_DIR or "log") / dataset / model /
                  f"{cfg_name}_{time_str}")
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


class AverageMeter:
    """Running average (reference function.py:356-371)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count != 0 else 0.0


class WindowedMeters:
    """Async-dispatch-friendly train-loop meters.

    The jitted step dispatches asynchronously; forcing a host sync every
    iteration (as the reference's per-step meter updates do,
    function.py:68-86) would serialize the TPU pipeline.  Instead, per-step
    metric arrays are queued without blocking, and at each PRINT_FREQ
    boundary the queue is drained: by then every queued step but the newest
    has already completed on device, so the scalar fetches are cheap.  The
    result: ``loss``/``acc`` meters average EVERY step (reference-comparable
    "(avg)" values), and ``Speed`` is the true differenced window rate
    (window batches / window wall-clock), not a sync-inflated single sample.

    ``value_keys`` meters are counted by batch size; ``acc`` (if present in
    the step metrics) is counted by the step's ``acc_cnt`` visible-joint
    count, matching the reference's accuracy meter.
    """

    def __init__(self, value_keys=("loss",)):
        self.value_keys = tuple(value_keys)
        self.meters = {k: AverageMeter() for k in self.value_keys}
        self.meters["acc"] = AverageMeter()
        self.batch_time = AverageMeter()
        self._pending = []
        self._t0 = time.time()
        self._steps = 0
        self.speed = 0.0

    def push(self, metrics, batch_size: int):
        """Queue one dispatched step's metrics (no sync).

        Only the scalar meter keys are retained: debug tensors
        (``output``/``target`` heatmaps under DEBUG.DEBUG) must not be
        pinned for a whole PRINT_FREQ window of device buffers.
        """
        keep = {k: metrics[k] for k in (*self.value_keys, "acc", "acc_cnt")
                if k in metrics}
        self._pending.append((keep, batch_size))
        self._steps += 1

    def drain(self):
        """Block on the newest queued step, fold all queued steps into the
        meters, and compute the window's differenced step time / speed."""
        n_images = 0
        for m, n in self._pending:
            for k in self.value_keys:
                self.meters[k].update(float(m[k]), n)
            if "acc" in m:
                self.meters["acc"].update(
                    float(m["acc"]), max(int(m.get("acc_cnt", 1)), 1))
            n_images += n
        self._pending.clear()
        elapsed = time.time() - self._t0
        steps = max(self._steps, 1)
        self.batch_time.update(elapsed / steps, steps)
        self.speed = n_images / max(elapsed, 1e-9)
        self._t0 = time.time()
        self._steps = 0

    def __getitem__(self, key):
        return self.meters[key]


def print_name_value(logger, name_value, full_arch_name: str):
    """Markdown results table (reference function.py:336-353)."""
    names = list(name_value.keys())
    values = list(name_value.values())
    num_values = len(name_value)
    logger.info("| Arch " + " ".join([f"| {n}" for n in names]) + " |")
    logger.info("|---" * (num_values + 1) + "|")
    if len(full_arch_name) > 15:
        full_arch_name = full_arch_name[:8] + "..."
    logger.info(
        f"| {full_arch_name} "
        + " ".join([f"| {v:.3f}" for v in values]) + " |")


def save_config_yaml(cfg, path: str):
    """Dump the effective config (reference utils.py:260-271)."""
    with open(path, "w") as f:
        f.write(cfg.dump_yaml())
