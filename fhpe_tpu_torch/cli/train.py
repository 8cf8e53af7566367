"""Normal training CLI.

Counterpart of ``fhpe_tpu/cli/train.py`` (the reference's
``tools/train.py``): config merge, run-dir logger,
datasets/loaders, optimizer + epoch-boundary LR schedule,
``MODEL.PRETRAINED``, the ``TRAIN.CHECKPOINT`` warm start, AUTO_RESUME,
epoch loop train -> validate -> checkpoint, final state dump.  It logs the
model summary (``utils/summary.py``: parameters, and FLOPs counted on a
CPU copy); under ``DEBUG.DEBUG`` on one process the step returns its
heatmaps and targets, and every ``PRINT_FREQ`` steps the
``train_{epoch}_{i}_*.jpg`` dumps go to the run directory
(``utils/vis.py``), as validation's ``val_{i}_*.jpg`` do.

On one device, or data-parallel with one process per device under
``torchrun`` (the global batch ``TRAIN.BATCH_SIZE_PER_GPU`` x N, the
steps' collectives in ``train/step.py``): every rank trains every step;
rank 0 alone validates, writes the run directory (log, config, TensorBoard,
checkpoints, final state) and decides a resume, which it broadcasts.

``TPU.STALL_TIMEOUT_S`` > 0 arms the stall watchdog (``utils/watchdog.py``)
on the first beat: one after every train step and validation batch, none
across the dataset metric or a step call that captures its graph.  A
stalled run flushes the pending checkpoint write and exits 86, for a
supervisor to restart with ``AUTO_RESUME`` and a pinned ``FHPE_RUN_TAG``.

Usage:
  python -m fhpe_tpu_torch.cli.train --cfg experiments/mpii/hourglass/hg4.yaml \\
      [--device cuda|cpu] [TRAIN.END_EPOCH 140 ...]
  torchrun --nproc_per_node N -m fhpe_tpu_torch.cli.train --cfg ... [...]
"""

from __future__ import annotations

import os
import time

import torch

from ..parallel import is_main_process, shutdown
from ..train import (create_train_state, lr_for_epoch,
                     make_batch_preprocessor, make_optimizer,
                     make_train_step, set_lr)
from ..utils.checkpoint import (auto_resume_multihost, flush_pending,
                                load_model_weights, save_best,
                                save_checkpoint, save_final_state)
from ..utils.graph import before_capture
from ..utils.logger import WindowedMeters, save_config_yaml
from ..utils.pretrained import load_pretrained
from ..utils.spans import span
from ..utils.watchdog import StallWatchdog
from .common import (build_loaders, check_supported, create_run_logger,
                     debug_images, debug_outputs, device_batch,
                     load_cfg_from_args, make_evaluate_fn, parse_args,
                     process_text, resolve_device, summary_text, tb_writer,
                     validate)


class StepProfiler:
    """``FHPE_PROFILE_DIR``: a ``torch.profiler`` trace of steps 2-12 of
    epoch 0, written as a Chrome trace (``trace.json``) into that
    directory, the ``fhpe.*`` spans (``utils/spans.py``) beside the
    operators; inert when the variable is unset or on other epochs."""

    def __init__(self, epoch: int, logger):
        self.dir = os.environ.get("FHPE_PROFILE_DIR") if epoch == 0 else None
        self.logger = logger
        self.prof = None

    def before(self, i: int, device) -> None:
        if self.dir and i == 2:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, i: int, device, last: bool = False) -> None:
        if self.prof is None or not (i == 12 or last):
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.logger.info(f"=> wrote profiler trace to {path}"
                         + (" (short epoch)" if i < 12 else ""))


def run_epoch(cfg, loader, step_fn, state, device, epoch, logger, writer,
              global_step, value_keys=("loss",), tb_names=None,
              output_dir=None, watchdog=None):
    """One training epoch of ``step_fn(state, device_batch) -> (state,
    metrics)``: the meters of ``value_keys`` and ``acc`` drained every
    ``PRINT_FREQ`` steps (the one read of the card per window), the TB
    scalars ``tb_names`` ({metric key: scalar name}), and one line with the
    epoch's steps, wall time and images/s.  Where the metrics carry
    ``"output"`` (``debug_outputs``), the ``PRINT_FREQ`` steps of a batch
    with ``"image"`` also write ``train_{epoch}_{i}_*.jpg`` into
    ``output_dir``: the only steps whose heatmaps are read.  ``watchdog``
    beats at the end of each step's iteration, after its window read, as
    ``fhpe_tpu``'s loop beats.  Each iteration is a ``fhpe.train.step``
    span holding ``fhpe.train.upload`` (``device_batch``) and
    ``fhpe.train.meters`` (``utils/spans.py``).  Returns (state,
    global_step)."""
    tb_names = tb_names or {"loss": "train_loss"}
    profiler = StepProfiler(epoch, logger)
    meters = WindowedMeters(value_keys=value_keys)
    t0, n_img, n = time.perf_counter(), 0, len(loader)
    for i, batch in enumerate(loader):
        profiler.before(i, device)
        with span("fhpe.train.step"):
            with span("fhpe.train.upload"):
                on_device = device_batch(cfg, batch, device)
            state, metrics = step_fn(state, on_device)
            with span("fhpe.train.meters"):
                meters.push(metrics, batch["joints"].shape[0])
                n_img += batch["joints"].shape[0]
                if i % cfg.PRINT_FREQ == 0:
                    meters.drain()
                    losses, accs = meters["loss"], meters["acc"]
                    extra = "".join(f"{k} {meters[k].val:.5f}  "
                                    for k in value_keys if k != "loss")
                    logger.info(
                        f"Epoch: [{epoch}][{i}/{n}]  "
                        f"Time {meters.batch_time.val:.3f}s  "
                        f"Speed {meters.speed:.1f} samples/s  "
                        f"Loss {losses.val:.5f} ({losses.avg:.5f})  {extra}"
                        f"Accuracy {accs.val:.3f} ({accs.avg:.3f})")
                    if writer is not None:
                        for k, name in tb_names.items():
                            writer.add_scalar(name, meters[k].val,
                                              global_step)
                        writer.add_scalar("train_acc", accs.val, global_step)
                    if output_dir and "output" in metrics and "image" in batch:
                        debug_images(cfg, batch, metrics, os.path.join(
                            output_dir, f"train_{epoch}_{i}"))
            if watchdog is not None:
                watchdog.beat()
        profiler.after(i, device, last=i == n - 1)
        global_step += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    logger.info(f"Epoch: [{epoch}] {n} steps in {wall:.3f} s "
                f"({n_img / max(wall, 1e-9):.1f} samples/s)")
    return state, global_step


def warm_start(cfg, state, logger):
    """``TRAIN.CHECKPOINT``: weights only, with a fresh optimizer on them
    (reference fpd_train.py:169-183), from a ``.pth`` or ``fhpe_tpu``'s
    ``.msgpack``; epoch and optimizer come back only through AUTO_RESUME."""
    weights = load_model_weights(cfg.TRAIN.CHECKPOINT, cfg)
    state.model.load_state_dict(weights)
    state.optimizer = make_optimizer(cfg, state.model.parameters())
    state.step = 0
    logger.info(f"=> warm-started weights from {cfg.TRAIN.CHECKPOINT}")
    return state


def check_checkpoint_path(cfg) -> None:
    # fail loudly like the reference's unconditional load
    # (fpd_train.py:169-172): a typo'd path must not silently turn a
    # warm-started run into a from-scratch run
    if cfg.TRAIN.CHECKPOINT and not os.path.exists(cfg.TRAIN.CHECKPOINT):
        raise SystemExit(f"TRAIN.CHECKPOINT not found: {cfg.TRAIN.CHECKPOINT}")


def resume(cfg, state, output_dir, logger):
    """(state, begin_epoch, best_perf), from AUTO_RESUME when rank 0 finds
    the run dir's checkpoint, the port's ``checkpoint.pth`` or else
    ``fhpe_tpu``'s ``checkpoint.msgpack`` (every rank loads rank 0's),
    before any step is made or captured.  The log line carries the
    parameters' float64 sum, one number to compare across ranks."""
    begin_epoch, best_perf = cfg.TRAIN.BEGIN_EPOCH, -1.0
    if cfg.AUTO_RESUME:
        state, ckpt_epoch, ckpt_perf = auto_resume_multihost(output_dir,
                                                             state, cfg)
        if ckpt_epoch is not None:
            begin_epoch, best_perf = ckpt_epoch, ckpt_perf
            total = sum(float(p.detach().double().sum())
                        for p in state.model.parameters())
            logger.info(f"=> auto-resumed from epoch {begin_epoch} "
                        f"(best perf {best_perf:.4f}, step {state.step}, "
                        f"parameter sum {total!r})")
    return state, begin_epoch, best_perf


def epoch_loop(cfg, state, begin_epoch, best_perf, train_epoch, evaluate,
               output_dir, logger, writer, watchdog=None):
    """The epochs ``begin_epoch .. END_EPOCH - 1``: ``set_lr`` to
    ``lr_for_epoch``, ``train_epoch(state, epoch)``, validation every
    ``EVAL_FREQ`` epochs and at the last, the ``>=`` best ratchet, the
    rolling checkpoint every ``CKPT_FREQ`` evaluations and at the last,
    ``model_best`` on a best epoch whose checkpoint is skipped.  Every
    rank trains every epoch at the same rate; validation, the ratchet and
    every write are rank 0's (``fhpe_tpu/cli/train.py:207-230``).

    A rank other than 0 disarms ``watchdog`` at the end of each epoch:
    its next host wait, the first window read of the next epoch, waits on
    the step's all-reduce until rank 0 has validated and checkpointed,
    however long that takes; the beat after that read arms it again.
    (``fhpe_tpu`` beats only on the evaluating process.)"""
    eval_freq = max(1, int(cfg.TRAIN.get("EVAL_FREQ", 1)))
    ckpt_freq = max(1, int(cfg.TRAIN.get("CKPT_FREQ", 1)))
    rank0 = is_main_process()
    for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
        state = set_lr(state, lr_for_epoch(cfg, epoch))
        state = train_epoch(state, epoch)
        last = epoch + 1 == cfg.TRAIN.END_EPOCH
        if not rank0 and watchdog is not None:
            watchdog.disarm()
        if not rank0 or not ((epoch + 1) % eval_freq == 0 or last):
            continue
        perf = evaluate(state, epoch)
        if writer is not None:
            writer.add_scalar("valid_perf", float(perf), epoch)
        is_best = perf >= best_perf
        best_perf = max(perf, best_perf)
        if (epoch + 1) % (eval_freq * ckpt_freq) == 0 or last:
            logger.info(f"=> saving checkpoint to {output_dir} "
                        f"(perf {perf:.4f}, best {best_perf:.4f})")
            save_checkpoint(output_dir, state, epoch + 1, perf, is_best,
                            model_name=cfg.MODEL.NAME)
        elif is_best:
            # CKPT_FREQ skipped the rolling checkpoint, but best_perf
            # ratchets every eval — snapshot model_best now or these
            # weights are lost and later epochs can't re-qualify.
            save_best(output_dir, state)
    if rank0:
        save_final_state(output_dir, state)
        logger.info(f"=> saved final state to {output_dir}")
    return state


def stall_watchdog(cfg, logger, output_dir=None) -> StallWatchdog:
    """The stall watchdog of ``TPU.STALL_TIMEOUT_S`` (disabled at 0), its
    stall callback the flush of ``output_dir``'s pending checkpoint
    write."""
    on_stall = [lambda: flush_pending(output_dir)] if output_dir else []
    watchdog = StallWatchdog(float(cfg.TPU.get("STALL_TIMEOUT_S", 0)),
                             logger=logger, on_stall=on_stall)
    if watchdog.enabled:
        logger.info(f"=> stall watchdog armed on first step "
                    f"(timeout {watchdog.timeout_s:.0f}s, exit 86)")
    return watchdog


def main(argv=None):
    args = parse_args("Train keypoints network", argv=argv)
    cfg = load_cfg_from_args(args)
    check_supported(cfg)
    check_checkpoint_path(cfg)
    device = resolve_device(args.device)
    try:
        run(args, cfg, device)
    finally:
        shutdown()


def run(args, cfg, device):
    logger, output_dir, tb_dir = create_run_logger(cfg, args.cfg, "train")
    logger.info(process_text(device))
    rank0 = is_main_process()
    if rank0:
        save_config_yaml(cfg, os.path.join(output_dir, "config.yaml"))

    state = create_train_state(cfg, seed=int(cfg.TRAIN.get("SEED", 0)),
                               device=device)
    logger.info(summary_text(state.model, cfg))
    # ImageNet-pretrained trunk init (reference get_pose_net(is_train=True)
    # -> init_weights(cfg.MODEL.PRETRAINED))
    load_pretrained(cfg, state.model, logger)
    if cfg.TRAIN.CHECKPOINT:
        state = warm_start(cfg, state, logger)
    state, begin_epoch, best_perf = resume(cfg, state, output_dir, logger)

    train_loader, val_loader, meta = build_loaders(cfg)
    writer = tb_writer(tb_dir, logger) if rank0 else None
    watchdog = stall_watchdog(cfg, logger, output_dir)
    try:
        prepare = (make_batch_preprocessor(cfg, meta["joints_weight"])
                   if cfg.TPU.DEVICE_PREPROCESS else None)
        step_fn = make_train_step(cfg, prepare=prepare,
                                  debug_outputs=debug_outputs(cfg))
        evaluate_fn = make_evaluate_fn(cfg, device=device)
        global_step = 0

        def train_epoch(state, epoch):
            nonlocal global_step
            state, global_step = run_epoch(
                cfg, train_loader, step_fn, state, device, epoch, logger,
                writer, global_step, output_dir=output_dir,
                watchdog=watchdog)
            return state

        def evaluate(state, epoch):
            return validate(cfg, state.model, val_loader, meta, logger,
                            evaluate_fn, output_dir, writer=writer,
                            global_step=epoch, watchdog=watchdog)[0]

        with before_capture(watchdog.disarm):
            epoch_loop(cfg, state, begin_epoch, best_perf, train_epoch,
                       evaluate, output_dir, logger, writer, watchdog)
    finally:
        watchdog.stop()
        train_loader.close()
        val_loader.close()
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
