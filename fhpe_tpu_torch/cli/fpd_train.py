"""FPD distillation training CLI.

Counterpart of ``fhpe_tpu/cli/fpd_train.py`` (the reference's
``tools/fpd_train.py``), on one device or one process per device under
``torchrun`` as ``cli/train.py``: student config via ``--cfg``,
teacher via ``--tcfg`` merged over it; teacher weights from
``KD.TEACHER`` (required — the reference's NORMAL mode crashes on an
undefined teacher, fpd_train.py:244, and is not supported here either);
both models' summaries logged (Student, then Teacher) and both
validated before epoch 0 as a sanity check (on rank 0); per-epoch FPD
step with ``loss = (1-alpha)*MSE(student, gt) + alpha*MSE(student,
teacher)``, the teacher in eval mode in every process; checkpoints,
AUTO_RESUME and the ``DEBUG.*`` image dumps as ``cli/train.py``.

Usage:
  python -m fhpe_tpu_torch.cli.fpd_train --cfg <student.yaml> \\
      --tcfg <teacher.yaml> [--device cuda|cpu] [KEY VALUE ...]
  torchrun --nproc_per_node N -m fhpe_tpu_torch.cli.fpd_train --cfg ... \\
      --tcfg ... [...]
"""

from __future__ import annotations

import os

from ..models import get_pose_net
from ..parallel import is_main_process, shutdown
from ..train import (create_train_state, make_batch_preprocessor,
                     make_fpd_train_step, param_dtype)
from ..utils.checkpoint import load_model_weights
from ..utils.logger import save_config_yaml
from ..utils.pretrained import load_pretrained
from . import train as train_cli
from .common import (build_loaders, check_supported, create_run_logger,
                     debug_outputs, load_cfg_from_args, make_evaluate_fn,
                     parse_args, process_text, resolve_device, summary_text,
                     tb_writer, validate)

FPD_METERS = ("loss", "pose_loss", "kd_loss")
FPD_TB_NAMES = {"loss": "train_loss", "pose_loss": "train_pose_loss",
                "kd_loss": "train_kd_pose_loss"}


def load_teacher(cfg, tcfg, device):
    """The ``tcfg`` model with ``KD.TEACHER``'s weights (a ``.pth``, or
    ``fhpe_tpu``'s ``.msgpack`` mapped by ``tcfg``) on ``device``, in eval
    mode and frozen."""
    teacher = get_pose_net(tcfg)
    teacher.load_state_dict(load_model_weights(cfg.KD.TEACHER, tcfg))
    teacher = teacher.to(device=device, dtype=param_dtype(tcfg, device))
    return teacher.eval().requires_grad_(False)


def main(argv=None):
    args = parse_args("FPD distillation training", teacher=True, argv=argv)
    cfg = load_cfg_from_args(args)
    if cfg.KD.TRAIN_TYPE != "FPD":
        raise SystemExit(
            "KD.TRAIN_TYPE must be 'FPD' for fpd_train (the reference's "
            "NORMAL branch is broken upstream, fpd_train.py:244; use "
            "cli.train for normal training)")
    if not cfg.KD.TEACHER or not os.path.exists(cfg.KD.TEACHER):
        raise SystemExit(f"KD.TEACHER checkpoint not found: {cfg.KD.TEACHER}")
    check_supported(cfg)
    train_cli.check_checkpoint_path(cfg)
    device = resolve_device(args.device)
    try:
        run(args, cfg, device)
    finally:
        shutdown()


def run(args, cfg, device):
    # teacher cfg: clone of student cfg merged with the teacher file
    # (reference fpd_train.py:128-131)
    tcfg = cfg.clone()
    tcfg.defrost()
    tcfg.merge_from_file(args.tcfg)
    tcfg.freeze()

    logger, output_dir, tb_dir = create_run_logger(cfg, args.cfg,
                                                   "fpd_train")
    logger.info(process_text(device))
    rank0 = is_main_process()
    if rank0:
        save_config_yaml(cfg, os.path.join(output_dir, "config.yaml"))
        save_config_yaml(tcfg, os.path.join(output_dir,
                                            "teacher_config.yaml"))

    state = create_train_state(cfg, seed=int(cfg.TRAIN.get("SEED", 0)),
                               device=device)
    teacher = load_teacher(cfg, tcfg, device)
    logger.info("Student:\n" + summary_text(state.model, cfg))
    logger.info("Teacher:\n" + summary_text(teacher, tcfg))
    logger.info(f"=> teacher {tcfg.MODEL.NAME} from {cfg.KD.TEACHER}")
    # student ImageNet-pretrained trunk init (reference fpd_train.py:122);
    # the teacher loads KD.TEACHER instead
    load_pretrained(cfg, state.model, logger)
    if cfg.TRAIN.CHECKPOINT:
        state = train_cli.warm_start(cfg, state, logger)
    state, begin_epoch, best_perf = train_cli.resume(cfg, state, output_dir,
                                                     logger)

    train_loader, val_loader, meta = build_loaders(cfg)
    writer = tb_writer(tb_dir, logger) if rank0 else None
    try:
        prepare = (make_batch_preprocessor(cfg, meta["joints_weight"])
                   if cfg.TPU.DEVICE_PREPROCESS else None)
        step_fn = make_fpd_train_step(
            cfg, teacher, teacher_cfg=tcfg, prepare=prepare,
            debug_outputs=debug_outputs(cfg))
        evaluate_fn = make_evaluate_fn(cfg, device=device)

        # pre-training sanity validation of both models
        # (fpd_train.py:242-250), on rank 0
        if rank0:
            logger.info("=> validating teacher before training")
            tperf = validate(cfg, teacher, val_loader, meta, logger,
                             evaluate_fn, output_dir)[0]
            logger.info(f"=> teacher perf: {tperf:.4f}")
            logger.info("=> validating student before training")
            sperf = validate(cfg, state.model, val_loader, meta, logger,
                             evaluate_fn, output_dir)[0]
            logger.info(f"=> student perf: {sperf:.4f}")

        global_step = 0

        def train_epoch(state, epoch):
            nonlocal global_step
            state, global_step = train_cli.run_epoch(
                cfg, train_loader, step_fn, state, device, epoch, logger,
                writer, global_step, FPD_METERS, FPD_TB_NAMES,
                output_dir=output_dir)
            return state

        def evaluate(state, epoch):
            return validate(cfg, state.model, val_loader, meta, logger,
                            evaluate_fn, output_dir, writer=writer,
                            global_step=epoch)[0]

        train_cli.epoch_loop(cfg, state, begin_epoch, best_perf, train_epoch,
                             evaluate, output_dir, logger, writer)
    finally:
        train_loader.close()
        val_loader.close()
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
