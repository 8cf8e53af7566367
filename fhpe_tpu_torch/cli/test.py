"""Evaluation CLI.

Counterpart of ``fhpe_tpu/cli/test.py`` (the reference's
``tools/test.py``) on one device: load ``TEST.MODEL_FILE`` (or
``final_state.pth`` of the run dir), run the full validation pass with
flip-test and dataset metrics, after the model summary
(``utils/summary.py``); under ``DEBUG.DEBUG`` validation writes its
``val_{i}_*.jpg`` dumps into the run directory.  Under ``torchrun`` rank
0 evaluates and the other ranks return None, as ``fhpe_tpu``'s process 0
does.  Any
layout ``utils/checkpoint.py::load_model_weights`` reads loads, the
reference's released ``.pth`` files and ``fhpe_tpu``'s ``.msgpack`` files
among them.

Usage:
  python -m fhpe_tpu_torch.cli.test --cfg <cfg.yaml> [--device cuda|cpu] \\
      TEST.MODEL_FILE <weights.pth | weights.msgpack>
"""

from __future__ import annotations

import os

from ..models import get_pose_net
from ..parallel import is_main_process, shutdown
from ..train import param_dtype
from ..utils.checkpoint import FINAL_NAME, load_model_weights
from .common import (build_loaders, check_supported, create_run_logger,
                     load_cfg_from_args, make_evaluate_fn, parse_args,
                     process_text, resolve_device, summary_text, validate)


def main(argv=None):
    """Returns the perf indicator (PCKh Mean, COCO AP, or the PCK proxy
    on ``synthetic``); None on a rank other than 0."""
    args = parse_args("Test keypoints network", argv=argv)
    cfg = load_cfg_from_args(args)
    check_supported(cfg)
    device = resolve_device(args.device)
    try:
        return run(args, cfg, device)
    finally:
        shutdown()


def run(args, cfg, device):
    logger, output_dir, _ = create_run_logger(cfg, args.cfg, "valid")
    logger.info(process_text(device))
    if not is_main_process():
        logger.info("=> rank 0 evaluates")
        return None

    model_file = cfg.TEST.MODEL_FILE or os.path.join(output_dir, FINAL_NAME)
    if not os.path.exists(model_file):
        raise SystemExit(f"model file not found: {model_file}")
    logger.info(f"=> loading model from {model_file}")
    model = get_pose_net(cfg)
    model.load_state_dict(load_model_weights(model_file, cfg))
    model = model.to(device=device, dtype=param_dtype(cfg, device)).eval()
    logger.info(summary_text(model, cfg))

    _, val_loader, meta = build_loaders(cfg, train=False)
    try:
        perf, *_ = validate(cfg, model, val_loader, meta, logger,
                            make_evaluate_fn(cfg, device=device), output_dir)
    finally:
        val_loader.close()
    logger.info(f"=> final perf: {perf:.4f}")
    return perf


if __name__ == "__main__":
    main()
