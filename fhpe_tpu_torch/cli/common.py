"""Shared CLI wiring: arguments, datasets and loaders, batches on the
device, the validation pass and the dataset-metric dispatch.

Counterpart of ``fhpe_tpu/cli/common.py``, on one device with no process
sharding (``BatchLoader``'s ``process_index`` 0 of 1):

* :func:`parse_args` (``fhpe_tpu``'s, plus ``--device``, default
  ``cuda``), :func:`load_cfg_from_args` (a copy), :func:`resolve_device`
  (a card that is asked for and missing ends the CLI; it never goes on on
  the CPU) and :func:`check_supported` (what the port refuses);
* :func:`build_loaders`: db -> ``PoseDataSource`` -> ``BatchLoader``,
  train and validation;
* :func:`train_batch_keys` and :func:`eval_batch_transform` (copies,
  pinned by ``tests/test_torch_port_hygiene.py``): what a train or eval
  step takes from a host batch;
* :func:`device_batch`: a host batch as tensors on an explicit device;
* :func:`validate`: the eval loop (reference function.py:189-332) with
  ``make_eval_step`` (on the card a graph captured on the first batch and
  replayed for the rest: every batch is padded to one size), the prediction and box accumulation, the macro-PCK
  meter and the TensorBoard scalars, then the dataset metric;
* :func:`make_evaluate_fn`: the COCO branch (rescore + OKS-NMS on the card
  -> results JSON -> COCO AP), the MPII branch (PCKh against
  ``gt_<TEST_SET>.mat``, host) and the ``synthetic`` branch.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from ..config import load_config
from ..data import BatchLoader, PoseDataSource, build_db, dataset_meta
from ..geometry.flip import flip_pair_permutation
from ..ops.decode import make_inverse_transforms
from ..train import make_batch_preprocessor, make_eval_step
from ..utils.logger import AverageMeter, print_name_value


def parse_args(description: str, teacher: bool = False, argv=None):
    """``fhpe_tpu``'s arguments, plus ``--device`` (``cuda``, ``cuda:1``,
    ``cpu``); ``argv`` None reads ``sys.argv``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", required=True, help="experiment config file")
    if teacher:
        parser.add_argument("--tcfg", required=True,
                            help="teacher experiment config file")
    parser.add_argument("--modelDir", default="", type=str)
    parser.add_argument("--logDir", default="", type=str)
    parser.add_argument("--dataDir", default="", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (default cuda; cpu "
                             "runs the kernels' plain versions)")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE [KEY VALUE ...]")
    return parser.parse_args(argv)


def load_cfg_from_args(args, cfg_attr="cfg"):
    return load_config(getattr(args, cfg_attr), opts=args.opts,
                       model_dir=args.modelDir, log_dir=args.logDir,
                       data_dir=args.dataDir)


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch device; a CUDA device without a card ends
    the CLI with a message (it never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is "
                         f"False; pass --device cpu to run on the CPU")
    return device


def check_supported(cfg) -> None:
    """Refuse what the port does not do yet, rather than skip it in
    silence.  ``TPU.NUM_DEVICES > 1`` is refused by
    ``create_train_state``."""
    if cfg.DEBUG.DEBUG:
        raise NotImplementedError(
            "DEBUG.DEBUG (debug image dumps) is not ported yet (ROADMAP.md "
            "queue A, the debug images and the summary table); pass "
            "DEBUG.DEBUG False")


def tb_writer(tb_dir: str, logger):
    """A tensorboardX ``SummaryWriter`` on ``tb_dir``, or None when
    tensorboardX is not installed (as ``fhpe_tpu``'s CLIs do)."""
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(log_dir=tb_dir)
    except Exception as e:      # optional: a broken install must not stop a run
        logger.info(f"tensorboardX unavailable ({e!r}); skipping TB logging")
        return None


def build_loaders(cfg, synthetic_dir: str | None = None, train: bool = True):
    """(train_loader, val_loader, meta) for one device: batches of
    ``TRAIN.BATCH_SIZE_PER_GPU`` / ``TEST.BATCH_SIZE_PER_GPU``.
    synthetic_dir swaps in the hermetic synthetic db (for smoke runs
    without real data)."""
    meta = dataset_meta(cfg.DATASET.DATASET)

    if synthetic_dir is not None:
        from ..data import make_synthetic_db
        db_train = make_synthetic_db(
            synthetic_dir, 64, meta["num_joints"],
            (cfg.MODEL.IMAGE_SIZE[1], cfg.MODEL.IMAGE_SIZE[0]))
        db_val = db_train[:32]
    else:
        db_train = build_db(cfg, cfg.DATASET.TRAIN_SET, True) if train else []
        db_val = build_db(cfg, cfg.DATASET.TEST_SET, False)

    train_loader = None
    if train:
        seed = int(cfg.TRAIN.get("SEED", 0))
        src = PoseDataSource(cfg, db_train, is_train=True,
                             flip_pairs=meta["flip_pairs"],
                             upper_body_ids=meta["upper_body_ids"],
                             joints_weight=meta["joints_weight"],
                             seed=seed)
        train_loader = BatchLoader(
            src, batch_size=cfg.TRAIN.BATCH_SIZE_PER_GPU,
            shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
            host_targets=not cfg.TPU.DEVICE_PREPROCESS,
            num_threads=max(2, cfg.WORKERS), seed=seed)

    val_src = PoseDataSource(cfg, db_val, is_train=False,
                             flip_pairs=meta["flip_pairs"],
                             upper_body_ids=meta["upper_body_ids"],
                             joints_weight=meta["joints_weight"])
    val_loader = BatchLoader(
        val_src, batch_size=cfg.TEST.BATCH_SIZE_PER_GPU,
        shuffle=False, drop_last=False,
        host_targets=not cfg.TPU.DEVICE_PREPROCESS,
        num_threads=max(2, cfg.WORKERS))
    return train_loader, val_loader, meta


def train_batch_keys(cfg):
    """Minimal host->device transfer set for a train step."""
    if cfg.TPU.get("DEVICE_WARP", False):
        return ["canvas", "warp_inv", "joints", "joints_vis"]
    keys = ["image"]
    if cfg.TPU.DEVICE_PREPROCESS:
        keys += ["joints", "joints_vis"]
    else:
        keys += ["target", "target_weight"]
    return keys


def eval_batch_transform(cfg):
    """Host batch -> device dict for the eval step (adds inverse affines).

    Eval always ships host-warped images (bit-parity with the reference),
    even when TPU.DEVICE_WARP accelerates training batches.
    """
    keys = ["image"]
    if cfg.TPU.DEVICE_PREPROCESS:
        keys += ["joints", "joints_vis"]
    else:
        keys += ["target", "target_weight"]
    hm_size = tuple(cfg.MODEL.HEATMAP_SIZE)

    def tf(batch):
        dev = {k: batch[k] for k in keys}
        dev["inv_trans"] = make_inverse_transforms(batch["center"],
                                                   batch["scale"], hm_size)
        dev["valid"] = batch["valid"].astype("float32")
        return dev

    return tf


def device_batch(cfg, batch, device, for_eval=False):
    """Host batch dict -> tensors on ``device``, the minimal transfer set
    of a train step (:func:`train_batch_keys`) or an eval step
    (:func:`eval_batch_transform`).  On the card a captured step then
    copies these into its graph's static inputs, device to device: the
    upload stays here, so the eager bodies and the CPU path take the same
    batch."""
    if for_eval:
        host = eval_batch_transform(cfg)(batch)
    else:
        host = {k: batch[k] for k in train_batch_keys(cfg)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def validate(cfg, model, val_loader, meta, logger, evaluate_fn=None,
             output_dir: str = "", writer=None, global_step: int = 0):
    """Full validation pass of ``model`` on its own device (reference
    function.py:189-332; ``fhpe_tpu/cli/common.py::validate`` on one
    device, with no mesh, no compiled-step cache and no watchdog).

    With ``writer`` set, mirrors the reference's TB surface (valid_loss /
    valid_acc scalars + the name_values dict, function.py:304-330).
    Returns (perf_indicator, name_values, all_preds, all_boxes, img_paths).
    """
    device = next(model.parameters()).device
    perm = flip_pair_permutation(meta["num_joints"], meta["flip_pairs"])
    prepare = (make_batch_preprocessor(cfg, meta["joints_weight"])
               if cfg.TPU.DEVICE_PREPROCESS else None)
    eval_step = make_eval_step(cfg, flip_perm=perm, prepare=prepare)

    num_samples = len(val_loader.source)
    num_joints = meta["num_joints"]
    all_preds = np.zeros((num_samples, num_joints, 3), np.float32)
    all_boxes = np.zeros((num_samples, 6))
    img_paths = []
    losses, accs = AverageMeter(), AverageMeter()
    hits_total = np.zeros(num_joints)
    valids_total = np.zeros(num_joints)
    idx = 0
    t0 = time.time()
    n_batches = len(val_loader)
    for i, batch in enumerate(val_loader):
        out = eval_step(model, device_batch(cfg, batch, device,
                                            for_eval=True))
        n = int(batch["valid"].sum())
        all_preds[idx:idx + n, :, 0:2] = out["preds"][:n].cpu().numpy()
        all_preds[idx:idx + n, :, 2] = out["maxvals"][:n].cpu().numpy()
        c, s = batch["center"][:n], batch["scale"][:n]
        all_boxes[idx:idx + n, 0:2] = c
        all_boxes[idx:idx + n, 2:4] = s
        all_boxes[idx:idx + n, 4] = np.prod(s * 200, 1)
        all_boxes[idx:idx + n, 5] = batch["score"][:n]
        img_paths.extend(batch["image_path"][:n])

        losses.update(float(out["loss"]), n)
        hits = out["hits"].cpu().numpy()
        valids = out["valids"].cpu().numpy()
        hits_total += hits
        valids_total += valids
        # macro PCK per batch (reference accuracy(): mean of per-joint
        # accuracies over joints with valid samples, evaluate.py:62-68),
        # meter weighted by the counted-joint number (function.py:253)
        has = valids > 0
        batch_acc = float((hits[has] / valids[has]).mean()) if has.any() else 0.0
        accs.update(batch_acc, max(int(has.sum()), 1))
        idx += n

        if i % cfg.PRINT_FREQ == 0 and logger:
            logger.info(
                f"Test: [{i}/{n_batches}]\t"
                f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                f"Accuracy {accs.val:.3f} ({accs.avg:.3f})")

    has = valids_total > 0
    overall_acc = (float((hits_total[has] / valids_total[has]).mean())
                   if has.any() else 0.0)
    if logger:
        logger.info(
            f"Test: loss {losses.avg:.4f}  acc {accs.avg:.3f}  "
            f"(overall PCK {overall_acc:.3f}, "
            f"{num_samples / max(time.time() - t0, 1e-9):.1f} samples/s)")
    if writer is not None:
        # reference function.py:304-316
        writer.add_scalar("valid_loss", losses.avg, global_step)
        writer.add_scalar("valid_acc", accs.avg, global_step)

    if evaluate_fn is None:
        return overall_acc, {}, all_preds, all_boxes, img_paths

    name_values, perf = evaluate_fn(cfg, all_preds, output_dir, all_boxes,
                                    img_paths)
    if logger:
        if isinstance(name_values, list):
            for nv in name_values:
                print_name_value(logger, nv, cfg.MODEL.NAME)
        else:
            print_name_value(logger, name_values, cfg.MODEL.NAME)
    if writer is not None:
        # reference function.py:317-329
        nvs = name_values if isinstance(name_values, list) else [name_values]
        for nv in nvs:
            writer.add_scalars("valid", {k: float(v) for k, v in dict(nv).items()},
                               global_step)
    return perf, name_values, all_preds, all_boxes, img_paths


def make_evaluate_fn(cfg, device="cuda"):
    """``cfg.DATASET.DATASET`` -> ``fn(cfg, preds, output_dir, all_boxes,
    img_paths) -> (name_values, perf)``, or None for ``synthetic`` (whose
    metric is the in-training PCK proxy).

    preds: (N, J, 3) keypoints in image coordinates with their maxvals;
    all_boxes: (N, 6) [cx, cy, sx, sy, area, score]; img_paths end in the
    zero-padded image id (``.../val2017/000000000139.jpg``).  The OKS-NMS
    runs on ``device``.
    """
    name = cfg.DATASET.DATASET
    if name == "synthetic":
        return None
    if name == "mpii":
        from ..data import mpii

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            return mpii.evaluate(cfg, preds, output_dir or None)
        return fn
    if name == "coco":
        from ..data.coco import (NUM_JOINTS, CocoIndex, rescore_and_nms,
                                 write_results_json)
        from ..eval.coco_eval import CocoKeypointEval

        def fn(cfg, preds, output_dir, all_boxes, img_paths):
            nmsed = rescore_and_nms(
                preds, all_boxes, img_paths, num_joints=NUM_JOINTS,
                in_vis_thre=cfg.TEST.IN_VIS_THRE,
                oks_thre=cfg.TEST.OKS_THRE, soft=cfg.TEST.SOFT_NMS,
                device=device)
            res_file = os.path.join(
                output_dir or ".", "results",
                f"keypoints_{cfg.DATASET.TEST_SET}_results_{cfg.RANK}.json")
            results = write_results_json(nmsed, res_file)
            if "test" in cfg.DATASET.TEST_SET:
                return OrderedDict([("Null", 0.0)]), 0.0
            ann = os.path.join(cfg.DATASET.ROOT, "annotations",
                               f"person_keypoints_{cfg.DATASET.TEST_SET}.json")
            nv = OrderedDict(CocoKeypointEval(CocoIndex(ann)).evaluate(results))
            return nv, nv["AP"]
        return fn
    raise KeyError(name)
