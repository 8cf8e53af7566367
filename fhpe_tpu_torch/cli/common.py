"""Shared CLI wiring: arguments, the process group, datasets and
loaders, batches on the device, the validation pass and the
dataset-metric dispatch.

Counterpart of ``fhpe_tpu/cli/common.py``, one process per device: run
alone, or one of N under ``torchrun --nproc_per_node N``
(``parallel/mesh.py``):

* :func:`parse_args` (``fhpe_tpu``'s, plus ``--device``, default
  ``cuda``), :func:`load_cfg_from_args` (a copy), :func:`resolve_device`
  (a card that is asked for and missing ends the CLI; it never goes on on
  the CPU; under ``torchrun`` the process joins its group there) and
  :func:`check_supported` (what the port refuses before it writes
  anything; every YAML under ``experiments/`` passes);
* :func:`summary_text` (the model summary the CLIs log) and
  :func:`debug_outputs` (whether the train steps return heatmaps for the
  ``DEBUG.*`` dumps);
* :func:`create_run_logger`: the run directory and its log on rank 0
  only (``fhpe_tpu``'s processes share one host's files the same way);
* :func:`build_loaders`: db -> ``PoseDataSource`` -> ``BatchLoader``,
  train (this process's slice of each global batch of
  ``TRAIN.BATCH_SIZE_PER_GPU`` x world size; with drop path, each batch
  with its keep flags, ``data/drop_path.py``) and validation (unsharded,
  ``TEST.BATCH_SIZE_PER_GPU``: rank 0 validates alone);
* :func:`train_batch_keys` and :func:`eval_batch_transform` (copies,
  pinned by ``tests/test_torch_port_hygiene.py``): what a train or eval
  step takes from a host batch; :func:`train_step_keys` adds the keep
  flags to the first;
* :func:`device_batch`: a host batch as tensors on an explicit device,
  on the card through a ring of pinned staging buffers
  (:class:`PinnedRing`) whose copies run while the host goes on;
* :func:`validate`: the eval loop (reference function.py:189-332) with
  ``make_eval_step`` (on the card a graph captured on the first batch and
  replayed for the rest: every batch is padded to one size), the
  prediction and box accumulation, the macro-PCK meter and the
  TensorBoard scalars, under ``DEBUG.DEBUG`` the ``val_{i}`` image dumps
  every ``PRINT_FREQ`` batches and the first batch's grids in
  TensorBoard (``utils/vis.py``), then the dataset metric;
* :func:`make_evaluate_fn`: the COCO branch (rescore + OKS-NMS on the card
  -> results JSON -> COCO AP), the MPII branch (PCKh against
  ``gt_<TEST_SET>.mat``, host) and the ``synthetic`` branch.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from ..config import load_config
from ..data import BatchLoader, PoseDataSource, build_db, dataset_meta
from ..data import drop_path
from ..geometry.flip import flip_pair_permutation
from ..models.common import deconv_padding
from ..ops.decode import make_inverse_transforms
from ..parallel import (backend, broadcast_object, initialize, initialized,
                        is_main_process, process_count, process_index,
                        shutdown)
from ..train import make_batch_preprocessor, make_eval_step
from ..utils.logger import AverageMeter, create_logger, print_name_value
from ..utils.summary import get_model_summary
from ..utils.vis import save_debug_images, tb_log_images


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
    the CLI with a message (it never falls back to the CPU).  Under
    ``torchrun`` the process joins its group here (NCCL for ``cuda``,
    gloo for ``cpu``; a failure raises) and ``cuda`` is
    ``cuda:LOCAL_RANK``; the caller calls ``parallel.shutdown`` on its way
    out."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is "
                         f"False; pass --device cpu to run on the CPU")
    own = initialize(device.type)
    if own is None:
        return device
    if device.index is not None and device != own:
        shutdown()
        raise SystemExit(f"--device {name} under torchrun: this process's "
                         f"device is {own} (LOCAL_RANK); pass --device "
                         f"{device.type}")
    return own


def process_text(device) -> str:
    """This process's device, and its rank, world size and backend in a
    process group."""
    if not initialized():
        return f"device: {device}"
    return (f"device: {device}, rank {process_index()} of world size "
            f"{process_count()}, backend {backend()}")


def create_run_logger(cfg, cfg_name: str, phase: str):
    """(logger, output_dir, tb_dir): ``create_logger`` on rank 0 (the run
    directory, ``running.log``, the TensorBoard directory); on the other
    ranks a console logger whose lines carry the rank, with rank 0's
    paths.  No other rank writes into the run directory."""
    if is_main_process():
        logger, output_dir, tb_dir = create_logger(cfg, cfg_name, phase)
    else:
        logging.basicConfig(format=f"%(asctime)-15s [rank "
                            f"{process_index()}] %(message)s")
        logger = logging.getLogger()
        logger.setLevel(logging.INFO)
        output_dir = tb_dir = None
    output_dir, tb_dir = broadcast_object((output_dir, tb_dir))
    return logger, output_dir, tb_dir


def check_supported(cfg) -> None:
    """Refuse, before the run directory is made, a config the port cannot
    run as ``fhpe_tpu`` does: ``NUM_DECONV_KERNELS`` 3 in a deconv
    decoder, PoseResNet's or ViTPose's (``models/common.py::
    deconv_padding``, which the model refuses too).  A
    ``TPU.NUM_DEVICES`` that does not fit the process group is refused by
    ``create_train_state``."""
    if "NUM_DECONV_KERNELS" in cfg.MODEL.EXTRA:
        for kernel in cfg.MODEL.EXTRA.NUM_DECONV_KERNELS:
            deconv_padding(int(kernel))


def summary_text(model, cfg) -> str:
    """``get_model_summary``'s table of ``model`` at ``MODEL.IMAGE_SIZE``,
    as the CLIs log it (the count runs on a CPU copy; the model stays
    where it is)."""
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    return get_model_summary(model, (h, w))["text"]


def debug_outputs(cfg) -> bool:
    """Whether the train steps return their heatmaps and targets for the
    image dumps: ``DEBUG.DEBUG`` on one process, as ``fhpe_tpu`` keeps
    them to one process (``fhpe_tpu/cli/train.py:173``)."""
    return bool(cfg.DEBUG.DEBUG) and process_count() == 1


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
    """(train_loader, val_loader, meta).  The train loader's global batch
    is ``TRAIN.BATCH_SIZE_PER_GPU`` x world size, of which this process
    gets its contiguous ``TRAIN.BATCH_SIZE_PER_GPU`` (every rank draws the
    same order from ``TRAIN.SEED``); the validation loader is unsharded
    with batches of ``TEST.BATCH_SIZE_PER_GPU``, as ``fhpe_tpu`` sizes
    validation by the one process's local devices.  synthetic_dir swaps
    in the hermetic synthetic db (for smoke runs without real data)."""
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
            src, batch_size=cfg.TRAIN.BATCH_SIZE_PER_GPU * process_count(),
            shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
            host_targets=not cfg.TPU.DEVICE_PREPROCESS,
            num_threads=max(2, cfg.WORKERS), seed=seed,
            process_index=process_index(), process_count=process_count())
        if drop_path.drop_path_rate(cfg) > 0:
            train_loader = drop_path.KeepFlags(train_loader, cfg, seed)

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


def train_step_keys(cfg):
    """What :func:`device_batch` uploads for a train step: the copy's
    :func:`train_batch_keys`, and the drop-path keep flags where the
    student drops paths (``data/drop_path.py``, ViTPose's)."""
    keys = train_batch_keys(cfg)
    if drop_path.drop_path_rate(cfg) > 0:
        keys = keys + [drop_path.KEY]
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


# device_batch's uploads in this process, counted as utils/graph.py counts
# kernel launches: batches staged through the pinned ring (a CUDA device),
# batches handed over as zero-copy views (the CPU), and restages whose
# slot's previous copy was still pending, so that the host waited for it:
# the sign that the host ran ahead of the card.
ring_uploads = 0
cpu_uploads = 0
ring_waits = 0

# staging slots of the ring: the host runs at most this many steps ahead
RING_SLOTS = 2


class _StreamEvent:
    """A CUDA event recorded on ``device``'s current stream."""

    def __init__(self, device):
        self.device = device
        self.event = torch.cuda.Event()

    def record(self) -> None:
        self.event.record(torch.cuda.current_stream(self.device))

    def query(self) -> bool:
        return self.event.query()

    def synchronize(self) -> None:
        self.event.synchronize()


def _pinned_like(array: np.ndarray, device) -> torch.Tensor:
    """A page-locked host tensor of ``array``'s shape and dtype, pinned
    from ``device``'s context."""
    dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
    with torch.cuda.device(device):
        return torch.empty(array.shape, dtype=dtype, pin_memory=True)


class _Slot:
    def __init__(self, key, buffers: dict, done):
        self.key = key
        self.buffers = buffers                  # pinned tensors
        self.views = {k: b.numpy() for k, b in buffers.items()}
        self.done = done                        # recorded after the copies


class PinnedRing:
    """Host batches -> fresh tensors on a CUDA device through ``slots``
    page-locked staging buffers used in turn.

    Each upload copies the host arrays into its slot (a host memcpy), then
    starts non-blocking copies of the slot into new device tensors on the
    device's current stream and records the slot's event after them; the
    host goes on while the card copies and runs the work queued before.
    Before a slot is restaged, the host waits for that slot's event alone.
    A slot is keyed by the device and each array's key, shape and dtype,
    and made again when that changes (an epoch's short last batch, eval
    batches).  The tensors returned never alias the slots: a caller may
    keep them across uploads.  ``pin`` (array, device -> host tensor) and
    ``event`` (device -> an object with ``record``, ``query`` and
    ``synchronize``) are the CUDA calls; tests pass stand-ins.  One thread
    uploads."""

    def __init__(self, slots: int = RING_SLOTS, pin=_pinned_like,
                 event=_StreamEvent):
        self._pin, self._event = pin, event
        self._slots = [None] * slots
        self._turn = 0

    def upload(self, host: dict, device) -> dict:
        global ring_uploads, ring_waits
        i = self._turn
        self._turn = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None and not slot.done.query():
            ring_waits += 1
            slot.done.synchronize()
        key = (device, tuple((k, v.shape, v.dtype.str)
                             for k, v in host.items()))
        if slot is None or slot.key != key:
            slot = self._slots[i] = _Slot(
                key, {k: self._pin(v, device) for k, v in host.items()},
                self._event(device))
        for k, v in host.items():
            np.copyto(slot.views[k], v)
        out = {k: b.to(device, non_blocking=True, copy=True)
               for k, b in slot.buffers.items()}
        slot.done.record()
        ring_uploads += 1
        return out


_ring = PinnedRing()


def device_batch(cfg, batch, device, for_eval=False):
    """Host batch dict -> tensors on ``device``, the minimal transfer set
    of a train step (:func:`train_step_keys`) or an eval step
    (:func:`eval_batch_transform`).  On a CUDA device the arrays go
    through the process's :class:`PinnedRing` (new device tensors, copies
    still running when this returns, on the device's current stream); on
    the CPU they are zero-copy views of the host arrays.  On the card a
    captured step then copies these into its graph's static inputs,
    device to device: the upload stays here, so the eager bodies and the
    CPU path take the same batch."""
    global cpu_uploads
    if for_eval:
        host = eval_batch_transform(cfg)(batch)
    else:
        host = {k: batch[k] for k in train_step_keys(cfg)}
    device = torch.device(device)
    if device.type == "cuda":
        return _ring.upload(host, device)
    cpu_uploads += 1
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def validate(cfg, model, val_loader, meta, logger, evaluate_fn=None,
             output_dir: str = "", writer=None, global_step: int = 0,
             watchdog=None):
    """Full validation pass of ``model`` on its own device (reference
    function.py:189-332; ``fhpe_tpu/cli/common.py::validate`` on one
    device, with no mesh and no compiled-step cache).  ``watchdog``
    (``utils/watchdog.py``) beats after every batch and is disarmed
    across ``evaluate_fn``, which runs on the host and may take long on
    real annotation sets, as in ``fhpe_tpu``.

    With ``writer`` set, mirrors the reference's TB surface (valid_loss /
    valid_acc scalars + the name_values dict, function.py:304-330).  Under
    ``DEBUG.DEBUG`` with an ``output_dir`` the eval step also returns its
    heatmaps and targets, and every ``PRINT_FREQ`` batches the
    ``val_{i}_*.jpg`` dumps are written there (function.py:286-289); the
    first batch's grids go to ``writer`` as images.
    Returns (perf_indicator, name_values, all_preds, all_boxes, img_paths).
    """
    device = next(model.parameters()).device
    perm = flip_pair_permutation(meta["num_joints"], meta["flip_pairs"])
    prepare = (make_batch_preprocessor(cfg, meta["joints_weight"])
               if cfg.TPU.DEVICE_PREPROCESS else None)
    debug = bool(cfg.DEBUG.DEBUG and output_dir)
    eval_step = make_eval_step(cfg, flip_perm=perm, prepare=prepare,
                               debug_outputs=debug)

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
        if watchdog is not None:
            watchdog.beat()

        if i % cfg.PRINT_FREQ == 0:
            if logger:
                logger.info(
                    f"Test: [{i}/{n_batches}]\t"
                    f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                    f"Accuracy {accs.val:.3f} ({accs.avg:.3f})")
            if debug:
                debug_images(cfg, batch, out, os.path.join(output_dir,
                                                           f"val_{i}"))
                if i == 0:
                    tb_log_images(writer, "valid", cfg, batch["image"],
                                  batch["joints"],
                                  batch["joints_vis"][..., None],
                                  *_heatmaps(out), global_step)

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

    if watchdog is not None:
        watchdog.disarm()
    name_values, perf = evaluate_fn(cfg, all_preds, output_dir, all_boxes,
                                    img_paths)
    if watchdog is not None:
        watchdog.beat()
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


def _heatmaps(out: dict):
    """(target, output) of a debug step's result as float32 numpy."""
    return tuple(out[k].float().cpu().numpy() for k in ("target", "output"))


def debug_images(cfg, batch, out, prefix: str) -> None:
    """``save_debug_images`` of a host batch and a debug step's result
    (``"target"``, ``"output"``): ``{prefix}_gt.jpg``, ``_pred.jpg``,
    ``_hm_gt.jpg``, ``_hm_pred.jpg`` as ``DEBUG.*`` asks."""
    save_debug_images(cfg, batch["image"], batch["joints"],
                      batch["joints_vis"][..., None], *_heatmaps(out),
                      prefix)


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
