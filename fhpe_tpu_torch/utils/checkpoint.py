"""Checkpoint save / load / auto-resume, as ``torch.save`` files.

Counterpart of ``fhpe_tpu/utils/checkpoint.py`` with the reference's file
names and layout (``lib/utils/utils.py:78-83,204-258``,
``tools/train.py:192-202,230-245``):

* ``checkpoint.pth``: ``{epoch, model, state_dict, best_state_dict, perf,
  optimizer}`` (the reference's keys) plus ``step``, the optimizer steps
  taken;
* ``model_best.pth`` (on improvement) and ``final_state.pth`` (at the
  end): a model ``state_dict``;
* ``checkpoint_meta.json``: ``{epoch, perf}``, as ``fhpe_tpu`` writes it.

As in ``fhpe_tpu``, writes are atomic (tmp + ``os.replace``) and
asynchronous: the snapshot to host memory happens on the caller, the
file write on one background thread per run directory with one write in
flight.  ``flush_pending`` joins outstanding writes; every read path calls
it first.  :func:`load_model_weights` reads the reference's released
``.pth`` files too (a bare ``state_dict``, ``{"state_dict"}``,
``{"best_state_dict"}``, ``module.``-prefixed keys), and, given the
model's config, ``fhpe_tpu``'s ``.msgpack`` weight files.  In a process group
the CLIs write on rank 0 alone, and :func:`auto_resume_multihost` hands
rank 0's checkpoint to every rank.

AUTO_RESUME reads ``checkpoint.pth`` where it is, else ``fhpe_tpu``'s
``checkpoint.msgpack`` (its whole ``TrainState``: weights, BatchNorm
statistics, step and optax state, with epoch and perf), carried over to
the port's names and ``torch.optim`` state (``utils/convert.py``); the
port then goes on writing ``checkpoint.pth``, which the next resume takes.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from ..parallel import broadcast_object, initialized, is_main_process
from . import msgpack
from .convert import optimizer_state_from_jax, state_dict_from_jax

CKPT_NAME = "checkpoint.pth"
JAX_CKPT_NAME = "checkpoint.msgpack"        # fhpe_tpu's rolling checkpoint
BEST_NAME = "model_best.pth"
FINAL_NAME = "final_state.pth"
META_NAME = "checkpoint_meta.json"

log = logging.getLogger(__name__)


class _DirWriter:
    """Async write queue for ONE output directory (concurrent runs in one
    process never serialize through a shared queue, and ``flush_pending``
    never joins another run's writes)."""

    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.pending = []

    def flush(self):
        while self.pending:
            self.pending.pop(0).result()


_writers: Dict[str, _DirWriter] = {}


def _writer_for(output_dir: str) -> _DirWriter:
    key = os.path.abspath(output_dir)
    if key not in _writers:
        _writers[key] = _DirWriter()
    return _writers[key]


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory (also CPU
    tensors: the next step updates the live ones in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, _to_host(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):       # a module state_dict's versions
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _submit(output_dir: str, work) -> None:
    writer = _writer_for(output_dir)
    writer.pending.append(writer.pool.submit(work))


def flush_pending(output_dir: str) -> None:
    """Join ``output_dir``'s in-flight checkpoint writes (re-raises their
    errors)."""
    key = os.path.abspath(output_dir)
    if key in _writers:
        _writers[key].flush()


def save_checkpoint(output_dir: str, state, epoch: int, perf: float,
                    is_best: bool, model_name: str = "") -> None:
    """Write the rolling checkpoint of ``state`` (a ``TrainState``);
    snapshot the weights to ``model_best.pth`` on best perf."""
    os.makedirs(output_dir, exist_ok=True)
    # Snapshot to host on the caller; at most one write in flight, so
    # memory holds one extra state copy.
    _writer_for(output_dir).flush()
    weights = _to_host(state.model.state_dict())
    payload = {"epoch": epoch, "model": model_name, "state_dict": weights,
               "best_state_dict": weights, "perf": float(perf),
               "optimizer": _to_host(state.optimizer.state_dict()),
               "step": int(state.step)}

    def work():
        _save_atomic(payload, os.path.join(output_dir, CKPT_NAME))
        meta = json.dumps({"epoch": epoch, "perf": float(perf)})
        tmp = os.path.join(output_dir, META_NAME + ".tmp")
        with open(tmp, "w") as f:
            f.write(meta)
        os.replace(tmp, os.path.join(output_dir, META_NAME))
        if is_best:
            _save_atomic(weights, os.path.join(output_dir, BEST_NAME))

    _submit(output_dir, work)


def save_best(output_dir: str, state) -> None:
    """Snapshot ONLY ``model_best`` (no rolling checkpoint).

    Needed when TRAIN.CKPT_FREQ skips the rolling checkpoint of an eval
    epoch that nevertheless set a new best: ``best_perf`` keeps ratcheting
    up in the epoch loop, so without this write the best weights would be
    lost and later, worse, epochs could never qualify."""
    os.makedirs(output_dir, exist_ok=True)
    _writer_for(output_dir).flush()
    weights = _to_host(state.model.state_dict())
    _submit(output_dir,
            lambda: _save_atomic(weights, os.path.join(output_dir, BEST_NAME)))


def save_weights(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s ``state_dict`` to ``path`` now, atomically (the
    layout of ``model_best.pth`` and ``final_state.pth``)."""
    _save_atomic(_to_host(model.state_dict()), path)


def release_writer(output_dir: str) -> None:
    """Flush and retire a run's async writer (end of run); without this
    every output dir leaks one parked writer thread."""
    w = _writers.pop(os.path.abspath(output_dir), None)
    if w is not None:
        w.flush()
        w.pool.shutdown(wait=True)


def save_final_state(output_dir: str, state) -> None:
    flush_pending(output_dir)
    save_weights(os.path.join(output_dir, FINAL_NAME), state.model)
    release_writer(output_dir)


def _numpy_scalar_globals() -> list:
    """What a pickled numpy scalar needs (the reference's checkpoints
    store ``perf`` as one): its dtype and the scalar constructor."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype,
            type(np.dtype(np.float64)), type(np.dtype(np.float32))]


def load_checkpoint_file(path: str) -> Any:
    """The object in a ``.pth`` file, on the CPU, through torch's
    weights-only unpickler (tensors, containers, numbers, strings and
    numpy scalars; no other object is built and no code runs)."""
    flush_pending(os.path.dirname(path) or ".")
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_model_weights(path: str, cfg=None) -> Dict[str, torch.Tensor]:
    """A model ``state_dict`` from any of the layouts the reference and
    this module write (``fhpe_tpu/utils/torch_import.py::
    load_torch_state_dict``): a bare ``state_dict``, a checkpoint with
    ``state_dict`` or ``best_state_dict``; a ``module.`` prefix (the
    reference's DataParallel) is dropped.

    A ``.msgpack`` file is one of ``fhpe_tpu``'s (``final_state``,
    ``model_best`` or a full ``checkpoint``), read by :func:`_msgpack_weights`
    for the model ``cfg`` describes.  The extension decides: a torch pickle
    begins with the byte 0x80, which is also a MessagePack map."""
    if str(path).endswith(".msgpack"):
        if cfg is None:
            raise ValueError(
                f"{path}: a .msgpack weight file holds fhpe_tpu's flax tree, "
                f"and mapping it to this model's parameter names needs the "
                f"model's config: load_model_weights(path, cfg)")
        return _msgpack_weights(path, cfg)
    ckpt = load_checkpoint_file(path)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "best_state_dict" in ckpt:
        ckpt = ckpt["best_state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.float().numpy() if tree.dtype == torch.bfloat16 \
        else tree.numpy()


def _msgpack_weights(path: str, cfg) -> Dict[str, torch.Tensor]:
    """``fhpe_tpu``'s weights (``fhpe_tpu/utils/checkpoint.py::
    load_model_weights``: a full checkpoint's ``state.params`` and
    ``state.batch_stats``, else ``params`` and ``batch_stats``) as the
    ``state_dict`` of ``get_pose_net(cfg)``.

    An hourglass trained with ``TPU.DEAD_BIAS_SKIP`` (the one model it
    changes) has no bias on the convs that a BatchNorm follows.  Where
    ``cfg``'s model has such a bias, it gets zeros, which compute the same
    thing."""
    flush_pending(os.path.dirname(path) or ".")
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    return _tree_weights(payload["state"] if "state" in payload else payload,
                         cfg)


def _tree_weights(tree: dict, cfg) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a read ``.msgpack`` tree -> the
    ``state_dict`` of ``get_pose_net(cfg)`` (:func:`_msgpack_weights`)."""
    from ..models import get_pose_net

    sd = state_dict_from_jax(cfg, {
        "params": _numpy_tree(tree["params"]),
        "batch_stats": _numpy_tree(tree.get("batch_stats", {}))})
    if cfg.MODEL.NAME != "hourglass":
        return sd
    with torch.device("meta"):
        want = get_pose_net(cfg).state_dict()
    for k, v in want.items():
        weight = k[:-len("bias")] + "weight"
        if k.endswith(".bias") and k not in sd and weight in sd:
            sd[k] = torch.zeros(v.shape, dtype=sd[weight].dtype)
    return sd


def _load_optimizer_state(optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` that keeps what belongs to
    this device: each group's ``capturable`` flag and the kind of its rate
    (a float32 tensor on the card's parameters' device, read by a captured
    step; a float on the CPU), holding the saved value.  A checkpoint
    written on the card resumes on the CPU and the other way round."""
    groups = []
    for live, group in zip(optimizer.param_groups, saved["param_groups"],
                           strict=True):
        group = dict(group)
        if "capturable" in live:
            group["capturable"] = live["capturable"]
        rate = float(group["lr"])
        group["lr"] = (torch.tensor(rate, dtype=torch.float32,
                                    device=live["lr"].device)
                       if isinstance(live["lr"], torch.Tensor) else rate)
        groups.append(group)
    optimizer.load_state_dict(dict(saved, param_groups=groups))


def _read_resume(output_dir: str, state, cfg=None):
    """``output_dir``'s rolling checkpoint as a ``.pth`` payload:
    ``checkpoint.pth`` where it is, else ``fhpe_tpu``'s
    ``checkpoint.msgpack`` carried over (:func:`_msgpack_resume`, which
    needs ``cfg``); None when neither is there.  Logs the file it read."""
    flush_pending(output_dir)
    path = os.path.join(output_dir, CKPT_NAME)
    if os.path.exists(path):
        log.info(f"=> reading the resume checkpoint {path}")
        return load_checkpoint_file(path)
    path = os.path.join(output_dir, JAX_CKPT_NAME)
    if not os.path.exists(path):
        return None
    if cfg is None:
        raise ValueError(
            f"{path}: fhpe_tpu's checkpoint holds flax and optax trees, and "
            f"mapping them to this model and optimizer needs the run's "
            f"config: auto_resume(output_dir, state, cfg)")
    log.info(f"=> reading fhpe_tpu's resume checkpoint {path}")
    return _msgpack_resume(path, cfg, state)


def _msgpack_resume(path: str, cfg, state) -> dict:
    """``fhpe_tpu``'s ``checkpoint.msgpack``
    (``fhpe_tpu/utils/checkpoint.py::save_checkpoint``: ``{epoch, perf,
    state: {step, params, batch_stats, opt_state}}``) as the payload of a
    ``checkpoint.pth`` for ``state``'s model and optimizer: the weights
    and BatchNorm statistics (``state_dict_from_jax``), the optimizer's
    state from optax's (``optimizer_state_from_jax``: Adam's moments and
    count, or SGD's trace; another optimizer than ``TRAIN.OPTIMIZER`` is
    refused), the step, epoch and perf.  The rate is not read: the epoch
    loop sets it from the schedule."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    tree = _numpy_tree(payload["state"])
    try:
        optimizer = optimizer_state_from_jax(cfg, state.optimizer,
                                             state.model, tree["opt_state"])
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return {"epoch": int(payload["epoch"]), "perf": float(payload["perf"]),
            "state_dict": _tree_weights(tree, cfg), "optimizer": optimizer,
            "step": int(tree["step"])}


def _resume_from(state, payload):
    if payload is None:
        return state, None, None
    state.model.load_state_dict(payload["state_dict"])
    _load_optimizer_state(state.optimizer, payload["optimizer"])
    state.step = int(payload.get("step", 0))
    return state, int(payload["epoch"]), float(payload["perf"])


def auto_resume(output_dir: str, state, cfg=None):
    """(state, begin_epoch, perf) from ``output_dir``'s rolling checkpoint
    (:func:`_read_resume`: the port's ``checkpoint.pth``, else
    ``fhpe_tpu``'s ``checkpoint.msgpack`` read for ``cfg``), or (state,
    None, None) when there is none.  Restores the weights, the optimizer
    (Adam's moments and step counts or SGD's momentum, cast by
    ``optimizer.load_state_dict`` to the parameters' device and dtype) and
    the step count in place, before any step of the run is captured."""
    return _resume_from(state, _read_resume(output_dir, state, cfg))


def auto_resume_multihost(output_dir: str, state, cfg=None):
    """AUTO_RESUME in a process group: rank 0 decides, every rank follows
    (``fhpe_tpu``'s ``auto_resume_multihost``).

    Only rank 0 writes checkpoints, so a rank reading its own disk would
    resume at another epoch than rank 0, and the ranks' steps and rates
    would part.  Rank 0 reads its checkpoint (either file, as
    :func:`auto_resume`) and broadcasts it, weights, BatchNorm buffers,
    optimizer state, epoch and perf, as one object; every rank then loads
    it as :func:`auto_resume` does.  No shared filesystem is assumed.
    Without a group: :func:`auto_resume`."""
    if not initialized():
        return auto_resume(output_dir, state, cfg)
    payload = (_read_resume(output_dir, state, cfg) if is_main_process()
               else None)
    return _resume_from(state, broadcast_object(payload))
