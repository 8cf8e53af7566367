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
``{"best_state_dict"}``, ``module.``-prefixed keys).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

CKPT_NAME = "checkpoint.pth"
BEST_NAME = "model_best.pth"
FINAL_NAME = "final_state.pth"
META_NAME = "checkpoint_meta.json"


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


def load_model_weights(path: str) -> Dict[str, torch.Tensor]:
    """A model ``state_dict`` from any of the layouts the reference and
    this module write (``fhpe_tpu/utils/torch_import.py::
    load_torch_state_dict``): a bare ``state_dict``, a checkpoint with
    ``state_dict`` or ``best_state_dict``; a ``module.`` prefix (the
    reference's DataParallel) is dropped."""
    ckpt = load_checkpoint_file(path)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "best_state_dict" in ckpt:
        ckpt = ckpt["best_state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


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


def auto_resume(output_dir: str, state):
    """(state, begin_epoch, perf) from ``output_dir``'s rolling checkpoint,
    or (state, None, None) when there is none.  Restores the weights, the
    optimizer (Adam's moments and step counts, cast by
    ``optimizer.load_state_dict`` to the parameters' device and dtype) and
    the step count in place."""
    flush_pending(output_dir)
    path = os.path.join(output_dir, CKPT_NAME)
    if not os.path.exists(path):
        return state, None, None
    payload = load_checkpoint_file(path)
    state.model.load_state_dict(payload["state_dict"])
    _load_optimizer_state(state.optimizer, payload["optimizer"])
    state.step = int(payload.get("step", 0))
    return state, int(payload["epoch"]), float(payload["perf"])
