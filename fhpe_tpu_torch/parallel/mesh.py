"""Data parallelism: one process per device under ``torchrun``.

Counterpart of ``fhpe_tpu/parallel/mesh.py``.  ``fhpe_tpu`` runs one SPMD
program over a 1-D ``data`` mesh and averages the gradients with a
``pmean`` inside ``shard_map``; here each device has its own process,
launched by ``torchrun --nproc_per_node N``, and the train steps call the
collectives below where ``fhpe_tpu``'s call ``pmean`` / ``psum``
(``train/step.py``).  On the card the steps are captured CUDA graphs, and
the NCCL collectives are captured inside them.

* :func:`initialize` (``initialize_multihost``) joins the process group
  from ``torchrun``'s environment: NCCL for ``cuda`` (device
  ``cuda:LOCAL_RANK``), gloo for ``cpu``;
* :func:`process_index`, :func:`process_count`, :func:`is_main_process`;
* :func:`resolve_num_devices` (``get_mesh``'s sizing) holds
  ``TPU.NUM_DEVICES`` to the world size;
* :func:`all_reduce_mean_` (``pmean``), :func:`all_reduce_sum_`
  (``psum``), :func:`broadcast_` (``_select_device0``) on tensors, in
  place, and :func:`broadcast_object` (``broadcast_one_to_all``).

Whenever a process group is initialized the helpers run their
collectives, also at world size 1; without one they return their input.

``shard_batch`` and ``prefetch_to_device`` have no counterpart: the
process-sharded ``BatchLoader`` yields each process its contiguous slice
of every global batch (``data/loader.py``), and
``cli/common.py::device_batch`` uploads it to the process's device.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

# Rank 0 validates alone (a whole COCO set) while the other ranks wait in
# the next step's first collective, so a collective may wait that long.
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(device_type: str = "cuda",
               timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
               ) -> Optional[torch.device]:
    """Join ``torchrun``'s process group and return this process's device
    (``cuda:LOCAL_RANK``, or ``cpu``); None, doing nothing, outside
    ``torchrun``.  NCCL for ``cuda``, gloo for ``cpu``.  A group this
    process already joined is kept."""
    if "WORLD_SIZE" not in os.environ:
        return None
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun's environment lacks {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group for device type {device_type!r}")
    if not initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def resolve_num_devices(cfg) -> int:
    """The number of devices a train step spans: ``TPU.NUM_DEVICES``, -1
    (or 0) for the world size.  One process per device, so a positive
    value must equal the world size, and above 1 needs ``torchrun``."""
    n = int(cfg.TPU.NUM_DEVICES)
    world = process_count()
    if n <= 0 or n == world:
        return world
    if not initialized():
        raise ValueError(
            f"TPU.NUM_DEVICES {n}: training over several devices runs one "
            f"process per device; launch it with torchrun --nproc_per_node "
            f"{n} -m fhpe_tpu_torch.cli.<train|fpd_train> ...")
    raise ValueError(f"TPU.NUM_DEVICES {n} but the world size is {world}; "
                     f"set it to -1 or {world}")


def _flat_in_place(tensors: Iterable[Optional[torch.Tensor]],
                   collective: Callable[[torch.Tensor], None]) -> None:
    """``collective`` on one flat buffer per dtype and device, the results
    copied back into ``tensors`` (None entries skipped) by one multi-tensor
    copy, not one kernel per tensor."""
    groups = {}
    for t in tensors:
        if t is not None:
            groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [p.view_as(t)
                                     for p, t in zip(parts, group)])


def all_reduce_sum_(tensors: List[Optional[torch.Tensor]]):
    """Sum each tensor over the ranks, in place (``psum``)."""
    if initialized():
        _flat_in_place(tensors, dist.all_reduce)
    return tensors


def all_reduce_mean_(tensors: List[Optional[torch.Tensor]]):
    """Average each floating tensor over the ranks, in place (``pmean``).
    NCCL averages in its own kernel (``ReduceOp.AVG``: each rank's value
    times 1 / world size, summed), which it runs at world size 1 too; gloo
    has no AVG, so there the sum is divided by the world size."""
    if initialized():
        if dist.get_backend() == "nccl":
            _flat_in_place(tensors, lambda flat: dist.all_reduce(
                flat, op=dist.ReduceOp.AVG))
        else:
            world = dist.get_world_size()

            def mean(flat):
                dist.all_reduce(flat)
                flat.div_(world)
            _flat_in_place(tensors, mean)
    return tensors


def broadcast_(tensors: List[Optional[torch.Tensor]], src: int = 0):
    """Every rank gets rank ``src``'s values, in place."""
    if initialized():
        _flat_in_place(tensors, lambda flat: dist.broadcast(flat, src))
    return tensors


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled; on NCCL through the
    current device)."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
