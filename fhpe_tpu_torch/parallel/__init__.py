"""Data parallelism over one process per device (counterpart of
``fhpe_tpu.parallel``)."""

from .mesh import (all_reduce_mean_, all_reduce_sum_, backend, broadcast_,
                   broadcast_object, initialize, initialized,
                   is_main_process, process_count, process_index,
                   resolve_num_devices, shutdown)

__all__ = ["all_reduce_mean_", "all_reduce_sum_", "backend", "broadcast_",
           "broadcast_object", "initialize", "initialized",
           "is_main_process", "process_count", "process_index",
           "resolve_num_devices", "shutdown"]
