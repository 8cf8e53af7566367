"""The port's one roofline (``utils/profiling.py``: the card's peak rates
and ``bound``) and the union of device intervals that ``busy_ms`` reads
from a trace, on the CPU."""

import pytest

from fhpe_tpu_torch.utils.profiling import (BF16_OPS_PER_S, FP32_OPS_PER_S,
                                            HBM_BYTES_PER_S, bound, busy_ms)
from torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("nbytes,ops,ops_per_s,want_ms,by", [
    # 3.35 GB at 3.35 TB/s: 1 ms; 1 GFLOP of float32 would take 0.0149 ms
    (3.35e9, 1e9, FP32_OPS_PER_S, 1.0, "bytes"),
    # 989 GFLOP of bf16 at 989 TFLOP/s: 1 ms; 1 MB would take 0.0003 ms
    (1e6, 989e9, BF16_OPS_PER_S, 1.0, "operations"),
    # the default rate is float32's: 67 GFLOP take 1 ms
    (0, 67e9, None, 1.0, "operations")])
def test_bound_takes_the_larger_of_bytes_and_operations(nbytes, ops,
                                                        ops_per_s, want_ms,
                                                        by):
    args = (nbytes, ops) if ops_per_s is None else (nbytes, ops, ops_per_s)
    got = bound(*args)
    assert got["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    assert got["bound_by"] == by
    assert HBM_BYTES_PER_S == 3.35e12


def test_busy_ms_counts_overlapping_events_once():
    events = [{"ts": 0, "dur": 1000}, {"ts": 500, "dur": 1000},
              {"ts": 3000, "dur": 500}, {"ts": 3100, "dur": 100}]
    assert busy_ms(events) == pytest.approx(2.0)
    assert busy_ms([]) == 0.0
