"""Milliseconds per step in which the device is idle while the loop's thread
uploads the batch (``fhpe.train.upload``, ``cli/common.py::device_batch``),
from the traced stretch's spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, "fhpe.train.upload")
