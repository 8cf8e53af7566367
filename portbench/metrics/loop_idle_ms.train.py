"""Milliseconds per step in which the device is idle while the loop's thread
runs the train loop's own code: inside ``fhpe.train.step`` but outside its
other spans, or in ``fhpe.train.meters`` (``cli/train.py::run_epoch``),
from the traced stretch's spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, TRAIN_ROOT, "fhpe.train.meters")
