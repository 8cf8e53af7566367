"""Milliseconds per step in which the device is idle while the loop's thread
sets the student's and the teacher's modes (``fhpe.train.modes``,
``train/step.py::_compiled_train_step``), from the traced stretch's
spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, "fhpe.train.modes")
