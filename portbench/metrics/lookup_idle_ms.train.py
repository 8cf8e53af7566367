"""Milliseconds per step in which the device is idle while the loop's thread
finds the step's graph: signature, dict lookup and storage fingerprint
(``fhpe.graph.lookup``, ``utils/graph.py::CapturedStep``), from the
traced stretch's spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, "fhpe.graph.lookup")
