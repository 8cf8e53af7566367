"""Milliseconds per step in which the device is idle while the loop's thread
replays the step's graph: the copies into its inputs, the graph's launch,
the output clones (``fhpe.graph.replay``, ``utils/graph.py::CapturedStep``),
from the traced stretch's spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, "fhpe.graph.replay")
