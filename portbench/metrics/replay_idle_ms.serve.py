"""Milliseconds per request in which the device is idle while the request's
thread replays a chunk's graph: the copies into its inputs, the graph's
launch, the output clones (``fhpe.graph.replay``,
``utils/graph.py::CapturedStep``), from the traced stretch's spans
(``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, "fhpe.graph.replay")
