"""Milliseconds per request in which the device is idle while the request's
thread finds a chunk's graph: signature, dict lookup and storage
fingerprint (``fhpe.graph.lookup``, ``utils/graph.py::CapturedStep``), from
the traced stretch's spans (``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, "fhpe.graph.lookup")
