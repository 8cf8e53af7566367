"""Milliseconds per request in which the device is idle while the request's
thread plans its chunks: inverse transforms, host and device slots, events,
streams (``fhpe.serve.plan``, ``serve/predictor.py::_run_chunks``), from
the traced stretch's spans (``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, "fhpe.serve.plan")
