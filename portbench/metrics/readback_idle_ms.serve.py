"""Milliseconds per request in which the device is idle while the request's
thread reads a chunk's results back (``fhpe.serve.readback``,
``serve/predictor.py::_run_chunks``), from the traced stretch's spans
(``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, "fhpe.serve.readback")
