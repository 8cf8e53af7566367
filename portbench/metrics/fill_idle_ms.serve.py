"""Milliseconds per request in which the device is idle while the request's
thread waits for the prefetch thread's fill of a chunk
(``fhpe.serve.wait_fill``, ``serve/predictor.py::_run_chunks``), from the
traced stretch's spans (``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, "fhpe.serve.wait_fill")
