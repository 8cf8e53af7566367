"""Milliseconds per request in which the device is idle while the request's
thread runs the request's own code, outside its other spans: the input
checks, handing chunks to the prefetch thread, starting the result copies
(``fhpe.serve.request``, ``serve/predictor.py::predict_crops``), from the
traced stretch's spans (``_spans.py``)."""

from ._spans import SERVE_ROOT, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, SERVE_ROOT)
