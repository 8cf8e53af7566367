"""Milliseconds per request in which the device is idle while no span is open
on the request's thread, from the traced stretch's spans (``_spans.py``)."""

from ._spans import SERVE_ROOT, UNTRACED, idle_ms


def read(r):
    return idle_ms(r, SERVE_ROOT, UNTRACED)
