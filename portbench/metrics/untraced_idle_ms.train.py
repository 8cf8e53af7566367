"""Milliseconds per step in which the device is idle while no span is open on
the loop's thread, from the traced stretch's spans (``_spans.py``)."""

from ._spans import TRAIN_ROOT, UNTRACED, idle_ms


def read(r):
    return idle_ms(r, TRAIN_ROOT, UNTRACED)
