"""Milliseconds per step of host-to-device copies on the device (the
batch's upload), from the traced stretch."""

from .. import trace
from ._shares import per_step


def read(r):
    v = per_step(r, trace.copy_s(r["events"], "HtoD") * 1e3)
    return v if v else None
