"""Device ops the host launches per step (graph launches, kernels, copies
and fills), from the runtime calls of the traced stretch."""

from .. import trace
from ._shares import per_step


def read(r):
    n = trace.launches(r["events"])
    return per_step(r, float(n)) if n else None
