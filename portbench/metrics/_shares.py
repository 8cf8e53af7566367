"""Arithmetic the per-layer readers share."""

from __future__ import annotations

from .. import trace
from ..roofline import BF16_OPS_PER_S

# the program's kernels, by the names of their CUDA functions
P4_KERNELS = r"wgrad_(partial|reduce|bf16)"
P5_KERNELS = r"chain_(conv3x3|stats_reduce|block_output)"


def roofline(r, bound_key: str, kernels: str):
    """Percent: the least time of the stretch's calls over the time their
    kernels took; None where the kernels did not run."""
    spent = trace.kernel_s(r["events"], kernels)
    if spent <= 0 or not r.get(bound_key):
        return None
    return 100.0 * r[bound_key] / spent


def mfu(r):
    """Percent of the bf16 peak: operations per item times items over the
    stretch's length."""
    if r["window_s"] <= 0 or not r.get("items"):
        return None
    return 100.0 * r["flop_per_item"] * r["items"] / r["window_s"] \
        / BF16_OPS_PER_S


def idle(r):
    return trace.idle_share(r["events"], r["window_s"])


def per_step(r, value):
    return value / r["steps"] if r.get("steps") else None
