"""Percent: the least time of the traced steps' 3x3 filter gradients (P4,
``ops/csrc/conv_wgrad.cu``; each call's bytes and operations from the
student's shapes) over the time the P4 kernels took."""

from ._shares import P4_KERNELS, roofline


def read(r):
    return roofline(r, "p4_bound_s", P4_KERNELS)
