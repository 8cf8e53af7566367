"""Percent: the least time of the traced stretch's HRNet branch chains
(P5, ``ops/csrc/branch_chain.cu``; each chain's bytes and operations from
the networks' shapes) over the time the P5 kernels took."""

from ._shares import P5_KERNELS, roofline


def read(r):
    return roofline(r, "p5_bound_s", P5_KERNELS)
