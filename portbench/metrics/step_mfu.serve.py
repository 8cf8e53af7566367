"""Percent of the card's bf16 peak the serving steps reach: the FLOPs of
the flip test's two forwards per real crop (counted on the reference)
times the crops the traced stretch served, over its length; padding rows
count for nothing."""

from ._shares import mfu


def read(r):
    return mfu(r)
