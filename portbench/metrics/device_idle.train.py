"""Percent of the traced stretch in which the device ran no kernel, copy
or fill (the profiler's device events, over the stretch's host-clock
length)."""

from ._shares import idle


def read(r):
    return idle(r)
