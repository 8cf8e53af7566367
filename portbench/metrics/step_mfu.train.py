"""Percent of the card's bf16 peak the training steps reach: the FLOPs one
image needs (the teacher's forward, the student's forward and backward,
counted on the reference) times the images the traced stretch's steps
consumed, over the stretch's length."""

from ._shares import mfu


def read(r):
    return mfu(r)
