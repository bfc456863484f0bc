"""Kernel B1, the DC forward (csrc/render_fwd.cu), with its pack and tile
order: its bound over its device time, in percent (``work.roofline``).
Read in the training and the serving cells alike."""

from gsbench import work


def read(t):
    return work.roofline(t, "render_fwd")
