"""Kernel B2, the DC backward (csrc/render_bwd.cu): its bound over its
device time, in percent (``work.roofline``)."""

from gsbench import work


def read(t):
    return work.roofline(t, "render_bwd")
