"""Kernel B4, the per-pixel SH backward (csrc/render_sh_bwd.cu): its bound
over its device time, in percent (``work.roofline``)."""

from gsbench import work


def read(t):
    return work.roofline(t, "render_sh_bwd")
