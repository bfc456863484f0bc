"""Kernel B3, the per-pixel SH forward (csrc/render_sh_fwd.cu), with its
pack and tile order: its bound over its device time, in percent
(``work.roofline``)."""

from gsbench import work


def read(t):
    return work.roofline(t, "render_sh_fwd")
