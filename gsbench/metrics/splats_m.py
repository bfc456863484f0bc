"""Millions of (gaussian, tile) splats per view: the program's ``splats``
counter (the layouts' sizes, ``culling.build_layout``) over its ``views``
in the traced stretch.  The work of the layout's sort and of the
rasterizer kernels scales with it."""

from gsbench import counters


def read(t):
    v = counters.per(t, lambda k: k == "splats", ("views",))
    return None if v is None else v / 1e6
