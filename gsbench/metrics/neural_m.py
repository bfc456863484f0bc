"""Millions of neural gaussians' rows a Scaffold-GS step hands the layout: the
program's ``neural`` counter (``gaussian_splatting_torch.scaffold.decode``)
over its ``steps`` in the traced stretch.  The geometry, the layout and the
backward's glue scale with it."""

from gsbench import counters


def read(t):
    v = counters.per(t, lambda k: k == "neural", ("steps",))
    return None if not v else v / 1e6
