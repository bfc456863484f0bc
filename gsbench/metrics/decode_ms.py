"""Device ms per step in the Scaffold-GS decode, forward and backward: the
program's ``decode_us`` counter (CUDA events around the decode's device
work, ``gaussian_splatting_torch.scaffold.decode``) over its ``steps`` in
the traced stretch.  A program that does not decode gives nothing."""

from gsbench import counters


def read(t):
    v = counters.per(t, lambda k: k == "decode_us", ("steps",))
    return None if not v else v / 1e3
