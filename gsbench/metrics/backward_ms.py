"""Device ms per step in the backward's glue: device ops in the
``gs::backward`` span or in no span (autograd through SSIM, L1, the
compositing glue and the geometry, launched from autograd's own thread),
without the backward kernels B2 and B4, which have their own metrics."""


def read(t):
    s = t.parts.get("backward", 0.0) + t.parts.get("unspanned", 0.0)
    return s / t.steps * 1e3 if s > 0 else None
