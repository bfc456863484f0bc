"""Device ms per step (or view) in the forward's geometry, SH colour and
compositing glue: device ops in the ``gs::render`` span
(``rasterize.rasterize``) outside the ``gs::layout`` span and the kernels,
which have their own metrics.  Read in the training and the serving cells
alike; a program whose served view runs in no ``gs::render`` span gives
nothing to read there."""


def read(t):
    return t.ms_per_step("render")
