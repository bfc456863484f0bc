"""Device ms per step (or view) in the tile layout, the ``gs::layout`` span
(``culling.build_layout``)."""


def read(t):
    return t.ms_per_step("layout")
