"""Device ms per step in the optimizer, the step skip and the
densification accumulators, the ``gs::adam`` span (``trainer.adam_step``,
``optim.update``, ``trainer.accumulate``)."""


def read(t):
    return t.ms_per_step("adam")
