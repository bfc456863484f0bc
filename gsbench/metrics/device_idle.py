"""Percent of the traced stretch in which no operation runs on the device:
1 - the union of its device ops' intervals over the stretch's length, the
result's ``device.busy_s`` over ``device.window_s``.  Read in the training
and the serving cells alike.  The profiler's own host work slows the host
in the stretch, so this reads higher than an untraced step would."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s)
