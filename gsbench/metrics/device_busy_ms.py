"""Device-busy ms per step (or view): the union of the traced stretch's
device-op intervals over its steps.  The device's work alone, without the
host's pace, which moves the end-to-end times from machine to machine;
read in the training and the serving cells alike."""


def read(t):
    return t.busy_per_step_s * 1e3
