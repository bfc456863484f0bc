"""Blocking device-to-host reads per step, or per view where no step ran:
the program's ``sync.<site>`` counters (``gaussian_splatting_torch.
telemetry``) summed over the traced stretch.  Each read drains the
device's queue, and the device then waits while the host launches again."""

from gsbench import counters


def read(t):
    return counters.per(t, lambda k: k.startswith("sync."), ("steps", "views"))
