"""The program's own counters over the traced stretch: the window of
``gaussian_splatting_torch.telemetry`` that the stretch's profiler opened
and closed (the program counts while a profiler records).  A program
without that module, or a window that does not cover the stretch, gives
nothing to read."""

from __future__ import annotations


def window():
    """The program's newest telemetry window (a dict), or None."""
    try:
        from gaussian_splatting_torch import telemetry
    except ImportError:  # a program that keeps no counters
        return None
    return telemetry.window()


def per(t, names, over: tuple):
    """The sum of the window's counters whose name ``names`` accepts, over
    the first of its counts ``over`` (``steps``, ``views``) that is not
    zero; None without a window, or where that count is not the traced
    stretch's ``t.steps``."""
    w = window()
    if w is None:
        return None
    c = w["counters"]
    n = next((c[k] for k in over if c.get(k)), 0)
    if n != t.steps:
        return None
    return sum(v for k, v in c.items() if names(k)) / n
