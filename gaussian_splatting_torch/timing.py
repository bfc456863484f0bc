"""The port's device timer, shared by ``chip_smoke.py`` and the probes.

On a CUDA device a call is timed alone, with a cold L2: each repetition
first reads a buffer larger than the H100's 50 MB L2 (evicting the previous
call's data, dirty lines included), then spins the device for ~1 ms while
the host enqueues the call between two CUDA events, so the events measure
the call's device time and not the host's launch overhead.  A call that
waits for the host inside (a Python loop over host values) still counts the
device's idle time between its launches.  On the CPU the clock is the
host's and each time is one call: there the sweeps check, they do not
measure.
"""

from __future__ import annotations

import time

import torch

L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock
REPS = 20  # timed calls of a kernel or a library call
PLAIN_REPS = 2  # timed calls of a plain version, slower by orders of magnitude


class Timer:
    """Mean time of one call of a function on ``device``, in ms."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.clock = "CUDA events, cold L2" if self.cuda else "host clock"
        self._flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                   device=self.device).fill_(1)
                       if self.cuda else None)

    def ms(self, fn, reps: int = REPS) -> float:
        fn()  # warm-up
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            self._flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(self.device)
        return sum(s.elapsed_time(e) for s, e in events) / reps


def compare(timer, kernel, plain, library=None):
    """(kernel, plain, library) ms, timed in the order plain, kernel,
    library, library, kernel, plain, each the mean of its two runs; library
    ms is None where there is no library call."""
    p1 = timer.ms(plain, PLAIN_REPS)
    k1 = timer.ms(kernel)
    lib = None
    if library is not None:
        lib = (timer.ms(library) + timer.ms(library)) / 2
    k2 = timer.ms(kernel)
    p2 = timer.ms(plain, PLAIN_REPS)
    return (k1 + k2) / 2, (p1 + p2) / 2, lib
