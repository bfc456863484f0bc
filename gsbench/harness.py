"""What every kind of traffic shares, and the kind of a cell found by name.

A kind is ``traffic/<kind>.py``, named by the ``kind`` of the cell's mix
(``traffic/<mix>.json``).  Its ``make(cell, seed, device)`` returns an
object whose set-up makes the inputs from the seed and warms every shape,
with ``run(seconds, traced, t_process) -> Result``: one whole run of the
cell, and ``program()`` / ``reference(...)``: the outcomes that ``correct``
compares, which ``readings`` also makes without a window, for the limits.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from gsbench import spec
from gsbench import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_splatting_tpu")
GIB = float(1 << 30)
TRACE_GRACE_S = 120.0  # how long a traced run may run past its window


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


_T0 = time.perf_counter()


def log(msg: str):
    """A progress line on standard error, with the seconds since import."""
    print(f"[gsbench {time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Result:
    """What a run reports: the metrics, work counts, the checks, the
    traced stretch (with ``--trace 1``) and the memory peak."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict
    checks: dict
    peak_bytes: int
    trace: trace_mod.Trace | None = None


def warm_profiler(device):
    """Start the profiler once in set-up: its first start loads and
    initialises the device tracer, which takes seconds."""
    p = profile(device)
    p.start()
    torch.ones(1, device=device).add_(1)
    sync(device)
    p.stop()


def window_open(t0, seconds, traced, tr) -> bool:
    """The window runs ``seconds``, and in a traced run on until its traced
    stretch has ended."""
    elapsed = time.perf_counter() - t0
    if traced and tr is None:
        if elapsed > seconds + TRACE_GRACE_S:
            raise RuntimeError("the traced stretch did not end within "
                               f"{TRACE_GRACE_S} s of the window's end")
        return True
    return elapsed < seconds


def profile(device):
    """A profiler of the host's operators and, on a card, its device ops."""
    from torch import profiler

    acts = [profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(profiler.ProfilerActivity.CUDA)
    return profiler.profile(activities=acts)


def make(cell, seed: int, device):
    """The run of ``cell`` on ``seed``, by its kind's ``make``."""
    return spec.load_module("traffic", cell.traffic["kind"]).make(cell, seed, device)
