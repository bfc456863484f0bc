"""The port's spans and counters, in one registry.

``span(name)`` marks a stretch of host code; ``count(name, n)`` adds to a
counter.  Both record only while recording is on: while a torch profiler
records (``torch.autograd.profiler._is_profiler_enabled``), or inside a
``recording()`` block.  Otherwise ``span`` returns one shared no-op and
``count`` returns at once: no allocation, no launch, no synchronise.

A span is a profiler event on the profiler's own clock, so a trace shows
it beside the device ops it launched.  The five layer spans (``LAYERS``)
are ``record_function`` ranges, which the profiler also draws on the
device timeline, where a trace's reader attributes device ops by them.
Every other span (``gs::layout.sort``, ``gs::render.geometry``, ...) is a
host-only event (``_RecordFunctionFast``): a reader that takes each
device-timeline event outside the layers for a device op never sees it.

Recording fills a window: it opens at the first span or count that
arrives while recording is on and closes at the first one after
recording stops, so two profiled stretches with no span or count between
them share one window.  ``window()`` gives the last window, open or
closed: its counters and, for each span name, its calls and host seconds.
Under a profiler that is the profiled stretch.  Nothing is written to disk
here.

Counters the program keeps (each added where it happens):

- ``sync.<site>``: 1 at each blocking device-to-host read;
- ``splats``, ``visible``, ``truncated_cells``: each layout's sizes;
- ``steps``: ``trainer.train_step`` calls; ``views``: ``rasterize`` calls
  and Scaffold-GS renders (``scaffold.render``);
- ``anchors``, ``neural``: the anchors a Scaffold-GS view decodes and the
  neural gaussians' rows it hands the layout (``scaffold.decode``);
- ``decode_us``: device microseconds of the Scaffold-GS decode, forward
  and backward, from CUDA events (``device_timer``).

A ``device_timer`` counter is read from CUDA events recorded on the
stream, never inside a step: the window resolves the events that have run
when it closes, and ``window()`` waits for the rest.

``LAUNCHES`` counts kernel launches by kernel name, always, recording or
not: each wrapper adds one where it launches its kernel and nowhere else,
so a caller can show which kernels a run went through.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

LAYERS = frozenset(("gs::render", "gs::layout", "gs::loss", "gs::backward", "gs::adam"))

LAUNCHES: collections.Counter = collections.Counter()


class _Window:
    """One stretch of recording: counters, and per span name its calls and
    host nanoseconds; opened and closed on ``time.time_ns()``, the clock
    of the profiler's events."""

    __slots__ = ("counters", "calls", "ns", "opened_ns", "closed_ns", "pending")

    def __init__(self):
        self.counters = collections.Counter()
        self.calls = collections.Counter()
        self.ns = collections.Counter()
        self.opened_ns = time.time_ns()
        self.closed_ns = None
        self.pending = []  # (counter, start event, end event) of device timers

    def resolve(self, wait: bool):
        """Add each pending device interval whose end event has run to its
        counter, in microseconds; with ``wait``, wait for the rest first."""
        left = []
        for name, start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((name, start, end))
                continue
            self.counters[name] += start.elapsed_time(end) * 1e3
        self.pending = left

    def as_dict(self) -> dict:
        return dict(counters=dict(self.counters),
                    spans={k: dict(calls=self.calls[k], host_s=self.ns[k] * 1e-9)
                           for k in self.calls},
                    opened_ns=self.opened_ns, closed_ns=self.closed_ns)


_forced = 0  # open recording() blocks
_open = None  # the window recording fills, if any
_last = None  # the newest window, open or closed


def _window():
    """The window to record into, opened or closed to match whether
    recording is on; None while it is off."""
    global _open, _last
    if _forced or _profiler._is_profiler_enabled:
        if _open is None:
            _open = _last = _Window()
        return _open
    _close()
    return None


def _close():
    global _open
    if _open is not None:
        _open.closed_ns = time.time_ns()
        _open.resolve(wait=False)
        _open = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "window", "event", "t0")

    def __init__(self, name, window):
        self.name, self.window = name, window
        self.event = (record_function if name in LAYERS else _RecordFunctionFast)(name)

    def __enter__(self):
        self.event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.event.__exit__(*exc)
        self.window.calls[self.name] += 1
        self.window.ns[self.name] += dt
        return False


def span(name: str):
    """A context manager that marks host code as the span ``name``."""
    if not (_forced or _profiler._is_profiler_enabled or _open is not None):
        return _NO_SPAN
    w = _window()
    return _NO_SPAN if w is None else _Span(name, w)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if not (_forced or _profiler._is_profiler_enabled or _open is not None):
        return
    w = _window()
    if w is not None:
        w.counters[name] += n


class _DeviceTimer:
    """Device intervals on the current CUDA stream, each from a ``start()``
    to the next ``stop()``, for the window's counter ``name``."""

    __slots__ = ("name", "window", "started")

    def __init__(self, name, window):
        self.name, self.window, self.started = name, window, None

    def start(self):
        self.started = torch.cuda.Event(enable_timing=True)
        self.started.record()

    def stop(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.window.pending.append((self.name, self.started, end))


def device_timer(name: str, device):
    """A timer whose intervals add their device microseconds to the counter
    ``name``, or None: while recording is off, or off a CUDA ``device``.
    Its events are read when the window closes (those that have run) or
    by ``window()``."""
    if device.type != "cuda" or not (
            _forced or _profiler._is_profiler_enabled or _open is not None):
        return None
    w = _window()
    return None if w is None else _DeviceTimer(name, w)


@contextlib.contextmanager
def recording():
    """Record inside the block, with no profiler: a new window opens at the
    first span or count and closes at the block's end."""
    global _forced
    if not (_forced or _profiler._is_profiler_enabled):
        _close()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1
        if not (_forced or _profiler._is_profiler_enabled):
            _close()


def window():
    """The newest window as a dict (``counters``; ``spans``: name ->
    ``calls``, ``host_s``; ``opened_ns``, ``closed_ns`` on
    ``time.time_ns()``, ``closed_ns`` None while it is open), or None if
    nothing has been recorded.  Waits for the window's device timers."""
    if _last is None:
        return None
    _last.resolve(wait=True)
    return _last.as_dict()
