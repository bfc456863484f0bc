"""The device trace of a steady stretch of the window, read into layers.

``torch.profiler`` records the stretch.  The program's
``record_function`` ranges (``gs::render``, ``gs::layout``, ``gs::loss``,
``gs::backward``, ``gs::adam``) appear on the device timeline as spans; a
device op belongs to the kernel its name names, else to the innermost span
it starts in.  Autograd launches the backward from its own thread, outside
the forward's spans, so device ops in no span are the backward's glue.
(The attribution of ``chip_smoke.py::profile_step``.)

In a served view, which runs in no ``gs::render`` span, they are the
forward's geometry and glue.

Busy time is the union of the device ops' intervals; idle gaps are named
by the program's span and the operator the host was in at the gap's
middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

HARNESS = "gsbench::harness"  # the benchmark's own device work in the stretch
SPANS = ("gs::render", "gs::layout", "gs::loss", "gs::backward", "gs::adam", HARNESS)
# kernel symbol -> part; the pack and the tile order are the forward
# kernel's first two launches, counted with the forward kernel that ran
KERNELS = (
    ("pack_fwd_rows_kernel", "fwd_prep"),
    ("tile_order_kernel", "fwd_prep"),
    ("render_sh_fwd_kernel", "render_sh_fwd"),
    ("render_sh_bwd_kernel", "render_sh_bwd"),
    ("render_fwd_kernel", "render_fwd"),
    ("render_bwd_kernel", "render_bwd"),
)
SPAN_PARTS = {"gs::layout": "layout", "gs::loss": "loss", "gs::adam": "adam",
              "gs::render": "render", "gs::backward": "backward", HARNESS: "harness"}
UNSPANNED = "unspanned"  # device ops in no span: a training step's backward
TOP = 10  # entries of each breakdown list
SMALL_GAP_US = 10.0  # idle gaps shorter than this are summed under one name


@dataclasses.dataclass
class Trace:
    """A traced stretch of ``steps`` steps (or views): device seconds by
    part, busy and window seconds, and the breakdown."""

    steps: int
    window_s: float
    busy_s: float
    parts: dict  # part -> device seconds over the stretch
    device_ops: list  # [[name, seconds], ...] largest first
    idle_gaps: list  # [[host activity, seconds], ...] largest first
    work: list = dataclasses.field(default_factory=list)  # pair counts per traced view
    per_pixel: bool = False
    # seconds a step (or view) took in the same run outside the traced
    # stretch, where the profiler's own host work does not slow the host
    step_s: float = 0.0

    @property
    def busy_per_step_s(self) -> float:
        return self.busy_s / self.steps

    def ms_per_step(self, part: str):
        s = self.parts.get(part, 0.0)
        return s / self.steps * 1e3 if s > 0 else None

    def kernel_s(self, name: str):
        """Device seconds of kernel ``name`` with its pack and tile order
        for the forward kernels; None if it did not run."""
        s = self.parts.get(name, 0.0)
        if s <= 0:
            return None
        if name in ("render_fwd", "render_sh_fwd"):
            s += self.parts.get("fwd_prep", 0.0)
        return s


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof, steps: int, window_s: float) -> Trace:
    """Attribute the profile ``prof`` of ``steps`` steps spanning
    ``window_s`` seconds on the host's clock."""
    import torch

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    spans = collections.defaultdict(list)
    for e in device:
        if e.name in SPANS:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    for v in spans.values():
        v.sort()
    ops = [e for e in device if e.name not in SPANS]

    def innermost(t):
        best, width = None, None
        for name, iv in spans.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t < iv[i][1]:
                w = iv[i][1] - iv[i][0]
                if width is None or w < width:
                    best, width = name, w
        return best

    parts = collections.Counter()
    by_name = collections.Counter()
    for e in ops:
        s = e.time_range.elapsed_us() * 1e-6
        by_name[e.name] += s
        part = next((p for sym, p in KERNELS if sym in e.name), None)
        if part is None:
            span = innermost(e.time_range.start)
            part = SPAN_PARTS.get(span, UNSPANNED)
        parts[part] += s

    busy = _merge([(e.time_range.start, e.time_range.end) for e in ops])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = _idle_gaps(events, busy)
    device_ops = [[name[:120], s] for name, s in by_name.most_common(TOP)]
    return Trace(steps=steps, window_s=window_s, busy_s=busy_s, parts=dict(parts),
                 device_ops=device_ops, idle_gaps=gaps)


def _idle_gaps(events, busy) -> list:
    """Idle time between device ops, summed by what the host was doing at
    each gap's middle: the program's outermost span and the innermost
    operator open then."""
    import torch

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    cpu.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    named = collections.Counter()
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gap = nxt - end
        if gap < SMALL_GAP_US:
            named[f"gaps under {SMALL_GAP_US:g} us"] += gap * 1e-6
            continue
        mid = (end + nxt) / 2
        i = bisect.bisect_right(starts, mid)
        span, op = None, None
        for e in reversed(cpu[max(0, i - 400):i]):
            if e.time_range.end < mid:
                continue
            if e.name in SPANS:
                span = e.name  # walking back, the last found is the outermost
            elif op is None:
                op = e.name  # the latest start still open: the innermost
        named[f"{span or 'no span'} / {op or 'no operator'}"[:120]] += gap * 1e-6
    return [[k, s] for k, s in named.most_common(TOP)]
