"""On the card: the program's counters and spans (``gaussian_splatting_
torch.telemetry``) against what the card sees.  Every blocking device-to-
host read of a training step and of a served view is counted, as the sync
warnings of ``torch.cuda.set_sync_debug_mode("warn")`` show; the new spans
stay off the device timeline, nest in their parents and start before the
device ops they launch; and the metrics that read them report in a small
traced run of each cell."""

import collections
import threading
import traceback
import warnings

import pytest

from gsbench import harness, spec

pytestmark = pytest.mark.card
TRAIN = "garden7k-sh3-precompute.train-ring"
SERVE = "garden7k-sh3-precompute.serve-orbit"
CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]
NEW = ("geometry_ms", "host_syncs", "splats_m")
# each span of the program and the span it runs in
PARENTS = {"gs::layout.cull": "gs::layout", "gs::layout.enumerate": "gs::layout",
           "gs::layout.sat": "gs::layout", "gs::layout.sort": "gs::layout",
           "gs::layout": "gs::render", "gs::render.geometry": "gs::render",
           "gs::render.features": "gs::render", "gs::render.raster": "gs::render"}
TRAIN_PARENTS = {"gs::render": "gs::step", "gs::loss": "gs::step",
                 "gs::backward": "gs::step", "gs::adam": "gs::step"}


def _call(tiny_cell, card, name):
    """One training step, or one served view, of the small cell ``name``,
    warmed once."""
    run = harness.make(tiny_cell(name), 21, card)
    if name == SERVE:
        def call():
            return run.rasterize(0)
    else:
        state, _ = run.program()

        def call():
            return run.step(state, run.checked)
    call()
    harness.sync(card)
    return call


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_every_blocking_read_is_counted(tiny_cell, card, name):
    import torch

    from gaussian_splatting_torch import telemetry

    call = _call(tiny_cell, card, name)
    syncs, calling = [], [False]

    def show(message, category, filename, lineno, file=None, line=None):
        # the reads made while the program runs: where each was made, on which thread
        if calling[0] and "synchroniz" in str(message):
            stack = "".join(traceback.format_stack(limit=6)[:-1])
            syncs.append(f"{threading.current_thread().name} {filename}:{lineno}\n{stack}")

    with warnings.catch_warnings(), telemetry.recording():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            calling[0] = True
            call()
        finally:
            calling[0] = False
            torch.cuda.set_sync_debug_mode(0)
    counted = {k: v for k, v in telemetry.window()["counters"].items()
               if k.startswith("sync.")}
    print(f"{name}: {len(syncs)} sync warnings; counted {counted}")
    for s in syncs:
        print(s)
    assert len(syncs) == sum(counted.values()), counted


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_spans_stay_on_the_host_timeline(tiny_cell, card, name):
    import torch

    from gaussian_splatting_torch import telemetry

    call = _call(tiny_cell, card, name)
    telemetry.count("sync.none")  # closes a window an earlier profiler left open
    with harness.profile(card) as prof:
        call()
        harness.sync(card)
    new = set(telemetry.window()["spans"]) - telemetry.LAYERS
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device = [e for e in events if e.device_type == cuda]
    assert device
    assert not {e.name for e in device} & new
    host = collections.defaultdict(list)
    for e in events:
        if e.device_type == cpu and e.name.startswith("gs::"):
            host[e.name].append((e.time_range.start, e.time_range.end))
    # the device timeline's ranges (kernels of the gs:: namespace carry a signature)
    assert {e.name for e in device if e.name.startswith("gs::") and "(" not in e.name} \
        <= telemetry.LAYERS
    parents = dict(PARENTS, **(TRAIN_PARENTS if name == TRAIN else {}))
    assert set(parents) - telemetry.LAYERS <= new
    for child, parent in parents.items():
        for a, b in host[child]:
            assert any(pa <= a and b <= pb for pa, pb in host[parent]), (child, parent)
    # a device op starts after the span in which the host launched it began:
    # the runtime call that launched it shares its correlation id
    launch = {e.id: e for e in events if e.device_type == cpu and e.name.startswith("cu")}
    launched = collections.Counter()
    for d in device:
        src = launch.get(d.id)
        if src is None:
            continue
        for span in new:
            for a, b in host[span]:
                if a <= src.time_range.start <= b:
                    assert d.time_range.start >= a, (span, d.name)
                    launched[span] += 1
    stages = {s for s in PARENTS if s not in telemetry.LAYERS}
    assert all(launched[s] > 0 for s in stages), dict(launched)


@pytest.mark.parametrize("name", CELLS)
def test_new_metrics_report_in_a_small_traced_run(tiny_cell, card, name):
    cell = tiny_cell(name)
    res = harness.make(cell, 22, card).run(3.0, True, 0.0)
    assert res.correct, res.checks
    read = {m["name"]: spec.metric_reader(m["name"])(res.trace) for m in cell.per_layer
            if m["name"].split(".")[0] in NEW}
    assert len(read) == 3 and all(v is not None and v > 0 for v in read.values()), read
