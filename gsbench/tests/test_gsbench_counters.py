"""The readers of the program's counters on a made-up traced stretch: what
they read from the telemetry window, and nothing where the window is not
the stretch."""

import pytest

from gsbench import spec, trace


def _trace(steps=8):
    return trace.Trace(steps=steps, window_s=0.4, busy_s=0.3, parts={}, device_ops=[],
                       idle_gaps=[])


def _record(**counts):
    from gaussian_splatting_torch import telemetry

    with telemetry.recording():
        for name, n in counts.items():
            telemetry.count(name, n)


def test_counters_per_step_or_view():
    _record(steps=8, views=8, splats=8 * 3_000_000, **{"sync.layout.a": 8 * 7,
                                                      "sync.layout.b": 8 * 3})
    assert spec.metric_reader("host_syncs.train")(_trace()) == pytest.approx(10.0)
    assert spec.metric_reader("splats_m.train")(_trace()) == pytest.approx(3.0)
    _record(views=8, splats=8 * 1_000_000, **{"sync.layout.a": 8 * 10})  # served views
    assert spec.metric_reader("host_syncs.serve")(_trace()) == pytest.approx(10.0)
    assert spec.metric_reader("splats_m.serve")(_trace()) == pytest.approx(1.0)


def test_a_window_that_is_not_the_stretch_reads_nothing():
    _record(steps=5, views=5, splats=10, **{"sync.layout.a": 5})
    assert spec.metric_reader("host_syncs.train")(_trace(8)) is None
    assert spec.metric_reader("splats_m.train")(_trace(8)) is None
