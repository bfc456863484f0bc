"""The per-layer readers on a made-up traced stretch: what each reads, and
nothing where there is nothing to read."""

import pytest

from gsbench import spec, trace, work

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
COUNTS = dict(evaluated=7 * 10**8, composited=4 * 10**7, evaluated_bwd=7 * 10**8,
              composited_bwd=4 * 10**7, splats=3 * 10**6, tiles=4293, slots=2**21,
              alive=1_500_000, n_sh=16)


def _trace(**parts):
    return trace.Trace(steps=8, window_s=0.4, busy_s=0.3, parts=parts, device_ops=[],
                       idle_gaps=[], work=[COUNTS] * 8, step_s=0.06)


def test_readers_of_a_dc_training_stretch():
    t = _trace(layout=0.056, adam=0.069, backward=0.01, unspanned=0.07, loss=0.021,
               render_fwd=0.016, fwd_prep=0.001, render_bwd=0.035)
    read = {m["name"]: spec.metric_reader(m["name"])(t) for m in BENCH["per_layer"]}
    assert read["layout_ms.train"] == pytest.approx(7.0)
    assert read["adam_ms.train"] == pytest.approx(8.625)
    assert read["backward_ms.train"] == pytest.approx(10.0)
    assert read["device_idle.train"] == pytest.approx(25.0)  # 1 - 0.3 / 0.4 of the stretch
    assert read["device_idle.serve"] == read["device_idle.train"]
    assert read["layout_ms.serve"] == read["layout_ms.train"]
    assert read["device_busy_ms.train"] == pytest.approx(37.5)  # 0.3 s over 8 steps
    bound = work.bound_s(*work.kernel_work(COUNTS)["render_fwd"]) * 8
    assert read["render_fwd_roofline.train"] == pytest.approx(100 * bound / 0.017)
    assert read["render_sh_fwd_roofline.train"] is None  # B3 did not run
    assert read["render_sh_bwd_roofline.train"] is None
    assert 0 < read["step_mfu.train"] < 100


def test_no_work_no_roofline():
    t = _trace(render_fwd=0.016)
    t.work = []
    assert spec.metric_reader("render_fwd_roofline.serve")(t) is None
    assert spec.metric_reader("view_mfu.serve")(t) is None


def test_busy_intervals_merge():
    assert trace._merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
