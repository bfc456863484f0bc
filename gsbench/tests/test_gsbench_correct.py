"""``correct`` as a run decides it, at a size the CPU holds: true for the
program as it is, false for the control (the reference in bfloat16 in the
program's place) and for each fault a cell can have, planted in the timed
path underneath a whole run (the look for a card skipped)."""

import pytest
import torch

from gsbench import check, harness, readings, spec

CPU = torch.device("cpu")
TRAIN = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]
         if spec.load_cell(w["name"]).traffic["kind"] == "train"]
SERVE = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]
         if spec.load_cell(w["name"]).traffic["kind"] == "serve"]
SECONDS = 0.3


def _run(cell, seed=11):
    return harness.make(cell, seed, CPU).run(SECONDS, False, 0.0)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res.correct, res.checks
    assert res.attempted > 0 and res.failed == 0


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    row = readings.reading(cell, 12, CPU, "control")
    numbers = {k: v for k, v in row.items() if k not in ("workload", "seed", "kind")}
    assert not check.passed(check.with_limits(numbers, cell.limits)), numbers


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_is_not_correct(tiny_cell, name, monkeypatch):
    from gaussian_splatting_torch import trainer

    monkeypatch.setattr(trainer, "adam_step", lambda state, gparams, ok, config: state)
    res = _run(tiny_cell(name))
    assert not res.correct
    assert res.checks["step_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_image_left_out_is_not_correct(tiny_cell, name):
    from gaussian_splatting_torch import trainer

    undo = readings.half_image_loss(trainer)
    try:
        res = _run(tiny_cell(name))
    finally:
        undo()
    assert not res.correct, res.checks


@pytest.mark.parametrize("name", SERVE)
def test_altered_pixel_is_not_correct(tiny_cell, name, monkeypatch):
    from gaussian_splatting_torch import rasterize as rz

    full = rz.rasterize

    def altered(*args, **kw):
        res = full(*args, **kw)
        img = res.image.clone()
        img[img.shape[0] // 2, img.shape[1] // 2, 1] += 0.1
        return res._replace(image=img)

    monkeypatch.setattr(rz, "rasterize", altered)
    res = _run(tiny_cell(name))
    assert not res.correct, res.checks


def test_a_missing_view_is_not_correct():
    assert not check.passed(check.compare_serve({}, {}, {"image_gap": 1, "T_gap": 1}, want=8))
