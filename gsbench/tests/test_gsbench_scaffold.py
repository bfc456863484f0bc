"""The Scaffold-GS cell at a size the CPU holds: its entries load, its
scene is made from the seed alone, its plain reference agrees with the
tests' copy, the program's counters count what a step decodes, and
``correct`` holds for the program and fails for the control and for each
fault a training cell can have."""

import copy

import pytest
import torch

from gsbench import check, harness, scaffold_readings, scaffold_work, scene, spec
from gsbench.reference import scaffold as ref
from gsbench.reference import splat

CELL = "garden-scaffold.scaffold-ring"
CPU = torch.device("cpu")
NEW = ("decode_ms.train", "neural_m.train", "scaffold_mfu.train")


def test_entries_load():
    cell = spec.load_cell(CELL)
    assert cell.traffic["kind"] == "scaffold" and cell.config["scene_maker"] == "scaffold"
    assert set(cell.limits) == {"loss_gap", "grad_gap", "step_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "peak_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and "step_mfu.train" not in names
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    cfg = cell.config
    assert (cfg["feat_dim"], cfg["n_offsets"], cfg["hidden_dim"], cfg["appearance_dim"]) == \
        (32, 10, 32, 0)
    assert (cfg["alive"], cfg["capacity"], cfg["width"], cfg["height"]) == \
        (800_000, 1 << 20, 1296, 840)


def _small():
    cfg = copy.deepcopy(spec.load_json(spec.HERE / "configs" / "garden-scaffold.json"))
    cfg.update(capacity=1024)
    return cfg


def test_scene_maker_is_deterministic_for_one_seed():
    cfg = _small()
    a = scene.load(cfg, 700, 5, CPU)
    b = scene.load(cfg, 700, 5, CPU)
    c = scene.load(cfg, 700, 6, CPU)
    for k, v in a["params"].items():
        for x, y in zip(v if isinstance(v, tuple) else [v],
                        b["params"][k] if isinstance(v, tuple) else [b["params"][k]]):
            assert torch.equal(x, y), k
    assert not torch.equal(a["params"]["anchor"], c["params"]["anchor"])
    for name in ("mlp_opacity", "mlp_cov", "mlp_color"):  # the model's weights: every run's
        assert all(torch.equal(x, y) for x, y in zip(a["params"][name], c["params"][name]))
    assert a["distance"] == b["distance"]
    p = a["params"]
    assert int(a["alive"].sum()) == 700 and not bool(p["offset"][700:].any())
    assert torch.equal(p["scaling"][:700], p["scaling"][:700, :1].expand(700, 6))
    assert float(p["offset"].abs().max()) <= 1.0
    w1 = p["mlp_cov"][0]
    assert w1.shape == (32, 35) and float(w1.abs().max()) <= 35 ** -0.5


@pytest.mark.parametrize("block", [64, 1024])
def test_neighbour_scale_is_the_three_nearest(block, monkeypatch):
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(900, 3, generator=g)
    xyz[:300] *= 0.05  # a dense cluster beside a sparse cloud
    maker = spec.load_module("scenes", "scaffold")
    monkeypatch.setattr(maker, "KNN_BLOCK", block)
    monkeypatch.setattr(maker, "KNN_CHUNK", block * 3 + 1)
    got = maker.neighbour_scale(xyz, 3)
    d = (xyz[:, None] - xyz[None]).double().norm(dim=2)
    d.fill_diagonal_(float("inf"))
    want = d.topk(3, largest=False).values.square().mean(1).sqrt()
    assert torch.allclose(got.double(), want, rtol=1e-5)


def test_reference_agrees_with_the_tests_copy():
    from tests import test_torch_scaffold as t
    from tests import torch_scaffold_reference as tref

    sc, pose, K = t._scene()
    p = t._ref_params(sc)
    view = splat.View(K=K, pose=pose, width=t.W, height=t.H, n_sh=1, per_pixel=False,
                      background=t.BG, near=t.RCFG["near"], far=t.RCFG["far"],
                      padding=t.RCFG["padding"], mh_dist=t.RCFG["mh_dist"])
    with torch.no_grad():
        got = ref.decode(p, sc.anchor, sc.alive, view)
        want = tref.decode(p, sc.anchor, sc.alive, pose, K, t.W, t.H, t.RCFG["near"],
                           t.RCFG["far"], t.RCFG["padding"])
        for k in ("xyz", "scaling", "rot", "opacity", "colour"):
            assert torch.allclose(got[k], want[k], rtol=1e-6, atol=1e-7), k
        img, _, _ = ref.render(p, sc.anchor, sc.alive, view)
        wimg = tref.render(want, pose, K, t.W, t.H, t.BG, near=t.RCFG["near"],
                           far=t.RCFG["far"], padding=t.RCFG["padding"],
                           mh_dist=t.RCFG["mh_dist"])
    assert float((img - wimg).abs().max()) < 5e-6
    gt = t._gt()
    loss, grads = ref.grads(p, sc.anchor, sc.alive, view, gt)
    wloss, wgrads, _ = tref.grads(p, sc.anchor, sc.alive, pose, K, gt, t.BG, t.RCFG)
    assert float(loss) == pytest.approx(float(wloss), rel=1e-5)
    for k in ref.LEAVES:
        a = torch.cat([x.reshape(-1) for x in grads[k]]) if k in ref.HEADS else grads[k]
        b = torch.cat([x.reshape(-1) for x in wgrads[k]]) if k in ref.HEADS else wgrads[k]
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4, k


def test_counters_count_a_recorded_step(tiny_cell):
    from gaussian_splatting_torch import telemetry

    run = harness.make(tiny_cell(CELL), 3, CPU)
    state, _ = run.program()
    with telemetry.recording():
        _, info = run.step(state, run.checked)
    c = telemetry.window()["counters"]
    assert c["steps"] == 1 and c["views"] == 1
    assert 0 < c["anchors"] <= run.alive_n
    assert c["neural"] == info["neural"] == 10 * c["anchors"]
    assert c["sync.decode.anchors"] == 1 and "sync.decode.neural" not in c


def _run(cell, seed=11):
    return harness.make(cell, seed, CPU).run(0.3, False, 0.0)


def test_sound_run_is_correct(tiny_cell):
    res = _run(tiny_cell(CELL))
    assert res.correct, res.checks
    assert res.attempted > 0 and res.failed == 0


def test_control_is_not_correct(tiny_cell):
    cell = tiny_cell(CELL)
    row = scaffold_readings.reading(cell, 12, CPU, "control")
    numbers = {k: v for k, v in row.items() if k not in ("workload", "seed", "kind")}
    assert not check.passed(check.with_limits(numbers, cell.limits)), numbers


def test_state_left_unchanged_is_not_correct(tiny_cell, monkeypatch):
    from gaussian_splatting_torch import trainer

    monkeypatch.setattr(trainer, "adam_step", lambda state, gparams, ok, config: state)
    res = _run(tiny_cell(CELL))
    assert not res.correct
    assert res.checks["step_gap"]["value"] == pytest.approx(1.0)


def test_half_the_image_left_out_is_not_correct(tiny_cell):
    cell = tiny_cell(CELL)
    row = scaffold_readings.reading(cell, 13, CPU, "fault")
    numbers = {k: v for k, v in row.items() if k not in ("workload", "seed", "kind")}
    assert not check.passed(check.with_limits(numbers, cell.limits)), numbers


def test_traced_run_counts_pairs_on_decoded_rows(tiny_cell):
    res = harness.make(tiny_cell(CELL), 14, CPU).run(0.3, True, 0.0)
    assert res.correct, res.checks
    w = res.trace.work
    assert len(w) == 8 and all(c["alive"] > 0 and c["composited"] > 0 for c in w)
    assert all(c["slots"] == c["alive"] for c in w)  # the reference's rows: opacity > 0
    assert 0 < scaffold_work.mfu(res.trace) < 100
    assert spec.metric_reader("host_syncs.train")(res.trace) == pytest.approx(11.0)
    assert spec.metric_reader("neural_m.train")(res.trace) > 0
    assert spec.metric_reader("decode_ms.train")(res.trace) is None  # device time: a card's


def test_new_readers_read_nothing_of_a_vanilla_stretch():
    from gsbench import trace

    counts = dict(evaluated=7, composited=4, evaluated_bwd=7, composited_bwd=4, splats=3,
                  tiles=4293, slots=2**21, alive=1_500_000, n_sh=16)
    t = trace.Trace(steps=8, window_s=0.4, busy_s=0.3, parts={}, device_ops=[],
                    idle_gaps=[], work=[counts] * 8, step_s=0.06)
    assert spec.metric_reader("scaffold_mfu.train")(t) is None


# on the card


@pytest.mark.card
def test_every_blocking_read_of_a_step_is_counted(tiny_cell, card):
    from gsbench.tests import test_gsbench_telemetry as tt

    tt.test_every_blocking_read_is_counted(tiny_cell, card, CELL)


@pytest.mark.card
def test_decode_span_stays_on_the_host_timeline(tiny_cell, card):
    from gsbench.tests import test_gsbench_telemetry as tt

    tt.test_spans_stay_on_the_host_timeline(tiny_cell, card, CELL)


@pytest.mark.card
def test_every_metric_of_the_cell_reports_in_a_small_traced_run(tiny_cell, card):
    cell = tiny_cell(CELL)
    res = harness.make(cell, 23, card).run(3.0, True, 0.0)
    assert res.correct, res.checks
    read = {m["name"]: spec.metric_reader(m["name"])(res.trace) for m in cell.per_layer}
    assert all(v is not None and v > 0 for v in read.values()), read
    assert 0 < read["scaffold_mfu.train"] < 100, read
