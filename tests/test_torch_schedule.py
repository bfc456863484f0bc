"""The whole training schedule, the JAX package's runner against the port's,
with real steps: ``train_step``, ``adaptive_density_control`` (ADC) and
``reset_opacity`` of each package on one tiny synthetic scene, through a
compressed schedule with 5 ADC events, an opacity reset and 3 evals.  The
JAX side runs jitted at ``kernel_precision="f32"`` and
``steps_per_dispatch=1``, with capacities that never overflow; the port on
the CPU through its kernels' plain versions.

- Lockstep: the JAX run records the state before and after each event.  The
  port's run is held to it at each event (accumulators, decisions, stats)
  and then carries on from the JAX state after the event, so every window
  of steps starts equal and a fault in one window cannot hide in the noise
  of the windows after it.
- Free run: the port's run without that replay, each event's alive count
  within a band of the JAX run's.

Of ROADMAP §C's documented edges only the uv quantile's (2 ulps, for the
same input, through tests/test_torch_adc.py's comparison) is needed: no
gaussian of this run sits at the 1/255 skip's edge or on a frustum's
edge, so counts, masks and stats are held exactly.

``test_attribution`` (slow) runs ``tests/schedule_attribution.py``: the JAX
runner in four configurations and the port, on a scene where the JAX
package's capacities bind, each event's deletes split by reason.
"""

import dataclasses
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from gaussian_splatting_torch import convert
from gaussian_splatting_torch import runner as trunner
from gaussian_splatting_torch import trainer as ttrainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data
from gaussian_splatting_tpu import runner as jrunner
from gaussian_splatting_tpu import trainer as jtrainer
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from tests import schedule_attribution as attribution
from tests.test_torch_adc import _assert_states_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 240 points of the synthetic box and STRAYS, all of them the initial
# gaussians (2,048 slots) and the secret scene, 8 ring views at 64x48 (2 for
# test); ADC at 5, 10, 15, 20, 25, the reset at 15 (after that event), evals
# at 0, 15 and the end (30); SH band 0.  Every initial scale is
# max_initial_scale (0.1), so clone_scale_threshold 0.1 makes both clones
# and splits, and a delete_opacity_threshold just under the initial
# opacity (0.2) makes an opacity delete (at 20).
KW = dict(synthetic_points=240, synthetic_init_points=0, synthetic_images=8,
          synthetic_width=64, synthetic_height=48, test_split_ratio=4, seed=3,
          num_iters=30, adaptive_control_start=0, adaptive_control_interval=5,
          adaptive_control_end=26, reset_opacity_start=10, reset_opacity_interval=15,
          reset_opacity_end=20, test_eval_interval=15, print_interval=10,
          save_debug_image_interval=0, checkpoint_interval=0, add_sh_band_interval=1000,
          delete_opacity_threshold=0.199, clone_scale_threshold=0.1)
# Two points off the box, which the first event deletes for the other two
# reasons: 6 above the ring's plane, a point every view's frustum holds (its
# 100-pixel padding) and no view's image (v ~ 62 of 48 rows): seen, with no
# uv gradient; 40 above it, a point in no view's frustum: never seen.
STRAYS = np.array([[0.0, 6.0, 0.0], [0.0, 40.0, 0.0]], np.float32)
# the JAX side's exact mode, one step a dispatch, default tier capacities
# that hold every frame of this scene
JAX_KW = dict(kernel_precision="f32", steps_per_dispatch=1, splat_capacity=1 << 14, chunk=256)
EVENTS = [5, 10, 15, 20, 25]

# Tolerances of the lockstep case.  The accumulators hold a window of 5
# steps (6 for the first), each at the rounding of
# tests/test_torch_trainer.py (uv 5e-4, xyz 1e-4 of the leaf's largest after
# 1-3 steps), and the parameters they are taken at drift apart by rounding
# over the window; measured: see test_lockstep's output.
UV_REL_TOL = 5e-4  # measured 3.5e-5
XYZ_REL_TOL = 3e-4  # measured 3.0e-5
# uv_split_val of the port's own event against the JAX one: a quantile of
# the uv averages, at the accumulators' rounding
SPLIT_VAL_RTOL = 5e-4
# test PSNR of an eval 0-5 steps after the state a replay put in place
PSNR_RTOL = 1e-4
# Free run: the alive count at each event within ALIVE_BAND of the JAX
# run's.  The lockstep case shows equal decisions from equal windows; what
# the free runs do not share is the split's draws (each package has its own
# generator), which move the split samples, and with them the next windows'
# views of them, by up to their source's extent.  Measured: equal at every
# event here; at most 3.3% apart over test_attribution's 20 events
# (variant 0 against the port).
ALIVE_BAND = 0.05


class Event(NamedTuple):
    iteration: int
    before: object  # the state before the event, numpy leaves
    after: object
    stats: dict
    config: object


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data():
    c = SplatConfig(**KW)
    data = make_synthetic_scene_data(c.synthetic_points, c.synthetic_images, c.seed,
                                     c.synthetic_width, c.synthetic_height)
    rgb = np.full((len(STRAYS), 3), 1.0, np.float32)
    return dataclasses.replace(data, xyz=np.concatenate([data.xyz, STRAYS]),
                               rgb=np.concatenate([data.rgb, rgb]))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX runner's run of KW, each event recorded."""
    events = []
    adc = jtrainer.adaptive_density_control

    def recorded(state, key, iteration, *, config):
        before = _np(state)
        after, stats = adc(state, key, iteration, config=config)
        events.append(Event(int(iteration), before, _np(after), _np(stats), config))
        return after, stats

    cfg = JConfig(**KW, **JAX_KW, output_dir=str(tmp_path_factory.mktemp("jax")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "adaptive_density_control", recorded)
        runner = jrunner.TrainingRunner(_data(), cfg, synthetic=True)
        runner.train()
    assert runner.metrics.overflow_steps == 0
    assert [e.iteration for e in events] == EVENTS
    return runner, events


def _port_run(tmp_path, at_event=None):
    """The port's runner on KW; ``at_event(k, state, generator, iteration,
    config)`` stands in for the k-th event when given."""
    cfg = SplatConfig(**KW, output_dir=str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        if at_event is not None:
            calls = []

            def event(state, generator, iteration, *, config):
                calls.append(iteration)
                return at_event(len(calls) - 1, state, generator, iteration, config)

            mp.setattr(ttrainer, "adaptive_density_control", event)
        runner = trunner.TrainingRunner(_data(), cfg, synthetic=True, device="cpu")
        runner.train()
    return runner


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def decisions(np_state, config, iteration):
    """(delete, clone, split) slot masks of an ADC event on ``np_state``,
    worked out as the port's event works them out (the clone's writes
    included, since the split's scale quantile is taken after them)."""
    T = ttrainer
    s = convert.train_state_from_numpy(np_state, "cpu")
    delete = torch.stack(T._delete_masks(s, config)).any(dim=0)
    alive, count = s.alive & ~delete, s.grad_accum_count
    skip = alive.sum() > config.max_gaussians
    uv_avg = T._row_norm(s.uv_grad_accum / count.clamp_min(1).float()[:, None])
    factor = T._scale_factor(config, iteration, "cpu")
    nan = torch.full_like(uv_avg, float("nan"))
    uv_pct = (1.0 - (1.0 - config.uv_grad_percentile) * factor).clamp(0.0, 1.0)
    densify = alive & (uv_avg > T._nanquantile(torch.where(alive, uv_avg, nan), uv_pct)) & ~skip
    scale_max = torch.exp(s.params["scale"]).amax(dim=1)
    clone = densify & (scale_max <= config.clone_scale_threshold)
    written, from_slot, _ = T._pair_free_slots(clone, ~alive)
    alive = alive | written
    densify = torch.where(written, densify[from_slot], densify)
    scale_max = torch.where(written, scale_max[from_slot], scale_max)
    scale_pct = (1.0 - (1.0 - config.scale_norm_percentile) * factor).clamp(0.0, 1.0)
    scale_split = T._nanquantile(torch.where(alive, scale_max, nan), scale_pct)
    split = ((densify & (scale_max > config.clone_scale_threshold))
             | (alive & (scale_max > scale_split) & ~skip)) & alive
    return delete.numpy(), clone.numpy(), split.numpy()


def _assert_decisions_are_the_events(masks, stats):
    delete, clone, split = masks
    assert (delete.sum(), clone.sum(), split.sum()) == (
        int(stats["n_deleted"]), int(stats["n_clone"]), int(stats["n_split"]))


def test_lockstep(jax_run, tmp_path):
    """At each of the 5 events, the port's state before it against the JAX
    one: alive and grad_accum_count exactly, uv_grad_accum and
    xyz_grad_accum at UV_REL_TOL and XYZ_REL_TOL of the leaf's largest.
    The event's decisions from the port's own state (delete, clone and
    split masks) equal those from the JAX state, and the port's event
    reports the JAX event's counts exactly (uv_split_val at
    SPLIT_VAL_RTOL).  The port's event on the JAX state gives the JAX
    state after it: alive and stats exactly (uv_split_val to 2 ulps), the
    split samples by the split's law (tests/test_torch_adc.py).  The
    deletes by reason (trainer.delete_reasons) add up to the event's, and
    each reason deletes somewhere in the run.  Then the port carries on from
    the JAX state after the event."""
    jr, jevents = jax_run
    adc = ttrainer.adaptive_density_control
    measured = []

    def at_event(k, state, generator, iteration, config):
        ev = jevents[k]
        assert iteration == ev.iteration
        mine = convert.train_state_to_numpy(state)
        np.testing.assert_array_equal(mine.alive, ev.before.alive)
        np.testing.assert_array_equal(mine.grad_accum_count, ev.before.grad_accum_count)
        uv = _rel(mine.uv_grad_accum, ev.before.uv_grad_accum)
        xyz = _rel(mine.xyz_grad_accum, ev.before.xyz_grad_accum)
        assert uv < UV_REL_TOL and xyz < XYZ_REL_TOL, (iteration, uv, xyz)

        masks = decisions(mine, config, iteration)
        jmasks = decisions(ev.before, config, iteration)
        for got, want, name in zip(masks, jmasks, ("delete", "clone", "split")):
            np.testing.assert_array_equal(got, want, err_msg=f"{name} at {iteration}")
        _assert_decisions_are_the_events(jmasks, ev.stats)

        _, stats = adc(state, generator, iteration, config=config)
        stats_np = {k: v.numpy() for k, v in stats.items()}
        _assert_decisions_are_the_events(masks, stats_np)
        for key in ("n_deleted", "n_clone", "n_split", "n_alive", "skip_densify", "cap_hit"):
            assert stats_np[key] == ev.stats[key], (iteration, key)
        val = float(ev.stats["uv_split_val"])
        assert abs(float(stats_np["uv_split_val"]) - val) <= SPLIT_VAL_RTOL * val

        # the same event on the JAX state
        gen = torch.Generator().manual_seed(iteration)
        same, same_stats = adc(convert.train_state_from_numpy(ev.before, "cpu"), gen,
                               iteration, config=config)
        _assert_states_match(ev.before, ev.after, ev.stats,
                             convert.train_state_to_numpy(same),
                             {k: v.numpy() for k, v in same_stats.items()}, ev.config)
        reasons = {k: int(v) for k, v in ttrainer.delete_reasons(
            convert.train_state_from_numpy(ev.before, "cpu"), config).items()}
        assert sum(reasons.values()) == int(ev.stats["n_deleted"])
        measured.append((iteration, uv, xyz, reasons, int(masks[1].sum()),
                         int(masks[2].sum())))
        return convert.train_state_from_numpy(ev.after, "cpu"), stats

    tr = _port_run(tmp_path, at_event)
    print("(iteration, uv rel, xyz rel, deletes by reason, cloned, split):", measured)
    assert len(measured) == len(EVENTS)
    # the events do real work: they clone, split and delete for each reason
    assert sum(m[4] for m in measured) > 0 and sum(m[5] for m in measured) > 0
    for reason in ("opacity", "count0", "uv0"):
        assert sum(m[3][reason] for m in measured) > 0, reason
    jm, tm = jr.metrics.to_dict(), tr.metrics.to_dict()
    assert tm["eval_iters"] == jm["eval_iters"] == [0, 15, 30]
    np.testing.assert_allclose(tm["test_psnr"], jm["test_psnr"], rtol=PSNR_RTOL)
    assert tm["adc_events"] == jm["adc_events"]


def test_free_run(jax_run, tmp_path):
    """The port's run without replay: each event's alive count within
    ALIVE_BAND of the JAX run's, and the same events."""
    jr, _ = jax_run
    tr = _port_run(tmp_path)
    got = [(e["iter"], e["alive"]) for e in tr.metrics.adc_events]
    want = [(e["iter"], e["alive"]) for e in jr.metrics.adc_events]
    print("alive at each event, port / JAX:", got, want)
    assert [i for i, _ in got] == [i for i, _ in want] == EVENTS
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= ALIVE_BAND * b, (got, want)


# runs/refscale7k, the JAX package's run of the reference-scale schedule
RECORD = os.path.join(ROOT, "runs", "refscale7k")
# its ADC events whose windows carried no signal (found by the test below)
NO_SIGNAL = [900, 3700, 5300, 5400, 5800, 5900, 6000]


def _record_windows():
    """(events of metrics.json, [the run.log lines between each event's
    ADC line and the one before])."""
    with open(os.path.join(RECORD, "metrics.json")) as f:
        events = json.load(f)["adc_events"]
    with open(os.path.join(RECORD, "run.log")) as f:
        lines = [line.rstrip("\n") for line in f]
    windows, current = [], []
    for line in lines:
        if "ADC:" in line:
            windows.append(current)
            current = []
        else:
            current.append(line)
    assert len(windows) == len(events) == 57
    return events, windows


def _overflow_rebuckets(window):
    """The rebuckets an overflow triggered in a window's log lines: each
    group of capacity lines that the periodic rebucket (iteration 499 mod
    500, the step before an eval) did not print, i.e. that no TEST SPLIT
    line follows."""
    groups, group = [], []
    for line in window + ["<end>"]:
        if "capacity" in line or "capacities" in line:
            group.append(line)
            continue
        if group and "TEST SPLIT" not in line:
            groups.append(group)
        group = []
    return groups


def test_record_windows_without_signal():
    """In the JAX run's record, 7 of the 57 ADC events (NO_SIGNAL) densified
    only the scale quantile's share: no delete, no clone, and a split count
    within 1% of (1 - scale_pct) times the slots alive, which is what an
    event does when no step of its window was counted (count 0 everywhere:
    the delete falls back to opacity alone and every uv average is 0).
    Every other event split more than twice that share.  Only the first of
    the seven followed an overflow (the runner rebuckets its capacities
    when it sees one, and logs it); the other six windows saw none, and no
    escape-hatch warning was logged, so their steps were skipped because a
    loss or gradient was not finite, the other condition of the JAX step's
    skip (gaussian_splatting_tpu/trainer.py:155-159), which metrics.json's
    overflow_steps does not count."""
    with open(os.path.join(RECORD, "config.yaml")) as f:
        cfg = SplatConfig.from_yaml(f.read())
    events, windows = _record_windows()
    no_signal = []
    for e in events:
        before = e["alive"] + e["deleted"] - e["cloned"] - e["split"]
        factor = ((cfg.adaptive_control_end - e["iter"])
                  / (cfg.adaptive_control_end - cfg.adaptive_control_start) * 2.0)
        share = (1.0 - cfg.scale_norm_percentile) * factor * (before - e["deleted"])
        if abs(e["split"] - share) <= 0.01 * share:
            assert e["deleted"] == e["cloned"] == 0, e
            no_signal.append(e["iter"])
        else:
            assert e["split"] > 2 * share, e
    assert no_signal == NO_SIGNAL
    after_overflow = [e["iter"] for e, w in zip(events, windows) if _overflow_rebuckets(w)]
    assert [i for i in NO_SIGNAL if i in after_overflow] == [900]
    assert not any("WARNING: layout overflow" in line for w in windows for line in w)


def _one_long_thin_gaussian(angle_deg):
    """A numpy JAX TrainState of one gaussian at the origin, 8 world units
    long (50 px in the 64x48 view below) and 1e-3 across, turned by
    ``angle_deg`` in the image plane, with a black target."""
    from gaussian_splatting_tpu.structs import GaussianScene

    t = np.deg2rad(angle_deg) / 2
    scene = GaussianScene.create(
        xyz=np.zeros((1, 3), np.float32), rgb=np.ones((1, 3), np.float32),
        opacity=np.full((1, 1), 2.0, np.float32),
        scale=np.log(np.array([[8.0, 1e-3, 1e-3]], np.float32)),
        quaternion=np.array([[np.cos(t), 0.0, 0.0, np.sin(t)]], np.float32), capacity=16)
    return _np(jtrainer.init_train_state(scene, JConfig()))


@pytest.mark.parametrize("angle", [0, 45])
def test_bf16_skips_a_step_on_a_long_thin_gaussian(angle):
    """One JAX train_step on one long, thin gaussian (50 px long in a 64x48
    view, focal 50, 8 world units away): at kernel_precision="f32" the step
    is taken, and the port's step agrees; at "bf16" it is taken when the
    gaussian lies along the pixel grid (0 degrees) and skipped at 45
    degrees, where its covariance rows (a, b, c), each rounded to bfloat16,
    leave a*c - b*b (exactly 0.25 * its long axis's variance plus 0.0625)
    no significant bit: the step's gradients are not finite.  The Adam
    count says whether a step was taken."""
    state = _one_long_thin_gaussian(angle)
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 8.0
    gt, bg = np.zeros((48, 64, 3), np.uint8), np.zeros(3, np.float32)
    taken = {}
    for precision in ("f32", "bf16"):
        cfg = JConfig(kernel_precision=precision, splat_capacity=1 << 14, chunk=256)
        out, _ = jtrainer.train_step(
            jax.tree_util.tree_map(jax.numpy.array, state), gt, K, pose, bg, config=cfg,
            camera_hw=(48, 64), n_sh_band=0, use_background=False)
        taken[precision] = int(out.opt_state[0].count)
    port, _ = ttrainer.train_step(
        convert.train_state_from_numpy(state, "cpu"), torch.tensor(gt), torch.tensor(K),
        torch.tensor(pose), torch.tensor(bg), config=SplatConfig(), camera_hw=(48, 64),
        n_sh_band=0)
    assert taken == {"f32": 1, "bf16": int(angle == 0)}
    assert int(port.opt_state.count) == 1


@pytest.mark.slow
def test_attribution(tmp_path):
    """tests/schedule_attribution.py's five runs side by side, each in a
    process of its own (21-26 min on 8 CPU cores): the JAX runner in variants
    0-3 and the port, 20 ADC events on a 3,000-point scene at 64x48 from
    600 gaussians.  What they showed, and this asserts:

    - variant 0 (f32, one step a dispatch, capacities that hold) tracks the
      port: every event's alive count within ALIVE_BAND of the port's, no
      step skipped in either;
    - no step is skipped at this size except on an overflow: in every
      window of every run, skipped == overflowed (the escape hatch never
      turns on);
    - the capacities bind: variants 1-3 overflow; with 25 steps a dispatch
      (2, 3) the runner sees the first window's overflow only at its event,
      so that window counts no step and its event densifies nothing;
    - no run shrinks: every scene grows to over 1.5x its 600 gaussians, no
      event deletes more than 7% of the slots alive (the most: 6.2%, after
      the opacity reset), and the binding variants end within 15% of
      variant 0 (they lost a window's growth);
    - the deletes are the opacity's: count 0 and uv norm 0 make under 10%
      of every run's deletes.

    So at this size none of the JAX package's TPU mechanisms shrinks the
    scene; test_record_windows_without_signal and
    test_bf16_skips_a_step_on_a_long_thin_gaussian show what did at the
    reference scale."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {}
    for v in attribution.VARIANTS:
        with open(tmp_path / f"{v}.log", "w") as log:
            procs[v] = subprocess.Popen(
                [sys.executable, "-m", "tests.schedule_attribution", v,
                 str(tmp_path / f"{v}.json")], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
    for v, p in procs.items():
        assert p.wait(timeout=5400) == 0, (tmp_path / f"{v}.log").read_text()[-3000:]
    runs = {}
    for v in procs:
        with open(tmp_path / f"{v}.json") as f:
            runs[v] = json.load(f)
        print(f"variant {v}: {runs[v]['seconds']:.0f} s, alive after each event "
              f"{[e['alive_after'] for e in runs[v]['events']]}")

    iters = [e["iter"] for e in runs["port"]["events"]]
    assert len(iters) == 20
    for v, r in runs.items():
        ev = r["events"]
        assert [e["iter"] for e in ev] == iters, v
        assert all(e["skipped"] == e["overflow"] and e["hatch"] == 0 for e in ev), v
        assert ev[-1]["alive_after"] > 1.5 * ev[0]["alive_before"], v
        assert all(e["deleted"] <= 0.07 * e["alive_before"] for e in ev), v
        deleted = sum(e["deleted"] for e in ev)
        assert sum(e["reasons"]["opacity"] for e in ev) >= 0.9 * deleted, v
    port, base = runs["port"]["events"], runs["0"]["events"]
    assert runs["0"]["overflow_steps"] == 0 and sum(e["skipped"] for e in port) == 0
    for a, b in zip(base, port):
        assert abs(a["alive_after"] - b["alive_after"]) <= ALIVE_BAND * b["alive_after"]
    for v in ("1", "2", "3"):
        assert runs[v]["overflow_steps"] > 0, v
        assert runs[v]["final_alive"] >= 0.85 * runs["0"]["final_alive"], v
    for v in ("2", "3"):
        first = runs[v]["events"][0]
        assert first["skipped"] == first["steps"] and first["split"] == first["cloned"] == 0, v
