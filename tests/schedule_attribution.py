"""Which of the JAX runner's TPU mechanisms shrinks a synthetic scene that
the port grows: one scene and one compressed schedule, trained by the JAX
package's ``TrainingRunner`` in four configurations and by the port's
runner, every adaptive density control (ADC) event logged with its deletes
split by reason.

The variants differ only in the JAX config (``VARIANTS``):

- ``0``: ``kernel_precision="f32"``, ``steps_per_dispatch=1`` and a splat
  capacity whose default tier capacities hold every frame: the baseline;
- ``1``: (0) with capacities that bind: tier capacities at their floors, so
  the first frames overflow and the runner learns its tier capacities from
  the frames' peaks, then grows them on each later overflow (overflowing
  steps are skipped, ``overflow_updates=False``);
- ``2``: (1) with ``steps_per_dispatch=25``: the runner sees an overflow only
  when it drains the dispatches, at the next ADC event;
- ``3``: (2) with ``kernel_precision="bf16"``: the configuration of
  ``runs/refscale7k``;
- ``port``: the port's runner on the CPU (no capacities, no skipped step).

For each event: alive before, deleted, cloned, split, alive after; the
deletes by reason, from the state before the event (the port's
``trainer.delete_reasons``: opacity, never seen, seen with a uv gradient
of norm 0); the steps of the window before it, those skipped, those that
overflowed, and those that ran with the escape hatch
(``overflow_updates=True``) on.  For the port, also the deletes of each
window cut to its last k steps (``chip_smoke.delete_census``).

    JAX_PLATFORMS=cpu python -m tests.schedule_attribution VARIANT OUT.json

runs one variant (``tests/test_torch_schedule.py::test_attribution`` starts
all five side by side, as processes of their own).  ``nonfinite`` in place
of a variant runs ``nonfinite_steps`` on the card: the port's own skipped
steps at the reference scale, and what their gradients hold.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

# the scene: 3,000 secret points, 600 of them as the initial gaussians, 24
# ring views at 64x48 (3 held out for test)
SCENE = dict(synthetic_points=3000, synthetic_init_points=600, synthetic_images=24,
             synthetic_width=64, synthetic_height=48, test_split_ratio=8, seed=0)
# refscale7k's schedule compressed: 20 ADC events every 50 steps from 50 to
# 1000 (the reference: 57 every 100 from 800 to 6400), the opacity reset at
# the 8th (3001, after the 23rd), evals at 0, 500 and 1000, then the end at
# 1025; SH band 0 throughout (a band is a recompile of every JAX step in
# interpret mode).  Every event falls on a multiple of 25, so that with
# steps_per_dispatch 25 each window is two whole dispatches, as each of the
# reference's is four.
SCHEDULE = dict(num_iters=1025, adaptive_control_start=0, adaptive_control_interval=50,
                adaptive_control_end=1001, reset_opacity_start=300,
                reset_opacity_interval=400, reset_opacity_end=500, test_eval_interval=500,
                print_interval=50, save_debug_image_interval=0, checkpoint_interval=0,
                add_sh_band_interval=1_000_000)
# splat_capacity 1 << 15 gives default tier capacities that hold every
# frame of this scene, the ground truth's included (the JAX runner renders
# it at the config's splat_capacity); the variants that bind start from
# tier capacities at their floors (culling.TIER_FLOORS), which the first
# frames overflow, so the runner learns them from the frames' peaks
ROOMY = 1 << 15
FLOORS = (1,) * 23  # one per culling.TIER_CELLS, raised to its floor
VARIANTS = {
    "0": dict(kernel_precision="f32", steps_per_dispatch=1, splat_capacity=ROOMY),
    "1": dict(kernel_precision="f32", steps_per_dispatch=1, splat_capacity=ROOMY,
              tier_capacities=FLOORS),
    "2": dict(kernel_precision="f32", steps_per_dispatch=25, splat_capacity=ROOMY,
              tier_capacities=FLOORS),
    "3": dict(kernel_precision="bf16", steps_per_dispatch=25, splat_capacity=ROOMY,
              tier_capacities=FLOORS),
    "port": {},
}


def _event_row(iteration, before, stats, config, window):
    """One event's log line from the state before it (numpy leaves): its
    deletes by reason (the port's trainer.delete_reasons, which add up to
    the event's n_deleted) and the window's step counts."""
    from gaussian_splatting_torch import convert, trainer

    state = convert.train_state_from_numpy(before, "cpu")
    reasons = {k: int(v) for k, v in trainer.delete_reasons(state, config).items()}
    row = dict(iter=int(iteration), alive_before=int(state.alive.sum()),
               deleted=int(stats["n_deleted"]), cloned=int(stats["n_clone"]),
               split=int(stats["n_split"]), alive_after=int(stats["n_alive"]),
               reasons=reasons, **window)
    assert sum(reasons.values()) == row["deleted"], row
    return row


def _new_window():
    # steps taken, skipped (the Adam count did not advance: an overflow, or
    # a loss or gradient that is not finite), overflowed, and taken with the
    # escape hatch on
    return dict(steps=0, skipped=0, overflow=0, hatch=0)


def run_jax(variant: str, out: str) -> dict:
    """The JAX runner on SCENE and SCHEDULE in one of VARIANTS."""
    import jax

    from gaussian_splatting_tpu import runner as jrunner
    from gaussian_splatting_tpu import trainer as jtrainer
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data

    cfg = JConfig(**SCENE, **SCHEDULE, **VARIANTS[variant], output_dir=out)
    events, window = [], _new_window()
    step, scan, adc = (jtrainer.train_step, jtrainer.train_steps_scan,
                       jtrainer.adaptive_density_control)
    process = jrunner.TrainingRunner._process_info

    def counted(fn, n, state, *args, config, **kwargs):
        adam_count = int(state.opt_state[0].count)  # the step donates state
        state, info = fn(state, *args, config=config, **kwargs)
        window["steps"] += n
        window["skipped"] += n - (int(state.opt_state[0].count) - adam_count)
        window["hatch"] += n * bool(config.overflow_updates)
        return state, info

    def train_step(state, *args, **kwargs):
        return counted(step, 1, state, *args, **kwargs)

    def train_steps_scan(state, *args, n_steps, **kwargs):
        return counted(scan, n_steps, state, *args, n_steps=n_steps, **kwargs)

    def process_info(self, i, info):
        window["overflow"] += bool(info["overflow"])
        return process(self, i, info)

    def density_control(state, key, iteration, *, config):
        before = jax.tree_util.tree_map(np.asarray, state)
        state, stats = adc(state, key, iteration, config=config)
        events.append(_event_row(iteration, before, jax.device_get(stats), config,
                                 dict(window)))
        window.update(_new_window())
        return state, stats

    jtrainer.train_step, jtrainer.train_steps_scan = train_step, train_steps_scan
    jtrainer.adaptive_density_control = density_control
    jrunner.TrainingRunner._process_info = process_info
    try:
        data = make_synthetic_scene_data(cfg.synthetic_points, cfg.synthetic_images,
                                         cfg.seed, cfg.synthetic_width, cfg.synthetic_height)
        runner = jrunner.TrainingRunner(data, cfg, synthetic=True)
        runner.train()
    finally:
        jtrainer.train_step, jtrainer.train_steps_scan = step, scan
        jtrainer.adaptive_density_control = adc
        jrunner.TrainingRunner._process_info = process
    m = runner.metrics
    return dict(events=events, overflow_steps=m.overflow_steps,
                truncated_steps=m.truncated_steps, test_psnr=m.test_psnr,
                final_alive=int(np.asarray(runner.state.alive).sum()))


def run_port(out: str) -> dict:
    """The port's runner on SCENE and SCHEDULE, on the CPU, with
    chip_smoke.delete_census's deletes of windows cut to their last k
    steps."""
    import chip_smoke
    from gaussian_splatting_torch import convert
    from gaussian_splatting_torch import runner as trunner
    from gaussian_splatting_torch import trainer as ttrainer
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data

    cfg = SplatConfig(**SCENE, **SCHEDULE, output_dir=out)
    events, window, census = [], _new_window(), []
    adc, step = ttrainer.adaptive_density_control, ttrainer.train_step

    def train_step(state, *args, **kwargs):
        adam_count = state.opt_state.count
        state, info = step(state, *args, **kwargs)
        window["steps"] += 1
        window["skipped"] += int(state.opt_state.count == adam_count)
        return state, info

    def density_control(state, generator, iteration, *, config):
        before = convert.train_state_to_numpy(state)
        state, stats = adc(state, generator, iteration, config=config)
        events.append(_event_row(iteration, before, {k: v.item() for k, v in stats.items()},
                                 config, dict(window)))
        window.update(_new_window())
        return state, stats

    ttrainer.train_step, ttrainer.adaptive_density_control = train_step, density_control
    try:
        data = make_synthetic_scene_data(cfg.synthetic_points, cfg.synthetic_images,
                                         cfg.seed, cfg.synthetic_width, cfg.synthetic_height)
        adc_iters = [i for i in range(cfg.num_iters) if trunner.scheduled_events(cfg, i).adc]
        with chip_smoke.delete_census(ttrainer, adc_iters, census):
            runner = trunner.TrainingRunner(data, cfg, synthetic=True, device="cpu")
            runner.train()
    finally:
        ttrainer.train_step, ttrainer.adaptive_density_control = step, adc
    for e, (_, row) in zip(events, census):
        e["short_windows"] = {k: dict(count0=row[3 + 2 * j], uv0=row[4 + 2 * j])
                              for j, k in enumerate(chip_smoke.REFSCALE_SHORT_WINDOWS)}
    m = runner.metrics
    return dict(events=events, overflow_steps=0, truncated_steps=m.truncated_steps,
                test_psnr=m.test_psnr, final_alive=int(runner.state.alive.sum()))


def nonfinite_steps(out: str, device: str = "cuda", num_iters: int = 3400,
                    most: int = 40) -> dict:
    """The reference-scale run (``refscale_run``'s flags, cut to
    ``num_iters``) on ``device``; each step the port skips (its Adam count
    does not advance), up to ``most``, is taken again with its gradients
    kept: which leaves are not finite, in how many slots, and what those
    slots hold.  For the card: ``python -m tests.schedule_attribution
    nonfinite OUT.json``."""
    import torch

    import train_torch
    from gaussian_splatting_torch import trainer
    from gaussian_splatting_torch.experiments import refscale_run
    from gaussian_splatting_torch.rasterize import _camera_rows
    from gaussian_splatting_torch.structs import Camera

    step, records, calls = trainer.train_step, [], [0]

    def train_step(state, gt, K, pose, bg, *, config, camera_hw, n_sh_band):
        i = calls[0]
        calls[0] += 1
        new, info = step(state, gt, K, pose, bg, config=config, camera_hw=camera_hw,
                         n_sh_band=n_sh_band)
        if len(records) < most and bool(new.opt_state.count == state.opt_state.count):
            loss, _, grads, g_uv = trainer.camera_loss(
                state, gt, K, pose, bg, config=config, camera_hw=camera_hw,
                n_sh_band=n_sh_band)
            bad = torch.zeros_like(state.alive)
            leaves = {}
            for name, g in dict(grads, uv=g_uv.T).items():
                rows = ~torch.isfinite(g.reshape(g.shape[0], -1)).all(dim=1)
                leaves[name] = int(rows.sum())
                bad |= rows
            slots = torch.nonzero(bad).flatten()[:8]
            h, w = camera_hw
            p = {k: v[slots] for k, v in state.params.items()}
            _, _, zc, u, v, conic3, _ = _camera_rows(p, pose, Camera(K=K, width=w, height=h))
            records.append(dict(
                iteration=i, band=n_sh_band, loss=float(loss), leaves=leaves,
                slots=slots.tolist(), alive=state.alive[slots].tolist(),
                log_scale=p["scale"].tolist(), opacity=p["opacity"][:, 0].tolist(),
                quat_norm=p["quaternion"].norm(dim=1).tolist(), z_camera=zc.tolist(),
                uv=torch.stack([u, v], 1).tolist(),
                cov2d=torch.stack(list(conic3), 1).tolist()))
            print(json.dumps(records[-1]), flush=True)
        return new, info

    trainer.train_step = train_step
    try:
        runner = train_torch.main(refscale_run.train_argv(out, device, num_iters=num_iters,
                                                          checkpoint_interval=0))
    finally:
        trainer.train_step = step
    return dict(skipped=records, steps=calls[0], final_alive=int(runner.state.alive.sum()))


def main(argv=None):
    variant, path = (argv or sys.argv[1:])[:2]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out:
        if variant == "nonfinite":
            result = nonfinite_steps(out)
            result.update(seconds=time.time() - t0)
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
            print(f"{len(result['skipped'])} skipped steps in {result['steps']}, "
                  f"{result['seconds']:.0f} s")
            return
        result = run_port(out) if variant == "port" else run_jax(variant, out)
    result.update(variant=variant, config=VARIANTS[variant], scene=SCENE,
                  schedule=SCHEDULE, seconds=time.time() - t0)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    for e in result["events"]:
        print(json.dumps(e))
    print(f"variant {variant}: {result['seconds']:.0f} s, final alive {result['final_alive']}, "
          f"overflow steps {result['overflow_steps']}")


if __name__ == "__main__":
    if sys.argv[1] != "nonfinite":  # the card's machine has no jax
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        # the suite's settings (tests/conftest.py)
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    main()
