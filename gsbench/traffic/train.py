"""The ``train`` kind: ``trainer.train_step`` back to back as a training
run issues them, with no per-step synchronise, over a ring of cameras in a
seeded order in which each pass visits every camera once.

Set-up drives the window's own state through its first checked steps;
after the window the plain reference repeats them from the same inputs,
and ``correct`` compares each step's loss, the first gradient, every
leaf's change and the accumulators (``check.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from gsbench import check, scene, work
from gsbench import trace as trace_mod
from gsbench.harness import GIB, Result, log, profile, sync, warm_profiler, window_open
from gsbench.reference import splat as ref

GEOMETRY = ("xyz", "opacity", "scale", "quaternion")  # what decides the pairs


class Train:
    """``trainer.train_step`` over a ring of cameras, in a seeded order in
    which each pass visits every camera once."""

    def __init__(self, cell, seed: int, device):
        from gaussian_splatting_torch.config import SplatConfig

        self.cell, self.device = cell, device
        cfg, tr = cell.config, cell.traffic
        s_scene, s_perturb, s_order = scene.seeds(seed, 3)
        self.alive_n = tr.get("alive") or cfg["alive"]
        sc = scene.load(cfg, self.alive_n, s_scene, device)
        self.alive = sc["alive"]
        self.K = scene.intrinsics(cfg, device)
        self.poses = scene.ring_poses(sc, tr["cameras"])
        self.bg = torch.tensor(tr["background"], dtype=torch.float32, device=device)
        self.views = [scene.view(cfg, self.K, p, self.bg) for p in self.poses]
        log(f"scene: {self.alive_n} alive in {cfg['capacity']} slots")
        self.gts = scene.ground_truth(sc["params"], self.alive, self.views)
        log(f"ground truth: {len(self.gts)} views by the reference")
        self.params0 = scene.perturb(sc["params"], self.alive_n, tr, s_perturb)
        del sc
        n = tr["cameras"]
        rng = np.random.default_rng(s_order)
        self.order = np.concatenate([rng.permutation(n) for _ in range(tr["passes"])])
        self.config = SplatConfig(**cfg["splat"])
        self.kw = dict(config=self.config, camera_hw=(cfg["height"], cfg["width"]),
                       n_sh_band=cfg["n_sh_band"])
        self.checked = tr["checked_steps"]

    def step(self, state, i):
        from gaussian_splatting_torch import trainer

        cam = int(self.order[i])
        return trainer.train_step(state, self.gts[cam], self.K, self.poses[cam], self.bg,
                                  **self.kw)

    def program(self):
        """The program's state after the checked steps, and its outcome:
        each step's loss, the first gradient as Adam's first moment holds
        it after one step, and the change of every leaf and accumulator
        after the last checked step."""
        from gaussian_splatting_torch import optim, trainer
        from gaussian_splatting_torch.structs import GaussianScene

        p0 = self.params0
        gs = GaussianScene(p0["xyz"], p0["rgb"], p0["opacity"], p0["scale"],
                           p0["quaternion"], p0["sh"], self.alive)
        state = trainer.init_train_state(gs, self.config)
        del gs
        losses, grads = [], None
        for i in range(self.checked):
            state, info = self.step(state, i)
            losses.append(info["loss"])
            if i == 0:
                grads = {k: check.norm(v / (1 - optim.B1))
                         for k, v in state.opt_state.mu.items()}
        out = check.train_outcome(
            [float(x) for x in losses], grads,
            {k: check.norm(state.params[k] - p0[k]) for k in p0},
            {k: check.norm(getattr(state, k)) for k in check.ACCUMULATORS})
        return state, out

    def reference(self, dtype=torch.float32):
        """The plain reference's outcome from the same inputs, in ``dtype``."""
        cast = {k: v.to(self.device, dtype) for k, v in self.params0.items()}
        views = [scene.view(self.cell.config, self.K, self.poses[int(c)], self.bg, dtype)
                 for c in self.order[: self.checked]]
        gts = [self.gts[int(c)] for c in self.order[: self.checked]]
        r = ref.train_steps(cast, self.alive, views, gts, self.cell.config["splat"])
        return check.train_outcome(
            r["losses"], {k: check.norm(v) for k, v in r["first_grads"].items()},
            {k: check.norm(r["params"][k].float() - self.params0[k].to(self.device))
             for k in ref.LEAVES},
            {k: check.norm(r[k]) for k in check.ACCUMULATORS})

    def run(self, seconds: float, traced: bool, t_process: float) -> Result:
        state, prog = self.program()
        log(f"program: {self.checked} checked steps")
        i = self.checked
        for _ in range(self.cell.traffic["cameras"]):  # warm-up: every camera once
            state, _ = self.step(state, i)
            i += 1
        # the reference's inputs wait on the host while the window runs
        self.params0 = {k: v.cpu() for k, v in self.params0.items()}
        count0 = int(state.opt_state.count)
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        n_cam = self.cell.traffic["cameras"]
        trace_from = -(-(i + n_cam) // n_cam) * n_cam  # a whole pass, one pass in
        prof, snaps, tr = None, [], None
        if traced:
            warm_profiler(self.device)
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        steps = 0
        while window_open(t0, seconds, traced, tr):
            if traced and i == trace_from:
                t_in = time.perf_counter()
                prof = profile(self.device)
                prof.start()
                sync(self.device)
                t_a = time.perf_counter()
            if prof is not None and len(snaps) < n_cam:
                with record_function(trace_mod.HARNESS):
                    snaps.append((int(self.order[i]), {k: state.params[k].detach().clone()
                                                       for k in GEOMETRY}))
            state, _ = self.step(state, i)
            i += 1
            steps += 1
            if prof is not None and len(snaps) == n_cam and tr is None:
                sync(self.device)
                t_b = time.perf_counter()
                prof.stop()
                tr = (prof, t_b - t_a, time.perf_counter() - t_in)
        sync(self.device)
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        failed = steps - (int(state.opt_state.count) - count0)
        del state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        metrics = dict(train_step_ms=window / steps * 1e3, setup_s=setup_s,
                       peak_gib=peak / GIB)
        traced_out = None
        if tr is not None:
            traced_out = trace_mod.read(tr[0], n_cam, tr[1])
            traced_out.step_s = (window - tr[2]) / (steps - n_cam)
            traced_out.per_pixel = not self.config.use_sh_precompute
            traced_out.work = [work.pair_counts(_colourless(snap), self.alive, self.views[cam])
                               for cam, snap in snaps]
            del snaps
        self.params0 = {k: v.to(self.device) for k, v in self.params0.items()}
        log(f"window: {steps} steps in {window:.3f} s")
        if traced_out is not None:
            log("trace read, pairs counted")
        checks = check.with_limits(check.train_numbers(prog, self.reference()),
                                    self.cell.limits)
        log("reference: checked steps")
        return Result(correct=check.passed(checks), attempted=steps, failed=failed,
                      metrics=metrics, checks=checks, peak_bytes=peak, trace=traced_out)


def _colourless(geometry: dict) -> dict:
    """A traced step's geometry leaves with zero colour: colour plays no
    part in which pairs the walk reaches."""
    n, dev = geometry["xyz"].shape[0], geometry["xyz"].device
    return dict(geometry, rgb=torch.zeros(n, 3, device=dev),
                sh=torch.zeros(n, 3, scene.SH_REST, device=dev))


def make(cell, seed: int, device) -> Train:
    return Train(cell, seed, device)
