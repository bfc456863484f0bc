"""The ``scaffold`` kind: ``trainer.train_step`` of a Scaffold-GS scene
(``gaussian_splatting_torch.scaffold``) back to back as a training run
issues them, with no per-step synchronise, over a ring of cameras in a
seeded order in which each pass visits every camera once.

Set-up drives the window's own state through its first checked steps;
after the window the plain reference (``reference/scaffold.py``) repeats
them from the same inputs, and ``correct`` compares each step's loss, the
first gradient and every leaf's change (``numbers``; the source's anchor
growing is not run, so there are no densification accumulators).  A traced
run's pairs are counted on each traced step's neural gaussians, decoded by
the reference from a copy of the step's leaves.

Readings for the limits: ``python3 gsbench/scaffold_readings.py``.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from gsbench import check, scene, work
from gsbench import trace as trace_mod
from gsbench.harness import GIB, Result, log, profile, sync, warm_profiler, window_open
from gsbench.reference import scaffold as ref


def numbers(prog: dict, want: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``step_gap`` as ``check.py`` defines
    them, between the program's outcome and the reference's."""
    def rel(a, b, scale):
        if not (math.isfinite(a) and math.isfinite(b)):
            return math.inf
        return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)

    med = statistics.median(want["grads"].values())
    moved = [k for k, g in want["grads"].items() if g >= check.EXCLUDE_BELOW * med]
    return dict(
        loss_gap=max(rel(p, r, abs(r)) for p, r in zip(prog["losses"], want["losses"])),
        grad_gap=check.leaf_gap(prog["grads"], want["grads"], list(want["grads"])),
        step_gap=check.leaf_gap(prog["changes"], want["changes"], moved),
    )


def _norm(x) -> float:
    """The norm of a leaf, or of an MLP's four tensors together."""
    if isinstance(x, (list, tuple)):
        return math.sqrt(sum(check.norm(t) ** 2 for t in x))
    return check.norm(x)


class ScaffoldTrain:
    """Scaffold-GS ``trainer.train_step`` over a ring of cameras."""

    def __init__(self, cell, seed: int, device):
        from gaussian_splatting_torch import scaffold as sc
        from gaussian_splatting_torch.config import SplatConfig

        self.cell, self.device = cell, device
        cfg, tr = cell.config, cell.traffic
        widths = dict(feat_dim=sc.FEAT_DIM, n_offsets=sc.N_OFFSETS, hidden_dim=sc.HIDDEN)
        if any(cfg[k] != v for k, v in widths.items()) or cfg["mlp_outputs"] != sc.HEADS:
            raise SystemExit(f"the program decodes at {widths}, {sc.HEADS}")
        if cfg["learning_rates"] != sc.LEARNING_RATES or cfg["volume_weight"] != sc.VOLUME_WEIGHT:
            raise SystemExit(f"the program trains at {sc.LEARNING_RATES}, volume weight "
                             f"{sc.VOLUME_WEIGHT}")
        s_scene, s_perturb, s_order = scene.seeds(seed, 3)
        self.alive_n = tr.get("alive") or cfg["alive"]
        made = scene.load(cfg, self.alive_n, s_scene, device)
        self.alive = made["alive"]
        self.K = scene.intrinsics(cfg, device)
        self.poses = scene.ring_poses(made, tr["cameras"])
        self.bg = torch.tensor(tr["background"], dtype=torch.float32, device=device)
        self.views = [scene.view(cfg, self.K, p, self.bg) for p in self.poses]
        log(f"scene: {self.alive_n} anchors in {cfg['capacity']} slots")
        p = made["params"]
        self.anchor = p.pop("anchor")
        self.gts = []
        for v in self.views:
            img, _, _ = ref.render(p, self.anchor, self.alive, v)
            self.gts.append((img.clamp(0, 1) * 255).round().to(torch.uint8))
        log(f"ground truth: {len(self.gts)} views by the reference")
        gen = scene.generator(s_perturb, device)
        feat = p["anchor_feat"].clone()
        feat[: self.alive_n] += tr["feat_noise"] * torch.randn(
            self.alive_n, feat.shape[1], generator=gen, device=device)
        self.params0 = dict(p, anchor_feat=feat)  # the MLPs as (w1, b1, w2, b2)
        del made, p
        n = tr["cameras"]
        rng = np.random.default_rng(s_order)
        self.order = np.concatenate([rng.permutation(n) for _ in range(tr["passes"])])
        self.config = SplatConfig(**cfg["splat"])
        self.rates = dict(cfg["learning_rates"])
        self.kw = dict(config=self.config, camera_hw=(cfg["height"], cfg["width"]),
                       n_sh_band=cfg["n_sh_band"])
        self.checked = tr["checked_steps"]

    def step(self, state, i):
        from gaussian_splatting_torch import trainer

        cam = int(self.order[i])
        return trainer.train_step(state, self.gts[cam], self.K, self.poses[cam], self.bg,
                                  **self.kw)

    def _packed0(self) -> dict:
        """The starting leaves as the program packs them."""
        from gaussian_splatting_torch import scaffold as sc

        return {k: sc.pack_mlp(*v) if k in sc.HEADS else v for k, v in self.params0.items()}

    def program(self):
        """The program's state after the checked steps, and its outcome:
        each step's loss, the first gradient as Adam's first moment holds
        it after one step, and every leaf's change after the last checked
        step."""
        from gaussian_splatting_torch import optim, trainer
        from gaussian_splatting_torch import scaffold as sc

        p0 = self.params0
        scene_ = sc.ScaffoldScene(self.anchor, p0["offset"], p0["anchor_feat"], p0["scaling"],
                                  self.alive, mlps={k: p0[k] for k in sc.HEADS})
        state = trainer.init_train_state(scene_, self.config)
        del scene_
        losses, grads = [], None
        for i in range(self.checked):
            state, info = self.step(state, i)
            losses.append(info["loss"])
            if i == 0:
                grads = {k: check.norm(v / (1 - optim.B1)) for k, v in state.opt_state.mu.items()}
        start = self._packed0()
        out = dict(losses=[float(x) for x in losses], grads=grads,
                   changes={k: check.norm(state.params[k] - start[k]) for k in start})
        return state, out

    def reference(self, dtype=torch.float32):
        """The plain reference's outcome from the same inputs, in ``dtype``."""
        def cast(t):
            return t.to(self.device, dtype)

        p0 = {k: [cast(t) for t in v] if k in ref.HEADS else cast(v)
              for k, v in self.params0.items()}
        views = [scene.view(self.cell.config, self.K, self.poses[int(c)], self.bg, dtype)
                 for c in self.order[: self.checked]]
        gts = [self.gts[int(c)] for c in self.order[: self.checked]]
        r = ref.train_steps(p0, cast(self.anchor), self.alive, views, gts,
                            self.cell.config["splat"], self.rates,
                            self.cell.config["volume_weight"])

        def change(k):
            now, was = r["params"][k], self.params0[k]
            if k in ref.HEADS:
                return [a.float() - b.to(self.device) for a, b in zip(now, was)]
            return now.float() - was.to(self.device)

        return dict(losses=r["losses"],
                    grads={k: _norm(v) for k, v in r["first_grads"].items()},
                    changes={k: _norm(change(k)) for k in ref.LEAVES})

    def pair_counts(self, leaves: dict, cam: int) -> dict:
        """``work.pair_counts`` on a traced step's neural gaussians, which the
        reference decodes from a copy of the step's leaves, with the
        anchors it decoded and the slots and MLP floats Adam reads."""
        from gaussian_splatting_torch import scaffold as sc

        p = {k: sc.unpack_mlp(v, sc.HEADS[k]) if k in sc.HEADS else v
             for k, v in leaves.items()}
        with torch.no_grad():
            g = ref.decode(p, self.anchor, self.alive, self.views[cam])
            n = g["xyz"].shape[0]
            c = work.pair_counts(ref.splat_params(g), torch.ones(n, dtype=torch.bool,
                                                                 device=self.device),
                                 self.views[cam])
        c.update(anchors=g["anchors"], anchor_slots=int(self.alive.shape[0]),
                 mlp_floats=sum(int(leaves[k].numel()) for k in sc.HEADS))
        return c

    def run(self, seconds: float, traced: bool, t_process: float) -> Result:
        state, prog = self.program()
        log(f"program: {self.checked} checked steps")
        i = self.checked
        for _ in range(self.cell.traffic["cameras"]):  # warm-up: every camera once
            state, _ = self.step(state, i)
            i += 1

        def to(dev):
            return {k: [t.to(dev) for t in v] if k in ref.HEADS else v.to(dev)
                    for k, v in self.params0.items()}

        self.params0 = to("cpu")  # the reference's inputs wait on the host
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
                    snaps.append((int(self.order[i]), {k: v.detach().clone()
                                                       for k, v in state.params.items()}))
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
            traced_out.work = [self.pair_counts(leaves, cam) for cam, leaves in snaps]
            del snaps
        self.params0 = to(self.device)
        log(f"window: {steps} steps in {window:.3f} s")
        if traced_out is not None:
            log("trace read, pairs counted")
        checks = check.with_limits(numbers(prog, self.reference()), self.cell.limits)
        log("reference: checked steps")
        return Result(correct=check.passed(checks), attempted=steps, failed=failed,
                      metrics=metrics, checks=checks, peak_bytes=peak, trace=traced_out)


def make(cell, seed: int, device) -> ScaffoldTrain:
    return ScaffoldTrain(cell, seed, device)

