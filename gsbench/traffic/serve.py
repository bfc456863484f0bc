"""The ``serve`` kind: one viewer in a closed loop.  Each request renders a
camera of the orbit with ``rasterize.rasterize`` under
``no_grad``, as ``render_torch.py::render_views`` does, and ends when its
uint8 image is in host memory: copied into one page-locked buffer that
set-up allocates, as a server that sends each view on would hold it.

The orbit's cameras are one fixed set, drawn from the mix's ``pool_seed``
(azimuth uniform, elevation uniform within the mix's bound), the same in
every run; the run's seed makes the scene and the order of the requests,
each pass over the set in an order of its own.  So every seed asks for the
same views, in another order.

``correct`` compares the image and the transmittance of a sample of the
window's views, drawn from the seed, with the plain reference's
(``check.py``); their float copies go to page-locked buffers of their own
after the view's latency is taken.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from gsbench import check, scene, work
from gsbench import trace as trace_mod
from gsbench.harness import GIB, Result, log, profile, sync, warm_profiler, window_open
from gsbench.reference import splat as ref


def _host(like, pinned: bool) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=pinned)


class Serve:
    """One viewer in a closed loop: each request renders a camera drawn on
    the orbit and ends when the image is on the host as uint8."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, device
        cfg, tr = cell.config, cell.traffic
        s_scene, s_order, s_sample = scene.seeds(seed, 3)
        alive_n = tr.get("alive") or cfg["alive"]
        sc = scene.load(cfg, alive_n, s_scene, device)
        self.params, self.alive = sc["params"], sc["alive"]
        self.K = scene.intrinsics(cfg, device)
        self.poses = scene.orbit_poses(sc, tr["pool"], tr["max_elevation_deg"], tr["pool_seed"])
        rng = np.random.default_rng(s_order)
        self.order = np.concatenate([rng.permutation(tr["pool"]) for _ in range(tr["passes"])])
        self.bg = torch.tensor(tr["background"], dtype=torch.float32, device=device)
        rng = np.random.default_rng(s_sample)
        self.sample = sorted(rng.choice(tr["sample_from"], tr["checked_views"], replace=False))
        self.warm = tr["warmup_views"]
        self.pinned = device.type == "cuda"
        self.out = torch.empty((cfg["height"], cfg["width"], 3), dtype=torch.uint8,
                               pin_memory=self.pinned)

    def rasterize(self, i):
        """Request i's rendered result, on the device."""
        from gaussian_splatting_torch.rasterize import rasterize
        from gaussian_splatting_torch.structs import Camera

        cfg, s = self.cell.config, self.cell.config["splat"]
        with torch.no_grad():
            return rasterize(
                self.params, self.alive, self.pose(i),
                Camera(K=self.K, width=cfg["width"], height=cfg["height"]),
                near_thresh=s["near_thresh"], far_thresh=s["far_thresh"],
                cull_mask_padding=s["cull_mask_padding"], mh_dist=s["mh_dist"],
                background_rgb=self.bg, n_sh_band=cfg["n_sh_band"],
                use_sh_precompute=s["use_sh_precompute"])

    def render(self, i):
        """Request i: its rendered result, once its uint8 image is in host
        memory (``self.out``)."""
        res = self.rasterize(i)
        with torch.no_grad():
            self.out.copy_((res.image.clamp(0, 1) * 255).to(torch.uint8), non_blocking=True)
        sync(self.device)
        return res

    def pose(self, i):
        """Request i's camera."""
        return self.poses[int(self.order[i % len(self.order)])]

    def views(self, idx, dtype=torch.float32):
        return [scene.view(self.cell.config, self.K, self.pose(i), self.bg, dtype)
                for i in idx]

    def program(self):
        """The program's images and transmittances of the checked views,
        each rendered as a request is."""
        kept = {}
        for i in self.sample:
            res = self.render(self.warm + i)
            kept[i] = (res.image, res.transmittance)
        return kept

    def reference(self, idx, dtype=torch.float32):
        params = {k: v.to(dtype) for k, v in self.params.items()}
        out = {}
        for i, v in zip(idx, self.views([self.warm + i for i in idx], dtype)):
            img, T, _ = ref.render(params, self.alive, v)
            out[i] = (img.float(), T.float())
        return out

    def run(self, seconds: float, traced: bool, t_process: float) -> Result:
        for i in range(self.warm):
            res = self.render(i)
        # the checked views' copies, page-locked like the image's
        kept = {int(i): (_host(res.image, self.pinned), _host(res.transmittance, self.pinned))
                for i in self.sample}
        del res
        log(f"warm-up: {self.warm} views")
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        n_trace = self.cell.traffic["traced_views"]
        trace_from = self.cell.traffic["trace_from"]
        got, lat, prof, tr, traced_idx = set(), [], None, None, []
        if traced:
            warm_profiler(self.device)
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        k = 0
        while window_open(t0, seconds, traced, tr):
            if traced and k == trace_from:
                t_in = time.perf_counter()
                prof = profile(self.device)
                prof.start()
                sync(self.device)
                t_a = time.perf_counter()
            t_req = time.perf_counter()
            res = self.render(self.warm + k)
            lat.append(time.perf_counter() - t_req)
            if k in kept:  # after the latency; the next view's sync ends the copies
                with record_function(trace_mod.HARNESS):
                    kept[k][0].copy_(res.image, non_blocking=True)
                    kept[k][1].copy_(res.transmittance, non_blocking=True)
                got.add(k)
            del res
            if prof is not None and tr is None:
                traced_idx.append(k)
                if len(traced_idx) == n_trace:
                    t_b = time.perf_counter()
                    prof.stop()
                    tr = (prof, t_b - t_a, time.perf_counter() - t_in)
            k += 1
        window = time.perf_counter() - t0
        sync(self.device)
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        metrics = dict(views_per_s=k / window,
                       view_ms_p95=statistics.quantiles(lat, n=20)[-1] * 1e3 if len(lat) > 1
                       else lat[0] * 1e3,
                       setup_s=setup_s, peak_gib=peak / GIB)
        traced_out = None
        if tr is not None:
            traced_out = trace_mod.read(tr[0], n_trace, tr[1])
            traced_out.step_s = (window - tr[2]) / (k - n_trace)
            traced_out.per_pixel = not self.cell.config["splat"]["use_sh_precompute"]
            traced_out.work = [work.pair_counts(self.params, self.alive, v)
                               for v in self.views([self.warm + i for i in traced_idx])]
        log(f"window: {k} views in {window:.3f} s")
        due = [i for i in self.sample if i < k]  # the sampled views the window asked for
        kept = {i: (img.to(self.device), T.to(self.device))
                for i, (img, T) in kept.items() if i in got}
        checks = check.compare_serve(kept, self.reference(sorted(kept)), self.cell.limits,
                                     want=max(len(due), 1))
        return Result(correct=check.passed(checks), attempted=k, failed=0, metrics=metrics,
                      checks=checks, peak_bytes=peak, trace=traced_out)


def make(cell, seed: int, device) -> Serve:
    return Serve(cell, seed, device)
