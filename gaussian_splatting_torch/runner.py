"""The training loop (counterpart of
``gaussian_splatting_tpu/runner.py``).

Owns the schedule: which iteration evaluates the test split, densifies,
resets opacity, adds an SH band, saves a debug image or a checkpoint, in
the JAX runner's order, with the same numpy draws for the synthetic init
subset and the views.  The device work is ``trainer.py``'s.

Each step's info (0-d tensors) is read on the host ``DRAIN_LAG`` steps
after the step, in ``_drain``, so the host never waits for the step it
has just queued; the layout's own size reads (``culling.build_layout``)
remain.

With ``data_parallel`` * ``model_parallel`` > 1 the runner is one rank of
a process group of that many ranks (``train_torch.py`` starts them): the
JAX runner's modes over a ``parallel.comm`` mesh.  Data parallelism
renders one camera a rank (every rank draws the same cameras and takes its
own); model parallelism shards the state's slots over the model group and
renders the image in tile-row bands; both together use a (dp, mp) mesh.
Every rank renders the synthetic ground truth itself.  Adaptive density
control runs on the whole state: a sharded state is gathered, every rank
runs the single-device event with the same generator, and each keeps its
shard, which keeps the event's global pairing of candidates with free
slots.  Only rank 0 prints and writes files; with data parallelism only
rank 0 evaluates (its replica is the state), with model parallelism every
rank renders its band of each eval view.

Not ported, by design: the JAX runner's capacity machinery (rebucketing,
eval capacities, overflow retries and the buckets it saves with a
checkpoint), because the port has no capacities; ``steps_per_dispatch``,
a TPU dispatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from gaussian_splatting_torch import checkpoint as ckpt
from gaussian_splatting_torch import trainer as T
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio.dataset import SceneData, create_scene
from gaussian_splatting_torch.dataio.png import write_png
from gaussian_splatting_torch.parallel import comm, gsharded
from gaussian_splatting_torch.parallel import mesh as pmesh
from gaussian_splatting_torch.plot import terminal_plot
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera, GSMetricsLog

# steps queued ahead of the host's read of their info (the JAX runner's lag)
DRAIN_LAG = 4
# the synthetic ground truth: every secret gaussian at pre-sigmoid opacity
# 2.0, its log-scales raised by U(0.3, 1.2), as the JAX runner renders it
GT_OPACITY = 2.0
GT_SCALE_RAISE = (0.3, 1.2)


def derive_capacity(n_points: int, config: SplatConfig) -> int:
    """Gaussian slots for a scene of ``n_points``: ``gaussian_capacity``
    when set, else the next power of two with 8x headroom, capped by
    ``max_gaussians`` (the JAX runner's rule)."""
    if config.gaussian_capacity > 0:
        return config.gaussian_capacity
    cap = 1 << max(int(np.ceil(np.log2(max(n_points * 8, 1024)))), 10)
    return min(cap, 1 << int(np.ceil(np.log2(config.max_gaussians * 1.05))))


class Events(NamedTuple):
    """The schedule's events at one iteration, in the order ``train`` runs
    them: the test-split eval before the step, then after it adaptive
    density control, the opacity reset, the debug image and the periodic
    checkpoint."""

    eval: bool
    adc: bool
    reset: bool
    debug_image: bool
    checkpoint: bool


def scheduled_events(config: SplatConfig, i: int) -> Events:
    """Which events fire at iteration ``i`` of ``train``'s loop (the JAX
    runner's conditions).  The eval at ``num_iters`` comes from the loop's
    tail, not from here."""
    c = config
    return Events(
        eval=i % c.test_eval_interval == 0,
        adc=(c.adaptive_control_start < i < c.adaptive_control_end
             and i % c.adaptive_control_interval == 0),
        reset=(c.reset_opacity_start < i < c.reset_opacity_end
               and i % c.reset_opacity_interval == 0),
        debug_image=(c.save_debug_image_interval > 0 and i > 0
                     and i % c.save_debug_image_interval == 0),
        checkpoint=c.checkpoint_interval > 0 and i > 0 and i % c.checkpoint_interval == 0,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainingRunner:
    def __init__(self, data: SceneData, config: SplatConfig, synthetic: bool = False,
                 *, device):
        dp, mp = config.data_parallel, config.model_parallel
        if dp > 1 and len({(c.height, c.width) for c in data.cameras.values()}) > 1:
            raise ValueError("data_parallel>1 requires a single camera resolution; got "
                             f"{sorted({(c.height, c.width) for c in data.cameras.values()})}")
        self.data = data
        self.config = config
        self.synthetic = synthetic
        self.device = torch.device(device)
        self.metrics = GSMetricsLog()
        self.rng = np.random.default_rng(config.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.mesh = None  # the parallel layout, when this is one rank of dp * mp
        self.primary = True  # the rank that prints and writes files

        # synthetic runs train from a sparse subset of the secret scene's
        # points, so ADC must grow the scene; the ground truth uses them all
        init_data = data
        if synthetic and 0 < config.synthetic_init_points < data.xyz.shape[0]:
            sel = np.sort(self.rng.choice(
                data.xyz.shape[0], config.synthetic_init_points, replace=False))
            init_data = dataclasses.replace(data, xyz=data.xyz[sel], rgb=data.rgb[sel])

        capacity = derive_capacity(init_data.xyz.shape[0], config)
        if dp * mp > 1:
            self._join(dp, mp)
        self._say(f"points: {init_data.xyz.shape[0]}  capacity: {capacity}  "
                  f"device: {self.device}"
                  + (f"  data_parallel: {dp}  model_parallel: {mp}  backend: "
                     f"{self.mesh.backend}" if self.mesh else ""))
        if config.load_checkpoint and config.checkpoint_path:
            self.state, self.start_iter, self.generator = ckpt.load_checkpoint(
                config.checkpoint_path, config, device=self.device)
            self._say(f"resumed from {config.checkpoint_path} at iteration "
                      f"{self.start_iter}")
        elif config.load_ply:
            # initialise (or fine-tune) from a community 3DGS .ply, with the
            # slot capacity derived from the ply's own gaussian count
            scene = ckpt.import_ply(config.load_ply, device=self.device)
            n_ply = scene.num_alive()
            ply_cap = derive_capacity(n_ply, config)
            if ply_cap > scene.capacity:
                scene = ckpt.import_ply(config.load_ply, device=self.device,
                                        capacity=ply_cap)
            self._say(f"loaded {n_ply} gaussians from {config.load_ply}")
            self.state = T.init_train_state(scene, config)
            self.start_iter = 0
        else:
            scene = create_scene(init_data, config, capacity, self.device)
            self.state = T.init_train_state(scene, config)
            self.start_iter = 0
        if mp > 1 and self.state.alive.shape[0] % mp:
            raise ValueError(f"gaussian capacity {self.state.alive.shape[0]} must divide "
                             f"model_parallel={mp}")
        self._place()

        # every test_split_ratio-th image is held out for test
        all_idx = np.arange(len(data.images))
        self.test_split = all_idx[:: config.test_split_ratio]
        self.train_split = np.setdiff1d(all_idx, self.test_split)
        if len(self.train_split) == 0:
            self.train_split = all_idx

        self._gt_cache = {}  # synthetic: float ground truth on the device
        self._gt_dev = {}
        self._cam_dev = {}
        self._pending: list = []
        self._last_info = (0, {})
        self.peak_splats = 0
        self._truncated_seen = False
        # the synthetic ground truth's render: seconds and peak splats
        self.gt_seconds = self.gt_peak_splats = None
        self._synthetic_gt()

    # -- ranks ---------------------------------------------------------------

    def _join(self, dp: int, mp: int):
        """This process as one rank of the dp x mp layout (the process group
        train_torch.py or parallel.comm.launch started)."""
        if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
            raise ValueError(f"data_parallel={dp} x model_parallel={mp} runs as {dp * mp} "
                             "ranks: start it through train_torch.py or parallel.comm.launch")
        self.mesh = comm.make_2d_mesh(dp, mp, device_type=self.device.type)
        if self.mesh.device != self.device:
            raise ValueError(f"rank {self.mesh.rank} runs on {self.mesh.device}, "
                             f"not {self.device}")
        self.primary = self.mesh.rank == 0

    def _say(self, *args, **kwargs):
        if self.primary:
            print(*args, **kwargs)

    def _place(self):
        """Place the full state: a data replica keeps it as rank 0 holds it,
        a model shard keeps its slots."""
        if self.mesh is None:
            return
        if self.mesh.mp > 1:
            self.state = gsharded.shard_state(self.state, self.mesh.model_rank, self.mesh.mp)
        else:
            self.state = pmesh.replicate_state(self.state, self.mesh)

    def _full_state(self):
        """The whole state (a collective over the model group when sharded)."""
        if self.mesh is None or self.mesh.mp == 1:
            return self.state
        return gsharded.gather_state(self.state, self.mesh)

    def _save_checkpoint(self, path: str, iteration: int, ply: str = None):
        """Rank 0 writes the whole state (and, with ``ply``, the scene file);
        the ranks of its model group take part in the gather."""
        if self.mesh is not None and self.mesh.data_rank != 0:
            return
        state = self._full_state()
        if self.primary:
            ckpt.save_checkpoint(path, state, iteration, self.generator)
            if ply:
                ckpt.export_ply(ply, state)

    # -- data access --------------------------------------------------------

    def _camera(self, idx: int):
        """(Camera with K on the device, pose on the device) of image idx,
        staged once: a copy from pageable host memory would wait for the
        device at every step."""
        if idx not in self._cam_dev:
            im = self.data.images[idx]
            info = self.data.cameras[im.camera_id]
            K = torch.tensor(info.K, dtype=torch.float32, device=self.device)
            pose = torch.tensor(im.camera_T_world, dtype=torch.float32,
                                device=self.device)
            self._cam_dev[idx] = (Camera(K=K, width=info.width, height=info.height), pose)
        return self._cam_dev[idx]

    def _synthetic_gt(self):
        """For synthetic runs, render each view's ground truth from the
        'secret' scene (every point, at band 0, on black, clipped to
        [0, 1])."""
        if not self.synthetic:
            return
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + 1)
        secret = create_scene(self.data, cfg, self.data.xyz.shape[0], self.device)
        params = {k: v.detach() for k, v in secret.params().items()}
        params["opacity"] = torch.full_like(params["opacity"], GT_OPACITY)
        params["scale"] = params["scale"] + torch.tensor(
            rng.uniform(*GT_SCALE_RAISE, params["scale"].shape), dtype=torch.float32,
            device=self.device)
        black = torch.zeros(3, dtype=torch.float32, device=self.device)
        self._say(f"rendering {len(self.data.images)} synthetic ground-truth images "
                  f"of {secret.capacity} gaussians…")
        peak, truncated = 0, 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(len(self.data.images)):
                cam, pose = self._camera(i)
                res = rasterize(
                    params, secret.alive, pose, cam, near_thresh=cfg.near_thresh,
                    far_thresh=cfg.far_thresh, cull_mask_padding=cfg.cull_mask_padding,
                    mh_dist=cfg.mh_dist, background_rgb=black, n_sh_band=0)
                self._gt_cache[i] = res.image.clamp(0.0, 1.0)
                peak = max(peak, res.num_splats)
                truncated += res.truncated
        _sync(self.device)
        self.gt_seconds = time.perf_counter() - t0
        self.gt_peak_splats = peak
        self._say(f"  {self.gt_seconds:.2f} s; peak {peak} splats in a view; "
                  f"{truncated} window cells truncated in all")

    def gt_image(self, idx: int) -> torch.Tensor:
        """Ground truth of image idx as float32 (H, W, 3) in [0, 1] on the
        device: the synthetic render, or the image file over
        saturated_pixel_value."""
        if self.synthetic:
            return self._gt_cache[idx]
        return self.gt_image_dev(idx).to(torch.float32) / self.config.saturated_pixel_value

    def gt_image_dev(self, idx: int) -> torch.Tensor:
        """Device-resident ground truth of image idx as uint8 (H, W, 3),
        staged once; steps and evals normalise it on the device."""
        if idx not in self._gt_dev:
            if self.synthetic:
                sat = self.config.saturated_pixel_value
                img = (self.gt_image(idx) * sat).clamp(0.0, 255.0).to(torch.uint8)
            else:
                img = torch.from_numpy(self.data.load_image(idx)).to(self.device)
            self._gt_dev[idx] = img
        return self._gt_dev[idx]

    # -- schedule helpers ----------------------------------------------------

    def background_for(self, i: int) -> torch.Tensor:
        cfg = self.config
        value = float(i % 255) / 255.0 if cfg.use_background and i < cfg.use_background_end else 0.0
        return torch.full((3,), value, dtype=torch.float32, device=self.device)

    # -- de-synced metrics ----------------------------------------------------

    def _process_info(self, i: int, info: dict):
        """Record one step's info, read on the host, into the metrics."""
        self.metrics.train_psnr.append(info["psnr"])
        self.metrics.num_gaussians.append(info["n_alive"])
        self.peak_splats = max(self.peak_splats, info["num_splats"])
        if info["truncated"]:
            self.metrics.truncated_steps += 1
            self.metrics.truncated_cells += info["truncated"]
            if not self._truncated_seen:
                self._truncated_seen = True
                self._say(f"  note: iter {i} truncated oversized gaussian windows "
                          f"(> 4096 tiles): {info['truncated']} tail cells dropped "
                          "this step (counts accumulate in metrics.json)")
        self._last_info = (i, info)

    def _drain(self, upto: int = 0):
        """Read the pending infos until ``upto`` are left, each with one
        copy to the host."""
        keys = ("psnr", "n_alive", "num_splats", "truncated")
        while len(self._pending) > upto:
            i, info = self._pending.pop(0)
            # the parallel steps' counts are device tensors, train_step's ints
            dev = [k for k in keys if torch.is_tensor(info[k])]
            read = dict(zip(dev, torch.stack([info[k].double() for k in dev]).tolist()))
            psnr, n_alive, num_splats, truncated = (read.get(k, info[k]) for k in keys)
            self._process_info(i, dict(psnr=psnr, n_alive=int(n_alive),
                                       num_splats=int(num_splats), truncated=int(truncated)))

    # -- evaluation ------------------------------------------------------------

    @property
    def evaluates(self) -> bool:
        """This rank renders the evals and debug images: every rank of the
        first data replica (a data replica is the whole state; a model
        group renders a view in bands)."""
        return self.mesh is None or self.mesh.data_rank == 0

    def _eval_view(self, idx: int, band: int):
        cam, pose = self._camera(idx)
        kw = dict(config=self.config, camera_hw=(cam.height, cam.width), n_sh_band=band)
        if self.mesh is not None and self.mesh.mp > 1:
            return gsharded.mp_eval_step(self.state, self.gt_image_dev(idx), cam.K, pose,
                                         mesh=self.mesh, **kw)
        return T.eval_step(self.state, self.gt_image_dev(idx), cam.K, pose, **kw)

    def evaluate(self, save_images=False, iteration=0):
        """Mean PSNR and SSIM over the test split at ``iteration``'s SH band."""
        band = T.sh_band_for_iteration(self.config, iteration)
        psnrs, ssims = [], []
        for idx in self.test_split:
            img, psnr, ssim = self._eval_view(int(idx), band)
            psnrs.append(float(psnr))
            ssims.append(float(ssim))
            if save_images:
                self._save_image(img, f"iter{iteration}_test_image_{idx}.png")
        return float(np.mean(psnrs)), float(np.mean(ssims))

    def _record_eval(self, iteration: int, save_images=False):
        """Evaluate on the ranks that evaluate and record the result."""
        if not self.evaluates:
            return
        psnr, ssim = self.evaluate(save_images=save_images, iteration=iteration)
        self.metrics.test_psnr.append(psnr)
        self.metrics.test_ssim.append(ssim)
        self.metrics.eval_iters.append(iteration)
        return psnr, ssim

    def _save_image(self, img: torch.Tensor, name: str):
        if not self.primary:
            return
        sat = self.config.saturated_pixel_value
        arr = (img.clamp(0, 1) * sat).to(torch.uint8).cpu().numpy()
        write_png(os.path.join(self.config.output_dir, name), arr)

    def _save_debug_image(self, i: int):
        """Render and save the first train view."""
        if not self.evaluates:
            return
        img, _, _ = self._eval_view(int(self.train_split[0]),
                                    T.sh_band_for_iteration(self.config, i))
        self._save_image(img, f"debug_iter{i}.png")

    def _write_metrics(self):
        if not self.primary:
            return
        with open(os.path.join(self.config.output_dir, "metrics.json"), "w") as f:
            json.dump(self.metrics.to_dict(), f)

    # -- main loop -----------------------------------------------------------

    def train(self):
        cfg = self.config
        i = self.start_iter
        profiler = None
        while i < cfg.num_iters:
            # optional trace window of torch.profiler into output_dir/trace
            window = cfg.profile_start <= i < cfg.profile_start + cfg.profile_steps
            if profiler is None and cfg.profile_steps > 0 and window and self.primary:
                self._drain()
                profiler = self._start_profiler()
            elif profiler is not None and not window:
                self._drain()
                self._stop_profiler(profiler)
                profiler = None
            events = scheduled_events(cfg, i)
            if events.eval:
                self._drain()
                scores = self._record_eval(i)
                if scores:
                    self._say(f"\tTEST SPLIT PSNR: {scores[0]:.3f}, SSIM: {scores[1]:.4f}")

            band = T.sh_band_for_iteration(cfg, i)
            if self.mesh is None:
                idx = int(self.rng.choice(self.train_split))
                cam, pose = self._camera(idx)
                self.state, info = T.train_step(
                    self.state, self.gt_image_dev(idx), cam.K, pose, self.background_for(i),
                    config=cfg, camera_hw=(cam.height, cam.width), n_sh_band=band)
            else:
                info = self._parallel_step(i, band)
            # keep DRAIN_LAG steps in flight; read only older infos
            self._pending.append((i, info))
            self._drain(upto=DRAIN_LAG)

            if i % cfg.print_interval == 0 and self.metrics.train_psnr:
                li, linfo = self._last_info
                self._say(f"Iter: {li}, PSNR: {linfo['psnr']:.3f}, N: {linfo['n_alive']}, "
                          f"splats: {linfo['num_splats']}")

            if events.adc:
                self._drain()
                self._densify(i)

            if events.reset:
                self._say("\t\tResetting opacity")
                self.state = T.reset_opacity(self.state, config=cfg)

            if events.debug_image:
                self._save_debug_image(i)

            if events.checkpoint:
                self._save_checkpoint(os.path.join(cfg.output_dir, f"ckpt_iter_{i}.npz"), i)
                # the run's record rides along with every periodic checkpoint
                self._write_metrics()
            i += 1

        self._drain()
        if profiler is not None:  # the window ran past the end of training
            self._stop_profiler(profiler)
        scores = self._record_eval(cfg.num_iters, save_images=True)
        if scores:
            self._say(f"Final PSNR: {scores[0]:.3f}, SSIM: {scores[1]:.4f}")
        memory = (f"; peak device memory {torch.cuda.max_memory_allocated(self.device)} "
                  "bytes" if self.device.type == "cuda" else "")
        self._say(f"peak {self.peak_splats} splats in a train step; window truncation: "
                  f"{self.metrics.truncated_steps} steps dropped "
                  f"{self.metrics.truncated_cells} cells{memory}")
        self._save_checkpoint(os.path.join(cfg.output_dir, "ckpt_final.npz"), cfg.num_iters,
                              ply=os.path.join(cfg.output_dir, "scene_final.ply"))
        self._write_metrics()
        if self.primary:
            print(terminal_plot(self.metrics))

    def _parallel_step(self, i: int, band: int):
        """One step of every rank: with dp > 1 the JAX runner's draw of dp
        train views (the same on every rank), of which each data replica
        takes its own; with one data replica, one view.  The background is
        shared.  Returns the step's info."""
        cfg, mesh = self.config, self.mesh
        if mesh.dp > 1:
            idxs = self.rng.choice(self.train_split, size=mesh.dp,
                                   replace=len(self.train_split) < mesh.dp)
            idx = int(idxs[mesh.data_rank])
        else:
            idx = int(self.rng.choice(self.train_split))
        cam, pose = self._camera(idx)
        step = pmesh.dp_train_step if mesh.mp == 1 else gsharded.dp_mp_train_step
        self.state, info = step(
            self.state, self.gt_image_dev(idx), cam.K, pose, self.background_for(i),
            config=cfg, camera_hw=(cam.height, cam.width), n_sh_band=band, mesh=mesh)
        return info

    def _densify(self, i: int):
        """Adaptive density control at iteration i, its stats read once.  A
        sharded state is gathered, every rank runs the event on the whole
        state with the same generator, and each keeps its shard."""
        state, stats = T.adaptive_density_control(
            self._full_state(), self.generator, i, config=self.config)
        self.state = state
        if self.mesh is not None and self.mesh.mp > 1:
            self.state = gsharded.shard_state(state, self.mesh.model_rank, self.mesh.mp)
        names = ("n_deleted", "n_clone", "n_split", "n_alive", "cap_hit",
                 "clone_deferred", "split_deferred")
        s = dict(zip(names, (int(x) for x in torch.stack(
            [stats[k].to(torch.int64) for k in names]).tolist())))
        self._say("  ADC: deleted {} cloned {} split {} alive {}".format(
            s["n_deleted"], s["n_clone"], s["n_split"], s["n_alive"])
            + (f"  CAP-HIT (free slots exhausted: {s['clone_deferred']} clones "
               f"dropped, {s['split_deferred']} split second-samples lost — raise "
               "gaussian_capacity)" if s["cap_hit"] else ""))
        self.metrics.adc_events.append(dict(
            iter=i, deleted=s["n_deleted"], cloned=s["n_clone"], split=s["n_split"],
            alive=s["n_alive"], cap_hit=bool(s["cap_hit"])))
        if s["n_alive"] == 0:
            # a scene with no gaussian cannot recover: clone and split need
            # live sources
            raise RuntimeError(f"ADC at iter {i} deleted every gaussian — aborting the run")

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler):
        _sync(self.device)
        profiler.stop()
        cfg = self.config
        trace_dir = os.path.join(cfg.output_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        profiler.export_chrome_trace(path)
        self._say(f"  trace written to {path} (iters {cfg.profile_start}.."
                  f"{cfg.profile_start + cfg.profile_steps})")
