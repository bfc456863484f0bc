#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port: serving and training, on one card.

Builds the port's CUDA kernels from gaussian_splatting_torch/csrc, holds each
kernel against its plain PyTorch version on the card, checks the reference
golden pixels, then drives the paths below on the trained scene
runs/refscale7k/scene_final.ply at 1296x840 and shows, by the launch
counters, that each went through its kernels:

- install ("[install]", right after the build): a copy of only what an
  install ships (the package's .py files and pyproject.toml's package-data
  files) builds both kernel libraries and both dataio libraries in a
  process of its own, renders the fixture through B1, reads a COLMAP model
  and decodes the JPEG fixtures, each result bitwise against this
  checkout's;
- serving: 4 orbit views (plus depth) through render_torch.render_views
  (kernels B1, B5);
- serving, per-pixel SH: the 4 orbit views through
  rasterize(..., n_sh_band=3, use_sh_precompute=False) (kernel B3);
- training: 20 trainer.train_step calls on a seeded perturbation of the
  scene, cycling through the 4 views (kernels B1, B2), checked for finite
  parameters, the densification counts and a falling loss on every view;
- training, per-pixel SH: 8 steps of the same with
  SplatConfig(use_sh_precompute=False) (kernels B3, B4);
- training, ADC and opacity reset: the scene at the JAX runner's capacity
  for it (524,288 slots), 8 DC steps, trainer.adaptive_density_control at
  iteration 1000, checked for its slot accounting, zero moments and
  accumulators and the split's law, 4 steps, trainer.reset_opacity, 4
  steps (kernels B1, B2);
- the geometry kernel pair ("[geometry]"): csrc/geometry.cu's forward and
  backward against their plain version (ops.geometry.splat_rows_plain) at
  2^21 slots of 1.5M seeded gaussians at band 3 on both colour paths and
  at the 8.0M rows of a Scaffold-GS decode of 800,000 anchors, each timed
  alone against its byte bound, then the launches of one training step
  and one served view (every view and depth map through rasterize
  launches the forward once, every step the backward once: with_geometry);
- the layout kernels ("[layout]"): csrc/layout.cu against their plain
  version (culling._layout_plain) on garden view 0, with and without the
  opacity-aware window, and on the 8.0M rows of a Scaffold-GS decode of
  800,000 anchors, bit for bit, each timed beside the plain layout and
  its byte bound (the sort's passes counted: layout_bytes);
- training, Scaffold-GS ("[scaffold]"): tests/test_torch_scaffold.py's
  small scene decoded, rendered and trained 3 steps through
  trainer.train_step on the card, each against the plain reference
  tests/torch_scaffold_reference.py (the decoded rows, the image, every
  leaf's gradient, the leaves after each step); then anchors at the
  trained scene's 63,879 positions at 1296x840, decoded against the
  reference's decode and trained 8 steps on 2 views (kernels B1, B2 and
  the Adam step once each a step), checked for finite leaves and a falling
  loss on each view, with the decode's device ms and the step's time;
- the TPU probes E1-E3 (gaussian_splatting_torch/experiments): each
  probe's full sweep, every point's kernel against its plain version,
  with kernel, plain and library-call times and the bound; then
  "[kernel-bench]": B1 and B2 alone at the JAX bench point (the twin of
  experiments/kernel_bench.py, 1,970,487 splats at 1296x840), each held to
  its plain version, timed and bounded, and one point of the twin of
  experiments/sort_bench.py (2^22 elements, 1 and 12 operands, and the
  layout's int64 key);
- the reference-scale run ("[refscale]"): gaussian_splatting_torch/
  experiments/refscale_run.py, the JAX package's run of runs/refscale7k
  through train_torch.main at full width and depth: 1,200,000 secret
  points, 96 ring views at 1296x840, 200,000 init points in 2,097,152
  slots, DC colour path, the full 7k schedule (57 ADC events, opacity
  resets at 3001 and 6002, SH bands at 1000, 2000, 3000, 15 evals, debug
  images, a checkpoint at 3500; kernel B1 for the ground truth, steps and
  evals, B2 for steps), then its bench sample; checked for the launches the
  schedule implies, ADC and evals at the record's iterations
  (runs/refscale7k/metrics.json) with each event's accounting, the resets,
  finite parameters, the test PSNR against floors under the JAX run's, the
  run's files and the bench sample's layout against the committed
  bench_scene_sample.npz, each event's deletes by reason adding up to its
  count (delete_census: also the window's skipped steps and the deletes
  of the window cut to its last 1, 5, 25 steps); then a second call that
  resumes from the checkpoint at 3500 across the ADC at 3600;
- a COLMAP capture ("[capture]"): the port's image decoders built with
  g++ and the committed JPEG fixtures held to OpenCV's decodes, then a
  capture of garden's shape (185 views at 1297x840 in images_4/ as PNG,
  138,766 SfM points) rendered from the reference-scale scene's 1,200,000
  secret points, trained through train_torch.main --dataset_path on the
  per-pixel SH path for 400 iterations with a compressed schedule
  (kernels B1, B2 at band 0, B3, B4 at n_sh 4, 9 and 16), with OpenCV and
  Pillow hidden so the port's PNG decoder reads every image, then its 24
  test views rendered with depth through render_torch.main --dataset_path
  (kernels B1, B5) and read back; checked for the launches the schedule
  implies, finite parameters, a scene that grows at each ADC, a rising
  test PSNR and the run's files;
- multi-GPU (gaussian_splatting_torch/parallel; the card is one, so ranks
  share it over gloo and NCCL runs at world size 1): (a) one NCCL rank's
  mp_train_step and dp_train_step against trainer.train_step on garden
  view 0; (b) two ranks' mp_render against rasterize on both colour paths
  (B1, B3 on band grids), mp_train_step against train_step on both (B2,
  B4) and dp_train_step against the mean of two views' gradients; (c)
  dryrun_multigpu(4); (d) train_torch.main --model_parallel 2 on the
  reference-scale scene, 150 iterations with ADC at 50 and 100 and a
  checkpoint at 100 read back and held to each rank's shard; (e) the same
  with --data_parallel 2 for 60 iterations, the replicas' checksums equal
  after the ADC and at the end.  It prints ms per step, collective ms,
  device busy and peak memory per rank, and adds every rank's launches to
  the kernels line.

B1, B3 and B5 each launch a pack of the feature rows into gaussian-major
records first (gs_pack_fwd_rows), held bitwise against its plain version,
and an order of the tiles by splat count (gs_tile_order), held against its
plain version up to the order of ties.
It times the kernels against their plain versions, works out each kernel's
bound (the least time the card could take for the same work), prints the
spread of the work over view 0's tiles, and profiles one step of each
training path.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits nonzero on any failure.  The last line
of standard output is {"ok": true, "device": {...}}; the line before it is
the per-kernel JSON summary.
"""

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "runs", "refscale7k", "scene_final.ply")
WIDTH, HEIGHT, FOCAL = 1296, 840, 1100.0
N_VIEWS = 4
SH_BAND = 3
ALPHA_THRESHOLD = 0.5  # render_torch.py's default depth threshold
DEVICE = "cuda:0"

# kernel vs plain tolerances: float32 accumulation order and expf rounding
IMG_TOL = 1e-4
T_TOL = 1e-4  # compared only where T >= T_EPS (below it the kernel stops)
DEPTH_TOL = 1e-3
HIT_AGREE = 0.9999  # share of pixels where both find (or both miss) a surface
GOLDEN_TOL = 1e-5
DEPTH_GOLDEN_TOL = 1e-4
# B2 and B4 against their plain versions, per gradient row relative to that
# row's largest magnitude: both sum per-pixel terms in another order (the
# kernel per splat over a warp's pixels, then over the eight warps and then
# by atomics, the plain walk by parallel scans, batched products and
# index_add_), and D = E - prefix cancels in near-saturated pixels, where
# 1 / (1 - alpha) reaches 1e4.  The two-phase B2 and B4 measured on an H100
# at 3.8e-6 and 1.8e-6 on the garden view: the bound leaves ~25x of that
BWD_REL_TOL = 1e-4
# zero higher-band coefficients through B3 against the DC path through B1
SH_DC_TOL = 1e-6

# training phases
TRAIN_STEPS = 20
SH_TRAIN_STEPS = 8  # per-pixel SH: two passes over the 4 views
TRAIN_SEED = 0
RGB_NOISE = 0.3  # std of the seeded offset on the SH DC coefficients
OPACITY_NOISE = 0.5  # std of the seeded offset on pre-sigmoid opacity
STEP_TIMING_STEPS = 5  # extra steps timed after the checked run
# the fused Adam kernel at the benchmark's training shapes: 2**21 slots of
# the six leaves (59 floats a slot), three checked steps
ADAM_SLOTS = 1 << 21
ADAM_WIDTHS = dict(xyz=(3,), rgb=(3,), opacity=(1,), scale=(3,), quaternion=(4,),
                   sh=(3, 15))
ADAM_STEPS = 3
ADAM_BYTES_PER_FLOAT = 28  # p, g, mu, nu read; p, mu, nu written
ADAM_OPS_PER_FLOAT = 15  # m 3, v 4, the ratio 5 (3 divides, a root, eps), p 3
# the schedule's events: the garden scene at the capacity that the JAX
# runner's derive_capacity (gaussian_splatting_tpu/runner.py:58-62) gives
# its 63,879 points, 2**ceil(log2(8 n)); DC steps before the event and
# around the reset; the event's iteration, where the adaptive fraction is
# (6500 - 1000) / 5750 * 2 = 1.913
# the geometry kernel pair at the cells' shapes: the garden7k cells' slots
# and alive gaussians, garden-scaffold's anchors (8.0M decoded rows)
GEOMETRY_SLOTS = 1 << 21
GEOMETRY_ALIVE = 1_500_000
GEOMETRY_ANCHORS = 800_000
GEOMETRY_SEED = 23
# the forward's rows 0-5 and depth are the plain chain's float32 operations in
# its order; the SH colour sums 16 products in another order than PyTorch's
# reduction; the backward regroups autograd's sums (covariance, quaternion):
# each row or leaf relative to its largest entry, and each gradient entry
# relative to its own size with a floor at GEOMETRY_BWD_FLOOR of its leaf's
# largest (the tests' BWD_RTOL, BWD_ELEM_RTOL and BWD_FLOOR; at these shapes
# the worst leaf is 6.5e-7 and the worst entry 1.8e-4, an sh coefficient's)
GEOMETRY_FWD_TOL = 1e-5
GEOMETRY_BWD_TOL = 1e-5
GEOMETRY_BWD_ELEM_TOL = 1e-3
GEOMETRY_BWD_FLOOR = 1e-3
# float32 operations a gaussian at band 3, counted from csrc/geometry.cu (the
# bound is bytes either way)
GEOMETRY_FWD_OPS = 300
GEOMETRY_BWD_OPS = 700

# the layout kernels (csrc/layout.cu): bytes a gaussian and a splat move,
# counted from the kernels.  A gaussian's rows (u, v, a, b, c, z: 4 bytes
# each, visible 1, opacity 4) are read by the count and by the fill kernel;
# its count is written, read by the scan and by the fill; its first slot
# written and read.  A splat's key and id (12 bytes) are written once; the
# radix sort reads its keys once for the histograms and then reads and
# writes key and id once a pass of LAYOUT_RADIX_BITS; the tile starts read
# the sorted keys once.
LAYOUT_RADIX_BITS = 8  # cub's onesweep digits
LAYOUT_SEED = 29

ADC_CAPACITY = 524_288
ADC_STEPS_BEFORE = 8  # two passes over the 4 views
ADC_STEPS_AFTER = 4
ADC_ITERATION = 1000
# a split sample's r in [0, 1)^3: 1e-4, plus the float32 rounding of the
# sample's position, up to 4 ulps of its largest coordinate over the scale
BOX_TOL = 1e-4
BOX_ULPS = 4

# the capture's schedule: the 7,000 iterations of runs/refscale7k/config.yaml
# cut to CLI_ITERS with the schedule compressed into them: ADC at 100, 200,
# 300, an opacity reset at 250, SH bands at 100, 200, 300, evals at 0, 200
# and the end, a debug image and a checkpoint at 200, a torch.profiler trace
# of 2 steps
REFSCALE_CONFIG = os.path.join(ROOT, "runs", "refscale7k", "config.yaml")
CLI_ITERS = 400
CLI_CHECKPOINT = 200
CLI_SCHEDULE = dict(
    num_iters=CLI_ITERS, test_eval_interval=200, print_interval=50,
    adaptive_control_start=50, adaptive_control_interval=100, adaptive_control_end=350,
    reset_opacity_start=200, reset_opacity_interval=250, reset_opacity_end=300,
    add_sh_band_interval=100, save_debug_image_interval=CLI_CHECKPOINT,
    checkpoint_interval=CLI_CHECKPOINT, profile_start=20, profile_steps=2,
)
CLI_ADC_ITERS = [100, 200, 300]

# the reference-scale run ("[refscale]"): gaussian_splatting_torch/
# experiments/refscale_run.py, the full 7k schedule of the JAX package's run
# in runs/refscale7k through train_torch.main, with a torch.profiler trace of
# 2 steps, held to that run's record (metrics.json); then a resume from its
# checkpoint at 3500 across the ADC at 3600, and its bench sample against the
# committed one.  The test PSNR floors are the JAX run's max 25.76 less 1 dB
# and its 25.25 at 7000 less 2 dB
REFSCALE_RECORD = os.path.join(ROOT, "runs", "refscale7k", "metrics.json")
REFSCALE_TRACE = dict(profile_start=20, profile_steps=2)
REFSCALE_CHECKPOINT = 3500
REFSCALE_RESUME_ITERS = 3610
REFSCALE_RESETS = [3001, 6002]
REFSCALE_LATE_STEPS = 500  # after the last ADC event (6400): the final scene
REFSCALE_MIN_MAX_PSNR = 24.76
REFSCALE_MIN_FINAL_PSNR = 23.25
# each ADC event's deletes by reason, and those of a window that had counted
# only its last k steps (delete_census), for these k
REFSCALE_SHORT_WINDOWS = (1, 5, 25)
BENCH_SAMPLE = os.path.join(ROOT, "bench_scene_sample.npz")

# the reference's 6-gaussian fixture (tests/fixtures.py), 640x480
FX_XYZ = [[1.0, 2.0, -4.0], [4.0, 5.0, 6.0], [7.0, 8.0, -9.0],
          [1.0, 2.0, 15.0], [2.5, -1.0, 4.0], [-1.0, -2.0, 10.0]]
FX_SCALE = [[0.02, 0.03, 0.04], [0.01, 0.05, 0.02], [0.09, 0.03, 0.01],
            [1.0, 3.0, 0.1], [2.0, 0.2, 0.1], [2.0, 1.0, 0.1]]
FX_QUAT = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
           [1.0, 0.0, 0.0, 0.0], [0.714, -0.002, -0.664, 0.221],
           [1.0, 0.0, 0.0, 0.0]]
FX_K = [[430.0, 0.0, 320.0], [0.0, 410.0, 240.0], [0.0, 0.0, 1.0]]
FX_POSE = [[0.9999, 0.0089, 0.0073, -0.3283],
           [-0.0106, 0.9568, 0.2905, -1.9260],
           [-0.0044, -0.2906, 0.9568, 2.9581],
           [0.0, 0.0, 0.0, 1.0]]
FX_RENDER = dict(near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0,
                 mh_dist=3.0)
FX_ALPHA = 0.2
# (pixel (y, x), channel, value) from the reference CUDA implementation
IMAGE_GOLDENS = [((340, 348), 0, 0.47698545), ((200, 348), 2, 0.26756114)]
DEPTH_GOLDENS = [((340, 348), 17.29551887512207), ((200, 348), 13.205718040466309)]
# per-pixel SH, every sh coefficient 0.1 at band 3 (tests/test_render.py,
# pinned by a float64 per-pixel compositing oracle)
SH_GOLDENS = [((340, 348), [0.63091441, 0.15392897, 0.15392897]),
              ((200, 348), [0.14358045, 0.11027012, 0.37783123])]
SH_FX_SEED = 3  # seeded coefficients of tests/test_render_sh_grads.py
BAND_OF_N_SH = {4: 1, 9: 2, 16: 3}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def with_geometry(want):
    """``want`` with the launches of the geometry kernel pair and the layout
    kernels that its renders imply: the geometry forward and the layout's
    count and fill kernels once a view or depth map (each B1, B3 or B5
    launch through ``rasterize``), the geometry backward once a step (each
    B2 or B4 launch).  Keys are kernel names, or (name, n_sh) pairs."""
    def kernel(key):
        return key[0] if isinstance(key, tuple) else key

    out = {k: v for k, v in want.items() if v}
    views = sum(v for k, v in want.items()
                if kernel(k) in ("render_fwd", "render_sh_fwd", "depth_fwd"))
    steps = sum(v for k, v in want.items() if kernel(k) in ("render_bwd", "render_sh_bwd"))
    if views:
        out["geometry_fwd"] = out["layout_count"] = out["layout_fill"] = views
    if steps:
        out["geometry_bwd"] = steps
    return out


def fixture_scene(device):
    from gaussian_splatting_torch.structs import Camera, GaussianScene

    rgb = np.full((6, 3), 0.5, np.float32)
    rgb[3], rgb[4], rgb[5] = [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]
    rgb /= 0.28209479177387814
    p = np.clip(np.ones((6, 1), np.float32), 1e-4, 1 - 1e-4)
    scene = GaussianScene.create(
        np.array(FX_XYZ, np.float32), rgb, np.log(p / (1 - p)),
        np.log(np.array(FX_SCALE, np.float32)), np.array(FX_QUAT, np.float32),
        device=device,
    )
    import torch

    cam = Camera(torch.tensor(FX_K, device=device), 640, 480)
    return scene, cam, torch.tensor(FX_POSE, device=device)


def with_sh(params, sh):
    """params with the sh leaf replaced by a numpy (N, 3, 15) array."""
    import torch

    dev = params["xyz"].device
    return {**params, "sh": torch.from_numpy(np.asarray(sh, np.float32)).to(dev)}


def fixture_sh_params(fx, n_sh):
    """The fixture with the seeded coefficients of the JAX SH-gradient
    tests: the DC coefficient stays the fixture's colour, bands 1.. are
    normal * 0.4 (drawn for all n_sh, as there)."""
    params = {k: v.detach() for k, v in fx.params().items()}
    rng = np.random.default_rng(SH_FX_SEED)
    coeffs = rng.normal(size=(fx.capacity, 3, n_sh)) * 0.4
    sh = np.zeros((fx.capacity, 3, 15), np.float32)
    sh[:, :, : n_sh - 1] = coeffs[:, :, 1:]
    return with_sh(params, sh)


def scene_view(device):
    """The trained scene and the first orbit view of render_torch."""
    import torch

    import render_torch
    from gaussian_splatting_torch.structs import Camera

    scene = render_torch.load_scene(SCENE, device)
    xyz = scene.xyz[scene.alive].detach().cpu().numpy()
    pose = render_torch.orbit_poses(xyz, N_VIEWS)[0]
    K = torch.tensor([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    return scene, Camera(K, WIDTH, HEIGHT), torch.from_numpy(pose).to(device)


def kernel_inputs(scene, cam, pose, render_kw, sh_band, alpha_kw):
    """B1/B2's inputs (feat, layout) and B5's as ``rasterize.render_depth``
    forms them (rows 0-5 of the band-0 features without a far cull, then
    the camera distance), and the grid."""
    import torch

    from gaussian_splatting_torch import geometry as geo
    from gaussian_splatting_torch.ops.depth import FEAT_DEPTH
    from gaussian_splatting_torch.rasterize import kernel_inputs as raster_inputs

    params = {k: v.detach() for k, v in scene.params().items()}
    k = raster_inputs(params, scene.alive, pose, cam, n_sh_band=sh_band, **render_kw)
    d = raster_inputs(params, scene.alive, pose, cam, far_thresh=float("inf"), **alpha_kw)
    xyzT = params["xyz"].T
    dist = geo.camera_distance_rows(*geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], pose))
    dfeat = torch.cat([d.feat[:FEAT_DEPTH], dist[None]])
    return (k.feat.contiguous(), k.layout), (dfeat, d.layout), k.grid


def sh_kernel_inputs(params, alive, pose, cam, render_kw, sh_band):
    """B3/B4's inputs at the per-pixel path's shapes: (feat, basis, layout,
    x_tiles)."""
    from gaussian_splatting_torch.rasterize import kernel_inputs as raster_inputs

    k = raster_inputs(params, alive, pose, cam, n_sh_band=sh_band,
                      use_sh_precompute=False, **render_kw)
    return k.feat.contiguous(), k.basis, k.layout, k.grid.x_tiles


def compare(label, dc, dep, grid, alpha_threshold):
    """Kernel vs plain version on the same inputs, on the card."""
    import torch

    from gaussian_splatting_torch.ops import common as cc
    from gaussian_splatting_torch.ops.depth import depth_fwd_cuda, depth_fwd_plain
    from gaussian_splatting_torch.ops.render import render_fwd_cuda, render_fwd_plain

    feat, lay = dc
    check_pack(f"{label} B1", feat)
    check_tile_order(f"{label} B1", lay)
    k = render_fwd_cuda(feat, lay.gaussian_idx, lay.tile_starts, grid.x_tiles)
    torch.cuda.synchronize()
    p = render_fwd_plain(feat, lay.gaussian_idx, lay.tile_starts, grid.x_tiles)
    torch.cuda.synchronize()
    img_err, t_err = raw_errors(k, p, cc.T_EPS)
    print(f"  {label} B1: max|image| {img_err:.3e} (tol {IMG_TOL}), "
          f"max|T| where T>=1e-4 {t_err:.3e} (tol {T_TOL}), "
          f"{lay.num_splats} splats")
    if not (img_err <= IMG_TOL and t_err <= T_TOL):
        raise AssertionError(f"{label}: B1 disagrees with its plain version")

    dfeat, dlay = dep
    check_pack(f"{label} B5", dfeat)
    check_tile_order(f"{label} B5", dlay)
    kd = depth_fwd_cuda(dfeat, dlay.gaussian_idx, dlay.tile_starts,
                        grid.x_tiles, alpha_threshold)
    torch.cuda.synchronize()
    # The chunked plain walk multiplies T in cumprod's order, a parallel scan
    # on the card; where 1 - T lands within rounding of the threshold the
    # crossing can move to the neighbouring splat.  Count those pixels, then
    # hold the kernel to the plain walk with chunk=1, which multiplies T in
    # the kernel's own order.
    pc = depth_fwd_plain(dfeat, dlay.gaussian_idx, dlay.tile_starts,
                         grid.x_tiles, alpha_threshold)
    moved = int(((kd >= 0) != (pc >= 0)).sum()
                + ((kd >= 0) & (pc >= 0) & ((kd - pc).abs() > DEPTH_TOL)).sum())
    pd = depth_fwd_plain(dfeat, dlay.gaussian_idx, dlay.tile_starts,
                         grid.x_tiles, alpha_threshold, chunk=1)
    torch.cuda.synchronize()
    hk, hp = kd >= 0, pd >= 0
    agree = float((hk == hp).float().mean())
    both = hk & hp
    d_err = float((kd - pd).abs()[both].max()) if bool(both.any()) else 0.0
    print(f"  {label} B5: hit/miss agree on {agree:.6f} of pixels "
          f"(need >= {HIT_AGREE}), max|depth| where both hit {d_err:.3e} "
          f"(tol {DEPTH_TOL}), {int(both.sum())} hits; against the chunked "
          f"walk the crossing moved on {moved} of {kd.numel()} pixels")
    if not (agree >= HIT_AGREE and d_err <= DEPTH_TOL):
        raise AssertionError(f"{label}: B5 disagrees with its plain version")
    return img_err, d_err


def check_pack(label, feat):
    """The pack kernel that B1, B3 and B5 launch first, bitwise against its
    plain version (the float32 bits of every record)."""
    import torch

    from gaussian_splatting_torch.ops.render import pack_fwd_rows_cuda, pack_fwd_rows_plain

    k = pack_fwd_rows_cuda(feat)
    torch.cuda.synchronize()
    p = pack_fwd_rows_plain(feat)
    same = tuple(k.shape) == tuple(p.shape) and torch.equal(
        k.view(torch.int32), p.view(torch.int32))
    print(f"  {label} pack: {tuple(k.shape)} records, bitwise equal to "
          f"pack_fwd_rows_plain: {same}")
    if not same:
        raise AssertionError(f"{label}: the pack kernel differs from its plain version")


def check_tile_order(label, lay):
    """The tile-order kernel that B1, B3 and B5 launch second, against its plain
    version: a permutation of the tiles whose (clamped) splat counts run as
    the plain order's do.  Ties may come in another order."""
    import torch

    from gaussian_splatting_torch.ops.render import (
        ORDER_BUCKETS,
        tile_order_cuda,
        tile_order_plain,
    )

    starts = lay.tile_starts
    k = tile_order_cuda(starts).long()
    torch.cuda.synchronize()
    p = tile_order_plain(starts).long()
    counts = (starts[1:] - starts[:-1]).clamp_max(ORDER_BUCKETS - 1)
    perm = torch.equal(torch.sort(k).values, torch.arange(k.numel(), device=k.device))
    same = perm and torch.equal(counts[k], counts[p])
    print(f"  {label} tile order: a permutation of the {k.numel()} tiles: {perm}; "
          f"splat counts along it equal to tile_order_plain's: {same}; heaviest "
          f"{int(counts[k[0]])} splats, lightest {int(counts[k[-1]])}")
    if not same:
        raise AssertionError(f"{label}: the tile order differs from its plain version")


def raw_errors(k, p, t_eps):
    """max |image| error, and max |T| error where the plain T >= T_EPS."""
    img_err = float((k[0:3] - p[0:3]).abs().max())
    t_mask = p[3] >= t_eps
    t_err = float((k[3] - p[3]).abs()[t_mask].max()) if bool(t_mask.any()) else 0.0
    return img_err, t_err


def compare_sh(label, sh_in):
    """Kernel B3 against render_sh_fwd_plain on the card."""
    import torch

    from gaussian_splatting_torch.ops import common as cc
    from gaussian_splatting_torch.ops.render_sh import (
        render_sh_fwd_cuda,
        render_sh_fwd_plain,
    )

    feat, basis, lay, x_tiles = sh_in
    check_pack(f"{label} B3 (n_sh {basis.shape[0]})", feat)
    args = (feat, basis, lay.gaussian_idx, lay.tile_starts, x_tiles)
    k = render_sh_fwd_cuda(*args)
    torch.cuda.synchronize()
    p = render_sh_fwd_plain(*args)
    torch.cuda.synchronize()
    img_err, t_err = raw_errors(k, p, cc.T_EPS)
    print(f"  {label} B3 (n_sh {basis.shape[0]}): max|image| {img_err:.3e} "
          f"(tol {IMG_TOL}), max|T| where T>=1e-4 {t_err:.3e} (tol {T_TOL}), "
          f"{lay.num_splats} splats, image max {float(p[0:3].max()):.4f}")
    if not (img_err <= IMG_TOL and t_err <= T_TOL) or not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{label}: B3 disagrees with its plain version")
    return img_err


def host_ms(fn, reps):
    """Median host time of fn (ending in a synchronize) after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_kernel(label, kern, plain, args, smi):
    """Kernel and plain version on ``gaussian_splatting_torch.timing``'s
    clock, in the order plain, kernel, kernel, plain; returns (kernel ms,
    plain ms), each the mean of two."""
    from gaussian_splatting_torch import timing

    ms, plain_ms, _ = timing.compare(timing.Timer(DEVICE), lambda: kern(*args),
                                     lambda: plain(*args))
    print(f"[time] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
          f"(CUDA events, cold L2; {smi})")
    return ms, plain_ms


def adam_phase(smi):
    """The "[adam]" phase: the fused Adam kernel against its plain version
    at the training cells' shapes (ADAM_SLOTS slots, ADAM_WIDTHS), the
    gradients laid out as autograd returns them (rgb and sh slices of one
    (C, 3, 16) tensor, scale and quaternion transposes): bit for bit over
    ADAM_STEPS steps, then the wrapper's and the plain chain's ms (bias
    corrections included in both) beside the bound.  Returns the kernels
    line's entry."""
    import torch

    from gaussian_splatting_torch import optim, telemetry, timing
    from gaussian_splatting_torch.config import SplatConfig

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(TRAIN_SEED)

    def leaves():  # magnitudes over 8 decades
        out = {}
        for k, w in ADAM_WIDTHS.items():
            x = torch.randn((ADAM_SLOTS, *w), generator=gen, device=dev)
            out[k] = x * 10.0 ** torch.randint(-8, 1, x.shape, generator=gen, device=dev)
        return out

    def grads():
        g = leaves()
        dc = torch.cat([g["rgb"][:, :, None], g["sh"]], dim=2)
        return dict(g, rgb=dc[:, :, 0], sh=dc[:, :, 1:], scale=g["scale"].T.contiguous().T,
                    quaternion=g["quaternion"].T.contiguous().T)

    cfg = SplatConfig()
    params = leaves()
    state = optim.AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                            mu=leaves(), nu={k: v.abs() for k, v in leaves().items()})
    ok = torch.ones((), dtype=torch.bool, device=dev)
    telemetry.LAUNCHES.clear()
    for i in range(ADAM_STEPS):
        g = grads()
        got = optim.adam_step_cuda(params, g, state, ok, cfg)
        want = optim.adam_step_plain(params, g, state, ok, cfg)
        differ = {}
        for what, x, y in (("params", got[0], want[0]), ("mu", got[1].mu, want[1].mu),
                           ("nu", got[1].nu, want[1].nu)):
            for k in x:
                differ[f"{what}.{k}"] = int((x[k].contiguous().view(torch.int32)
                                             != y[k].contiguous().view(torch.int32)).sum())
        if any(differ.values()) or not torch.equal(got[1].count, want[1].count):
            raise AssertionError(f"[adam] step {i}: floats that differ from the plain "
                                 f"version {differ}")
        params, state = got
    launches = telemetry.LAUNCHES["adam_step"]
    n = sum(v.numel() for v in params.values())
    print(f"[adam] fused Adam vs plain: {ADAM_STEPS} steps over {ADAM_SLOTS} slots, "
          f"{n} floats, every output bit for bit; {launches} launches")
    ms, plain_ms, _ = timing.compare(
        timing.Timer(dev), lambda: optim.adam_step_cuda(params, g, state, ok, cfg),
        lambda: optim.adam_step_plain(params, g, state, ok, cfg))
    bound_ms, bound_by = timing.bound(ADAM_BYTES_PER_FLOAT * n, ADAM_OPS_PER_FLOAT * n)
    print(f"[time] adam_step: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of the bound "
          f"(CUDA events, cold L2; {smi})")
    return dict(name="adam_step (fused Adam over every leaf)", route="cuda",
                source="gaussian_splatting_torch/csrc/adam.cu",
                replaces=None,  # the JAX package leaves Adam to optax and XLA
                launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def geometry_bytes(n, rows, mode, n_sh, alive, uv):
    """(forward, backward) bytes the geometry kernels must move for ``n``
    gaussians: each input the function needs read once and each output
    written once.  The forward reads the parameters (sh where the colour
    reads it), alive and the uv offset, and writes the feature rows, the
    depth and the visible byte.  The backward reads no rgb (the colour is
    linear in it); it reads the geometry leaves, the opacity and sh where
    their gradients need them, and the gradient rows it turns into others,
    and writes those others: on the per-pixel path rgb's and sh's
    gradients, and for decoded rows opacity's and rgb's, are views of the
    rows' gradient, which are neither read nor written."""
    from gaussian_splatting_torch.ops import geometry as og

    geo = 4 * (3 + 4 + 3)  # xyz, quaternion, log-scale
    sh = 4 * 3 * (n_sh - 1) if mode != og.MODE_ROWS else 0
    fwd = geo + 4 + 12 + sh + (1 if alive else 0) + (8 if uv else 0) + 4 * rows + 4 + 1
    if mode == og.MODE_SH:  # rows 0-5 in; geometry and opacity in and out
        bwd = 2 * (geo + 4) + 4 * 6
    elif mode == og.MODE_ROWS:  # rows 0, 1, 3-5 in; geometry in and out
        bwd = 2 * geo + 4 * 5
    else:  # 9 rows and sh in; every leaf out
        bwd = (geo + 4) + sh + 4 * 9 + (geo + 4 + 12) + (4 * 45 if sh else 0)
    return n * fwd, n * bwd


def _rel_rows(got, want):
    """The largest |got - want| of each row over the row's largest |want|, the
    finite entries only, and whether the same entries are finite."""
    import torch

    got, want = got.detach(), want.detach()
    fin = torch.isfinite(want)
    same = bool((torch.isfinite(got) == fin).all())
    out = []
    for g, w, f in zip(got, want, fin):
        scale = float(w[f].abs().max()) if bool(f.any()) else 0.0
        err = float((g[f] - w[f]).abs().max()) if bool(f.any()) else 0.0
        out.append(err / scale if scale > 0 else err)
    return out, same


def _rel_entries(got, want, floor):
    """The largest |got - want| / (|want| + floor * max|want|) over the finite
    entries of ``want``."""
    import torch

    got, want = got.detach().double(), want.detach().double()
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    w, g = want[fin], got[fin]
    den = w.abs() + floor * float(w.abs().max())
    return float(((g - w).abs() / den.clamp_min(1e-300)).max())


def geometry_case(label, gaussians, alive, pose, cam, n_sh_band, use_sh_precompute, uv,
                  leaves, smi, cull):
    """One shape of the "[geometry]" phase: both kernels against the plain
    version on the card (forward rows, depth and visibility; every leaf's
    gradient of a seeded cotangent), then each kernel alone against the
    plain version's time and its byte bound.  Returns the kernels' (ms,
    plain ms, bound ms, share, worst errors)."""
    import torch

    from gaussian_splatting_torch import timing
    from gaussian_splatting_torch.ops import geometry as og

    kw = dict(**cull, n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
              uv_offset=uv)
    got = og.splat_rows(gaussians, alive, pose, cam, **kw)
    want = og.splat_rows_plain(gaussians, alive, pose, cam, **kw)
    n = got.z.shape[0]
    fwd_err, fwd_same = _rel_rows(torch.cat([got.feat, got.z[None]]),
                                  torch.cat([want.feat, want.z[None]]))
    vis_differ = int((got.visible != want.visible).sum())
    gen = torch.Generator(got.feat.device).manual_seed(GEOMETRY_SEED)
    cot = torch.randn(got.feat.shape, generator=gen, device=got.feat.device)
    names = list(leaves)
    g_got = torch.autograd.grad(got.feat, [leaves[k] for k in names], cot, allow_unused=True)
    g_want = torch.autograd.grad(want.feat, [leaves[k] for k in names], cot,
                                 allow_unused=True, retain_graph=True)
    bwd_err, elem_err, bwd_same = {}, {}, True
    for k, a, b in zip(names, g_got, g_want):
        if a is None and b is None:
            continue
        e, same = _rel_rows(a.reshape(1, -1), b.reshape(1, -1))
        bwd_err[k] = e[0]
        elem_err[k] = _rel_entries(a, b, GEOMETRY_BWD_FLOOR)
        bwd_same &= same
    worst_fwd, worst_bwd = max(fwd_err), max(bwd_err.values())
    worst_elem = max(elem_err.values())
    print(f"[geometry] {label}: {n} gaussians, {got.feat.shape[0]} feature rows; forward "
          f"worst row rel err {worst_fwd:.2e} (rows {', '.join(f'{e:.1e}' for e in fwd_err)}), "
          f"{vis_differ} visibility flags differ; backward worst leaf rel err "
          f"{worst_bwd:.2e} ({', '.join(f'{k} {e:.1e}' for k, e in bwd_err.items())}), "
          f"worst entry against its own size {worst_elem:.2e} "
          f"({', '.join(f'{k} {e:.1e}' for k, e in elem_err.items())}); "
          f"non-finite entries {'the same' if fwd_same and bwd_same else 'DIFFER'}")
    if not (worst_fwd <= GEOMETRY_FWD_TOL and worst_bwd <= GEOMETRY_BWD_TOL
            and worst_elem <= GEOMETRY_BWD_ELEM_TOL
            and vis_differ == 0 and fwd_same and bwd_same):
        raise AssertionError(f"[geometry] {label}: kernels off the plain version")

    mode, n_sh, rows = og._epilogue(gaussians, n_sh_band, use_sh_precompute)
    fwd_b, bwd_b = geometry_bytes(n, rows, mode, n_sh, alive is not None, uv is not None)
    timer = timing.Timer(got.feat.device)
    with torch.no_grad():
        f_ms, f_plain, _ = timing.compare(
            timer, lambda: og.splat_rows_fwd_cuda(gaussians, alive, pose, cam, **kw),
            lambda: og.splat_rows_plain(gaussians, alive, pose, cam, **kw))
    b_ms, b_plain, _ = timing.compare(
        timer, lambda: og.splat_rows_bwd_cuda(gaussians, pose, cam.K, cot,
                                              n_sh_band=n_sh_band,
                                              use_sh_precompute=use_sh_precompute),
        lambda: torch.autograd.grad(want.feat, [leaves[k] for k in names], cot,
                                    allow_unused=True, retain_graph=True))
    out = {}
    for key, ms, plain_ms, nbytes, ops in (
            ("geometry_fwd", f_ms, f_plain, fwd_b, GEOMETRY_FWD_OPS * n),
            ("geometry_bwd", b_ms, b_plain, bwd_b, GEOMETRY_BWD_OPS * n)):
        bound_ms, bound_by = timing.bound(nbytes, ops)
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        share=bound_ms / ms,
                        err=worst_fwd if key == "geometry_fwd" else worst_bwd)
        print(f"[time] {key} {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {nbytes / n:.0f} B a gaussian), "
              f"{100 * bound_ms / ms:.1f}% of the bound (CUDA events, cold L2; {smi})")
    return out


def in_view(n, spread, pose, gen):
    """``n`` world points 2 to 20 units deep in front of the camera ``pose``
    (camera_T_world), over ``spread`` times the frame, drawn from ``gen``."""
    import torch

    dev = pose.device
    z = 2.0 + 18.0 * torch.rand(n, generator=gen, device=dev)
    xy = (torch.rand(n, 2, generator=gen, device=dev) - 0.5) * spread
    xc = torch.stack([xy[:, 0] * WIDTH / FOCAL * z, xy[:, 1] * HEIGHT / FOCAL * z, z], 1)
    return (xc - pose[:3, 3]) @ pose[:3, :3]


def scaffold_rows(pose, cam, cull, gen):
    """The decoded rows (``scaffold.decode``) of GEOMETRY_ANCHORS Scaffold-GS
    anchors, every one in view of ``pose``, drawn from ``gen``; the MLPs
    take torch's default initialisation from the global seed."""
    import torch

    from gaussian_splatting_torch import scaffold

    dev, m = pose.device, GEOMETRY_ANCHORS
    anchors = scaffold.ScaffoldScene(
        in_view(m, 0.9, pose, gen),
        torch.rand(m, scaffold.N_OFFSETS, 3, generator=gen, device=dev) * 2 - 1,
        torch.randn(m, scaffold.FEAT_DIM, generator=gen, device=dev),
        torch.full((m, 6), math.log(0.02), device=dev), torch.ones(m, dtype=torch.bool,
                                                                  device=dev))
    with torch.no_grad():
        return scaffold.decode(anchors.params(), anchors.anchor, anchors.alive, pose, cam,
                               **cull)


def geometry_phase(smi):
    """The "[geometry]" phase: the geometry kernel pair against its plain
    version (``ops.geometry.splat_rows_plain``) at the cells' shapes, 2^21
    slots of 1.5M seeded gaussians at band 3 on both colour paths and the
    8.0M rows of a Scaffold-GS decode of 800,000 anchors; each kernel
    alone against its byte bound; the launches of one training step and
    one served view on the main paths.  Returns the kernels line's two
    entries."""
    import torch

    from gaussian_splatting_torch import scaffold, telemetry, trainer
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.rasterize import rasterize
    from gaussian_splatting_torch.structs import Camera, GaussianScene

    dev = torch.device(DEVICE)
    cfg = SplatConfig()
    cull = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                cull_mask_padding=cfg.cull_mask_padding)
    K = torch.tensor([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    cam = Camera(K, WIDTH, HEIGHT)
    ang = 0.2
    pose = torch.eye(4, device=dev)
    pose[:3, :3] = torch.tensor([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                                 [-math.sin(ang), 0, math.cos(ang)]], device=dev)
    pose[:3, 3] = torch.tensor([0.3, -0.2, 0.5], device=dev)
    gen = torch.Generator(dev).manual_seed(GEOMETRY_SEED)
    n = GEOMETRY_ALIVE
    scene = GaussianScene.create(
        in_view(n, 1.2, pose, gen), torch.rand(n, 3, generator=gen, device=dev),
        torch.randn(n, 1, generator=gen, device=dev),
        -4.5 + 0.5 * torch.randn(n, 3, generator=gen, device=dev),
        torch.randn(n, 4, generator=gen, device=dev),
        0.2 * torch.randn(n, 3, 15, generator=gen, device=dev),
        capacity=GEOMETRY_SLOTS, device=dev)
    entries = {}
    for label, pre in (("precompute", True), ("per-pixel", False)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        uv = torch.zeros(2, GEOMETRY_SLOTS, device=dev, requires_grad=True)
        out = geometry_case(f"{GEOMETRY_SLOTS} slots, band {SH_BAND}, {label}", leaves,
                            scene.alive, pose, cam, SH_BAND, pre, uv,
                            dict(leaves, uv_offset=uv), smi, cull)
        for key, v in out.items():
            entries.setdefault(key, v)  # the precomputed path's shape stands for it

    # the rows of a Scaffold-GS decode: 800,000 anchors in view, 10 rows each
    torch.manual_seed(GEOMETRY_SEED)  # the MLPs' default initialisation
    dec = scaffold_rows(pose, cam, cull, gen)
    flat = torch.cat([dec["xyz"], dec["scale"], dec["quaternion"], dec["opacity"][:, None],
                      dec["rgb"]], 1).requires_grad_(True)
    rows = dict(xyz=flat[:, 0:3], scale=flat[:, 3:6], quaternion=flat[:, 6:10],
                opacity=flat[:, 10], rgb=flat[:, 11:14])
    if flat.shape[0] != GEOMETRY_ANCHORS * scaffold.N_OFFSETS:
        raise AssertionError(f"[geometry] the decode gave {flat.shape[0]} rows")
    out = geometry_case(f"{flat.shape[0]} decoded rows", rows, None, pose, cam, 0, True,
                        None, dict(flat=flat), smi, cull)
    for key, v in out.items():
        entries[key]["rows"] = v
    del flat, rows, dec

    # the main paths: one training step, one served view
    state = trainer.init_train_state(scene, cfg)
    gt = torch.rand(HEIGHT, WIDTH, 3, generator=gen, device=dev)
    bg = torch.zeros(3, device=dev)
    kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
    trainer.train_step(state, gt, K, pose, bg, **kw)  # warm
    telemetry.LAUNCHES.clear()
    trainer.train_step(state, gt, K, pose, bg, **kw)
    torch.cuda.synchronize()
    step = dict(telemetry.LAUNCHES)
    telemetry.LAUNCHES.clear()
    with torch.no_grad():
        rasterize(scene.params(), scene.alive, pose, cam, background_rgb=bg,
                  n_sh_band=SH_BAND, mh_dist=cfg.mh_dist, **cull)
    torch.cuda.synchronize()
    view = dict(telemetry.LAUNCHES)
    print(f"[geometry] launches of one training step {step}; of one served view {view}")
    want_step = with_geometry({"render_fwd": 1, "render_bwd": 1, "adam_step": 1})
    if step != want_step or view != with_geometry({"render_fwd": 1}):
        raise AssertionError(f"[geometry] launches {step}, {view}")
    halves = {"geometry_fwd": "forward", "geometry_bwd": "backward"}
    return [dict(name=f"{key} (geometry kernel pair, {halves[key]})", route="cuda", source="gaussian_splatting_torch/csrc/geometry.cu",
                 replaces=None,  # the JAX package leaves the chain to XLA
                 launches=0, max_abs_err=e["err"], ms=e["ms"], plain_ms=e["plain_ms"],
                 bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None,
                 decoded_rows={k: e["rows"][k] for k in ("ms", "plain_ms", "bound_ms")})
            for key, e in entries.items()]


def layout_bytes(n, splats, end_bit, opacity):
    """Bytes the layout kernels move for ``n`` gaussians and ``splats``
    splats, the sort over key bits [0, end_bit) (``LAYOUT_RADIX_BITS``'s
    comment)."""
    rows = 4 * 6 + 1 + (4 if opacity else 0)
    passes = -(-end_bit // LAYOUT_RADIX_BITS)
    return n * (2 * rows + 5 * 4) + splats * (12 + 8 + passes * 24 + 8)


def layout_case(label, rows, opacity, grid, mh_dist, smi):
    """One shape of the "[layout]" phase: the kernel layout against the plain
    one on the same rows on the card, bit for bit, then both timed (CUDA
    events, cold L2; the kernel path's time includes the device's wait for
    the host after its one read) beside the byte bound."""
    import torch

    from gaussian_splatting_torch import culling, timing

    got = culling._layout_cuda(*rows, grid, mh_dist, opacity)
    want = culling._layout_plain(*rows, grid, mh_dist, opacity)
    differ = [name for name, a, b in zip(culling.SplatLayout._fields, got, want)
              if not (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)]
    n = rows[0].shape[0]
    print(f"[layout] {label}: {n} gaussians, {got.num_visible} visible, {got.num_splats} "
          f"splats, {got.truncated} cells truncated, {grid.tile_count} tiles; kernel vs "
          f"plain: {'bit for bit' if not differ else 'DIFFER in ' + ', '.join(differ)}")
    if differ:
        raise AssertionError(f"[layout] {label}: the kernels' layout is not the plain one")
    timer = timing.Timer(rows[0].device)
    ms, plain_ms, _ = timing.compare(
        timer, lambda: culling._layout_cuda(*rows, grid, mh_dist, opacity),
        lambda: culling._layout_plain(*rows, grid, mh_dist, opacity))
    end_bit = 32 + (grid.tile_count - 1).bit_length()
    nbytes = layout_bytes(n, got.num_splats, end_bit, opacity is not None)
    bound_ms, bound_by = timing.bound(nbytes, 0)
    print(f"[time] layout {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {-(-end_bit // LAYOUT_RADIX_BITS)} "
          f"sort passes over {end_bit} key bits), {100 * bound_ms / ms:.1f}% of the bound "
          f"(CUDA events, cold L2; {smi})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                splats=got.num_splats)


def layout_phase(smi):
    """The "[layout]" phase: the layout kernels (``culling._layout_cuda``)
    against their plain version (``culling._layout_plain``) on the feature
    rows of garden view 0 at 1296x840 and of one Scaffold-GS view (the
    geometry phase's 800,000 anchors in view, decoded to 8.0M rows), each
    timed beside the plain layout and its byte bound.  Returns the kernels
    line's entry."""
    import torch

    from gaussian_splatting_torch import scaffold
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.ops import common as cc
    from gaussian_splatting_torch.ops.geometry import splat_rows
    from gaussian_splatting_torch.structs import TileGrid

    dev = torch.device(DEVICE)
    cfg = SplatConfig()
    cull = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                cull_mask_padding=cfg.cull_mask_padding)

    def layout_rows(g):
        f = g.feat
        return ((f[cc.FEAT_U], f[cc.FEAT_V], f[cc.FEAT_A], f[cc.FEAT_B], f[cc.FEAT_C], g.z,
                 g.visible), f[cc.FEAT_OPACITY])

    scene, cam, pose = scene_view(dev)
    grid = TileGrid(cam.height, cam.width)
    with torch.no_grad():
        g = splat_rows({k: v.detach() for k, v in scene.params().items()}, scene.alive,
                       pose, cam, **cull)
    rows, opacity = layout_rows(g)
    garden = layout_case(f"garden view 0 {WIDTH}x{HEIGHT}", rows, opacity, grid,
                         cfg.mh_dist, smi)
    layout_case(f"garden view 0 {WIDTH}x{HEIGHT}, no opacity", rows, None, grid,
                cfg.mh_dist, smi)
    del g, rows, opacity, scene

    # the rows of a Scaffold-GS decode: the geometry phase's anchors
    gen = torch.Generator(dev).manual_seed(LAYOUT_SEED)
    torch.manual_seed(LAYOUT_SEED)  # the MLPs' default initialisation
    with torch.no_grad():
        g = splat_rows(scaffold_rows(pose, cam, cull, gen), None, pose, cam, **cull)
    rows, opacity = layout_rows(g)
    neural = layout_case(f"Scaffold-GS view, {rows[0].shape[0]} decoded rows", rows,
                         opacity, grid, cfg.mh_dist, smi)
    return dict(name="layout (count, scan, fill, sort)", route="cuda",
                source="gaussian_splatting_torch/csrc/layout.cu",
                replaces=None,  # the JAX package builds its layout in XLA
                launches=0, max_abs_err=0.0, ms=garden["ms"], plain_ms=garden["plain_ms"],
                bound_ms=garden["bound_ms"], bound_by=garden["bound_by"], library_ms=None,
                splats=garden["splats"],
                decoded_rows={k: neural[k] for k in ("ms", "plain_ms", "bound_ms", "splats")})


def cotangent(raw, seed):
    import torch

    cot = np.random.default_rng(seed).normal(size=tuple(raw.shape)).astype(np.float32)
    return torch.from_numpy(cot).to(raw.device)


def bwd_args(dc, grid, seed):
    """B2's inputs at the shapes the training path gives it: features and
    layout, B1's raw output for them, and a seeded cotangent."""
    from gaussian_splatting_torch.ops.render import render_fwd_cuda

    feat, lay = dc
    raw = render_fwd_cuda(feat, lay.gaussian_idx, lay.tile_starts, grid.x_tiles)
    return (feat, lay.gaussian_idx, lay.tile_starts, grid.x_tiles, raw,
            cotangent(raw, seed))


def sh_bwd_args(sh_in, seed):
    """B4's inputs: features, basis and layout, B3's raw output for them,
    and a seeded cotangent."""
    from gaussian_splatting_torch.ops.render_sh import render_sh_fwd_cuda

    feat, basis, lay, x_tiles = sh_in
    raw = render_sh_fwd_cuda(feat, basis, lay.gaussian_idx, lay.tile_starts, x_tiles)
    return (feat, basis, lay.gaussian_idx, lay.tile_starts, x_tiles, raw,
            cotangent(raw, seed))


def compare_bwd(label, name, kern, plain, args, row_names):
    """A backward kernel (launched twice) against its plain version on the
    card, per gradient row relative to the row's max."""
    import torch

    k1 = kern(*args)
    k2 = kern(*args)
    torch.cuda.synchronize()
    p = plain(*args)
    torch.cuda.synchronize()
    scale = p.abs().amax(dim=1).clamp_min(1e-30)
    rel = ((k1 - p).abs().amax(dim=1) / scale).tolist()
    spread = ((k1 - k2).abs().amax(dim=1) / scale).tolist()
    abs_err = float((k1 - p).abs().max())
    print(f"  {label} {name}: max|grad| error per row ({row_names}) relative "
          f"to the row's max: {' '.join(f'{x:.2e}' for x in rel)} (tol "
          f"{BWD_REL_TOL}); max abs {abs_err:.3e}")
    print(f"  {label} {name}: run-to-run spread of two launches per row: "
          f"{' '.join(f'{x:.2e}' for x in spread)}")
    if not bool(torch.isfinite(k1).all()) or max(rel) > BWD_REL_TOL:
        raise AssertionError(f"{label}: {name} disagrees with its plain version")
    return abs_err, max(rel), max(spread)


def tile_spread(label, lay, tile_pairs):
    """Print the spread of evaluated pairs over a view's tiles and the
    splats per tile: whether the longest tiles could end a launch that
    takes the tiles in index order."""
    import torch

    counts = (lay.tile_starts[1:] - lay.tile_starts[:-1]).double()
    pairs = tile_pairs.double()
    q = torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=pairs.device)
    pq = torch.quantile(pairs, q).tolist()
    cq = torch.quantile(counts, q).tolist()
    top = torch.argsort(pairs, descending=True)
    share = float(pairs[top[:132]].sum() / pairs.sum())
    print(f"[tiles] {label}: num_splats {lay.num_splats} over {counts.numel()} tiles; "
          f"splats per tile min/median/p90/p99/max {' / '.join(f'{x:.0f}' for x in cq)}; "
          f"evaluated pairs per tile {' / '.join(f'{x:.0f}' for x in pq)} "
          f"(mean {float(pairs.mean()):.0f}); the 132 heaviest tiles hold "
          f"{share:.1%} of the pairs; launch positions of the 10 heaviest "
          f"{sorted(top[:10].tolist())}")


def warp_counts(feat, lay, x_tiles, rnd=32):
    """What the backward kernels' reductions see, counted with the plain
    walk (the backward's clamped alpha): (warp-splat steps, of them with a
    hit, pixel-rounds with a hit).  A warp-splat step is one splat of a
    tile's list against one warp of 32 pixels of which at least one still
    has T >= T_EPS; it has a hit where one of them composites the splat.
    The first versions of B2 and B4 reduced each step with a hit over the
    warp by shuffles.  A pixel-round with a hit is a pixel that composites
    at least one of a round of ``rnd`` splats: the steps of the two-phase
    kernels' phase B at rounds of 32."""
    import torch

    from gaussian_splatting_torch.ops import render as tr

    n_tiles = lay.tile_starts.numel() - 1
    T = torch.ones(n_tiles, 256, device=feat.device)
    steps = hit_steps = pixel_rounds = 0
    for tiles, gid, ok in tr._tile_chunks(lay.gaussian_idx, lay.tile_starts, rnd):
        alpha = tr._alpha_chunk(feat, gid, tiles, x_tiles)
        at, prod, active, _ = tr._composite_chunk(T[tiles], alpha, ok, clamp=True)
        live = active & ok[:, None, :]
        hit = active & (at > 0)
        steps += int(live.unflatten(1, (8, 32)).any(dim=2).sum())
        hit_steps += int(hit.unflatten(1, (8, 32)).any(dim=2).sum())
        pixel_rounds += int(hit.any(dim=2).sum())
        T[tiles] = tr._t_after(prod, active)
    return steps, hit_steps, pixel_rounds


def depth_pairs(dfeat, dlay, x_tiles, alpha_threshold):
    """What B5 walks: (splat-pixel pairs it evaluates, up to and including
    each pixel's crossing and every pair where nothing crosses; the steps
    of each tile's block, (n_tiles,): the most over its pixels of the
    crossing's place in the list + 1, or the list's length on a miss)."""
    import torch

    from gaussian_splatting_torch.ops import render as tr

    n_tiles = dlay.tile_starts.numel() - 1
    counts = (dlay.tile_starts[1:] - dlay.tile_starts[:-1]).long()
    T = torch.ones(n_tiles, 256, device=dfeat.device)
    found = torch.zeros(n_tiles, 256, dtype=torch.bool, device=dfeat.device)
    steps = counts[:, None].expand(n_tiles, 256).clone()  # a miss walks the list
    n = 0
    for k, (tiles, gid, ok) in enumerate(tr._tile_chunks(
            dlay.gaussian_idx, dlay.tile_starts, tr.PLAIN_CHUNK)):
        alpha = tr._alpha_chunk(dfeat, gid, tiles, x_tiles)
        at = torch.where(ok[:, None, :], alpha, torch.zeros_like(alpha))
        prod = torch.cumprod(torch.cat([T[tiles, :, None], 1.0 - at], dim=2), dim=2)
        crossed = ((1.0 - prod[..., 1:]) > alpha_threshold).int()
        earlier = (torch.cumsum(crossed, dim=2) - crossed) > 0
        n += int((ok[:, None, :] & ~found[tiles][:, :, None] & ~earlier).sum())
        new = crossed.bool().any(dim=2) & ~found[tiles]
        at_step = k * tr.PLAIN_CHUNK + crossed.argmax(dim=2) + 1
        steps[tiles] = torch.where(new, at_step, steps[tiles])
        found[tiles] |= crossed.bool().any(dim=2)
        T[tiles] = prod[..., -1]
    return n, steps.amax(dim=1)


def _ranks(x):
    """Ranks of the values of x (numpy), ties given their mean rank."""
    _, inverse, counts = np.unique(x, return_inverse=True, return_counts=True)
    upper = np.cumsum(counts)
    return ((upper - counts + upper - 1) / 2.0)[inverse]


def depth_tile_spread(label, dlay, tile_steps):
    """Print the spread of B5's steps per tile (depth_pairs), their rank
    correlation with the splat count that gs_tile_order sorts by, and the
    index-order launch positions of the 10 heaviest tiles."""
    steps = tile_steps.cpu().numpy().astype(np.float64)
    counts = (dlay.tile_starts[1:] - dlay.tile_starts[:-1]).cpu().numpy().astype(np.float64)
    q = np.quantile(steps, [0.0, 0.5, 0.9, 0.99, 1.0])
    rho = float(np.corrcoef(_ranks(steps), _ranks(counts))[0, 1])
    top = np.sort(np.argsort(-steps, kind="stable")[:10])
    print(f"[depth tiles] {label}: B5's steps per tile (the slowest pixel's crossing "
          f"+ 1, or the list on a miss) min/median/p90/p99/max "
          f"{' / '.join(f'{x:.0f}' for x in q)} (mean {steps.mean():.1f}, total "
          f"{steps.sum():.0f} against {counts.sum():.0f} splats); rank correlation "
          f"with the splat count {rho:.4f}; launch positions of the 10 heaviest in "
          f"index order {top.tolist()}; their steps {steps[top].astype(int).tolist()} and "
          f"splat counts {counts[top].astype(int).tolist()}")


def kernel_bounds(s_dc, s_dep, s_grid, s_sh):
    """Each kernel's bound at the main path's shapes (garden view 0): each
    input read once, each output written once, and the operations these
    inputs need."""
    from gaussian_splatting_torch.ops.render import dc_work, pair_counts
    from gaussian_splatting_torch.timing import (
        ALPHA_OPS,
        BWD_COMPOSITE_OPS,
        DEPTH_OPS,
        FWD_COMPOSITE_OPS,
        bound,
    )

    feat, lay = s_dc
    dfeat, dlay = s_dep
    sfeat, basis, slay, x_tiles = s_sh
    n_sh = basis.shape[0]
    n_pix = s_grid.tile_count * 256
    f32 = 4

    def layout_bytes(la):
        return f32 * (la.num_splats + la.tile_starts.numel())

    dc = dc_work(feat, lay.gaussian_idx, lay.tile_starts, s_grid.x_tiles)
    tile_spread("garden view 0", lay, dc["tile_pairs"])
    ev, co, ev_b, co_b = (dc[k] for k in ("evaluated", "composited", "evaluated_bwd",
                                          "composited_bwd"))
    sev, sco, _ = pair_counts(sfeat, slay.gaussian_idx, slay.tile_starts, x_tiles)
    sev_b, sco_b, _ = pair_counts(sfeat, slay.gaussian_idx, slay.tile_starts, x_tiles,
                                   clamp=True)
    dev, depth_steps = depth_pairs(dfeat, dlay, s_grid.x_tiles, ALPHA_THRESHOLD)
    depth_tile_spread("garden view 0", dlay, depth_steps)
    sfeat_b = f32 * sfeat.numel()
    raw_b = f32 * 4 * n_pix
    sh_ops = 2 * 3 * n_sh
    work = {
        "render_fwd": dc["render_fwd"],
        "render_bwd": dc["render_bwd"],
        "render_sh_fwd": (sfeat_b + f32 * basis.numel() + layout_bytes(slay) + raw_b,
                          ALPHA_OPS * sev + (FWD_COMPOSITE_OPS + sh_ops) * sco),
        "render_sh_bwd": (2 * sfeat_b + f32 * basis.numel() + layout_bytes(slay)
                          + 2 * raw_b,
                          ALPHA_OPS * sev_b + (BWD_COMPOSITE_OPS + 2 * sh_ops) * sco_b),
        "depth_fwd": (f32 * dfeat.numel() + layout_bytes(dlay) + f32 * n_pix,
                      (ALPHA_OPS + DEPTH_OPS) * dev),
    }
    print(f"[bound] garden view 0: B1 {ev} pairs evaluated, {co} composited; "
          f"B2 {ev_b} / {co_b}; B3 {sev} / {sco}; B4 {sev_b} / {sco_b}; "
          f"B5 {dev} evaluated")
    for name, (f, la, xt) in (("B2", (feat, lay, s_grid.x_tiles)),
                              ("B4", (sfeat, slay, x_tiles))):
        steps, hit_steps, rounds = warp_counts(f, la, xt)
        print(f"[bound] garden view 0, {name}'s reductions: {steps} warp-splat "
              f"steps, {hit_steps} of them with a hit; {rounds} pixel-rounds "
              f"(32 splats) with a hit")
    out = {}
    for name, (nbytes, ops) in work.items():
        out[name] = bound(nbytes, ops)
        print(f"[bound] {name}: {nbytes} bytes, {ops} float32 operations -> "
              f"{out[name][0]:.5f} ms, bound by {out[name][1]}")
    return out


def visible_rows(params, alive, pose, cam, cfg):
    """The gaussians a view makes visible (rasterize's frustum test)."""
    from gaussian_splatting_torch import geometry as geo
    from gaussian_splatting_torch.culling import frustum_visible_rows

    xyzT = params["xyz"].T
    xc, yc, zc = geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], pose)
    u, v = geo.project_rows(xc, yc, zc, cam.K)
    return frustum_visible_rows(
        u, v, zc, (cam.width, cam.height), cfg.near_thresh, cfg.far_thresh,
        cfg.cull_mask_padding) & alive


def training_setup(dev, scene_kw):
    """The training paths' inputs on the trained scene.

    Ground truth is the unperturbed scene rendered from the 4 orbit views
    on each step's background (the runner's i % 255 / 255 grey), clipped
    and stored as uint8; a target on black would make the loss rise with
    the background on these views, whose mean transmittance is ~0.4.  The
    scene is then offset by a seeded perturbation of colour and opacity,
    from which every training run starts."""
    import torch

    import render_torch
    from gaussian_splatting_torch.rasterize import rasterize
    from gaussian_splatting_torch.structs import Camera

    scene = render_torch.load_scene(SCENE, dev)
    params0 = {k: v.detach() for k, v in scene.params().items()}
    xyz = params0["xyz"][scene.alive].cpu().numpy()
    poses = [torch.from_numpy(p).to(dev) for p in render_torch.orbit_poses(xyz, N_VIEWS)]
    K = torch.tensor([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    cam = Camera(K, WIDTH, HEIGHT)
    bgs = [torch.full((3,), (i % 255) / 255.0, device=dev) for i in range(TRAIN_STEPS)]
    gts = []
    with torch.no_grad():
        for i in range(TRAIN_STEPS):
            img = rasterize(params0, scene.alive, poses[i % N_VIEWS], cam,
                            background_rgb=bgs[i], n_sh_band=SH_BAND, **scene_kw).image
            gts.append((img.clamp(0, 1) * 255).round().to(torch.uint8))
        perturb(scene, scene.capacity)
    return dict(scene=scene, poses=poses, K=K, cam=cam, bgs=bgs, gts=gts)


def perturb(scene, n):
    """The training paths' seeded offset of the colour and pre-sigmoid
    opacity of the scene's first n slots, in place."""
    import torch

    rng = np.random.default_rng(TRAIN_SEED)
    dev = scene.xyz.device
    scene.rgb[:n].add_(torch.from_numpy(
        rng.normal(0, RGB_NOISE, (n, 3)).astype(np.float32)).to(dev))
    scene.opacity[:n].add_(torch.from_numpy(
        rng.normal(0, OPACITY_NOISE, (n, 1)).astype(np.float32)).to(dev))


def training_phase(setup, cfg, steps, tag, kernels):
    """trainer.train_step for ``steps`` steps from the perturbed scene,
    cycling through the views; ``kernels`` = (forward, backward) launch
    counter names that each step must launch once, with the Adam step, and
    no other kernel.  Returns (launches, median step ms)."""
    import torch

    from gaussian_splatting_torch import telemetry, trainer

    scene, poses, K, cam = setup["scene"], setup["poses"], setup["K"], setup["cam"]
    bgs, gts = setup["bgs"], setup["gts"]
    state = trainer.init_train_state(scene, cfg)
    kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
    # gts[0] is view 0 on black, as eval_step renders it
    _, psnr0, ssim0 = trainer.eval_step(state, gts[0], K, poses[0], **kw)
    print(f"[{tag}] {scene.num_alive()} gaussians, SH band {SH_BAND}, "
          f"use_sh_precompute={cfg.use_sh_precompute}, {steps} steps over "
          f"{N_VIEWS} views at {WIDTH}x{HEIGHT}; view 0 before: PSNR "
          f"{float(psnr0):.4f} SSIM {float(ssim0):.5f}")

    n = scene.capacity
    expected = torch.zeros(n, dtype=torch.int32, device=K.device)
    losses, step_ms = [], []
    telemetry.LAUNCHES.clear()
    for i in range(steps):
        pose = poses[i % N_VIEWS]
        expected += visible_rows(state.params, state.alive, pose, cam, cfg).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = trainer.train_step(state, gts[i], K, pose, bgs[i], **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(info["loss"]))
        print(f"[{tag}] step {i:2d} view {i % N_VIEWS} bg {i % 255}/255: loss "
              f"{losses[-1]:.6f} psnr {float(info['psnr']):.4f} splats "
              f"{info['num_splats']} visible {info['num_visible']} "
              f"({step_ms[-1]:.2f} ms)")
    launches = dict(telemetry.LAUNCHES)
    print(f"[{tag}] launches {launches}")

    want = with_geometry(dict({name: steps for name in kernels}, adam_step=steps))
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    count = int(state.opt_state.count)
    if count != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"a step was skipped: Adam count {count}, losses {losses}")
    for k, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"params['{k}'] not finite after training")
    if not bool((state.opt_state.mu["sh"] != 0).any()):
        raise AssertionError("sh received no gradient")
    seen = expected > 0
    if not torch.equal(state.grad_accum_count, expected):
        raise AssertionError("grad_accum_count differs from the views' visibility")
    print(f"[{tag}] grad_accum_count equals the per-step visibility count; "
          f"{int(seen.sum())} gaussians seen, {int((~seen & state.alive).sum())} never; "
          f"uv_grad_accum max {float(state.uv_grad_accum.max()):.4e}; sh gradient "
          f"reached {int((state.opt_state.mu['sh'] != 0).any(2).any(1).sum())} gaussians")
    if bool((state.uv_grad_accum[~seen] != 0).any()) or not bool(
            (state.xyz_grad_accum[seen].abs().sum(1) > 0).any()):
        raise AssertionError("accumulators do not follow visibility")
    for v in range(N_VIEWS):
        first, last = losses[v], losses[v + N_VIEWS * ((steps - 1 - v) // N_VIEWS)]
        print(f"[{tag}] view {v}: loss first pass {first:.6f}, last pass {last:.6f}")
        if not last < first:
            raise AssertionError(f"view {v}: loss did not fall")
    _, psnr1, ssim1 = trainer.eval_step(state, gts[0], K, poses[0], **kw)
    print(f"[{tag}] view 0 after: PSNR {float(psnr1):.4f} SSIM {float(ssim1):.5f}")

    # host-clock step time, then one step under the profiler
    for i in range(STEP_TIMING_STEPS):
        j = i % N_VIEWS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, gts[j], K, poses[j], bgs[j], **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    steady = step_ms[N_VIEWS:]
    median_ms = statistics.median(steady)
    print(f"[time] {tag} step at {WIDTH}x{HEIGHT}: median {median_ms:.3f} ms over "
          f"{len(steady)} steps after a warm-up pass (host clock), min "
          f"{min(steady):.3f}, max {max(steady):.3f}")
    profile_step(lambda: trainer.train_step(state, gts[1], K, poses[1], bgs[1], **kw),
                 median_ms, tag)
    return launches, median_ms


def _scaffold_check_step(tag, i, state, start, want, g_want, loss, want_loss):
    """The program's state after step i against the reference's: the loss
    within 1e-5; after the first step each leaf within 2e-4 of its rate
    beyond what its gradient's gap explains (tests/test_torch_scaffold.py's
    rule), after later ones each leaf's change in norm within 1e-3 (the
    benchmark's step_gap)."""
    from gaussian_splatting_torch import optim, scaffold

    def flat(x):
        return scaffold.pack_mlp(*x) if isinstance(x, list) else x

    worst = {}
    for k in scaffold.LEAVES:
        if i == 0:
            g = state.opt_state.mu[k] / (1 - optim.B1)
            explained = 2 * (g - flat(g_want[k])).abs() / (flat(g_want[k]).abs() + optim.EPS)
            gap = (state.params[k] - flat(want[k])).abs() / scaffold.LEARNING_RATES[k]
            worst[k] = float((gap - explained).max())
        else:
            moved = float((flat(want[k]) - start[k]).norm())
            worst[k] = abs(float((state.params[k] - start[k]).norm()) - moved) / moved
    loss_gap = abs(loss - want_loss) / abs(want_loss)
    print(f"[{tag}] step {i}: loss {loss:.7f} (reference {want_loss:.7f}, gap "
          f"{loss_gap:.2e}); worst leaf gap {max(worst.values()):.2e} "
          f"({max(worst, key=worst.get)}; {'of its rate' if i == 0 else 'of its change'})")
    if loss_gap > 1e-5 or max(worst.values()) > (2e-4 if i == 0 else 1e-3):
        raise AssertionError(f"{tag} step {i}: loss gap {loss_gap}, leaf gaps {worst}")


def scaffold_phase(smi):
    """Scaffold-GS on the card (the module docstring's "[scaffold]").
    Returns the launches of the larger scene's steps."""
    import torch

    from gaussian_splatting_torch import scaffold, telemetry, trainer
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.structs import Camera
    from tests import test_torch_scaffold as ts
    from tests import torch_scaffold_reference as ref

    dev = torch.device(DEVICE)
    tag = "scaffold"
    cfg = SplatConfig()
    kw = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
              cull_mask_padding=cfg.cull_mask_padding)

    # 1. the tests' small scene: decode, image, gradients and 3 steps
    sc, pose, K = ts._scene()
    sc, pose, K = sc.to(dev), pose.to(dev), K.to(dev)
    bg = ts.BG.to(dev)
    with torch.no_grad():
        rows = scaffold.decode(sc.params(), sc.anchor, sc.alive, pose, Camera(K, ts.W, ts.H),
                               **kw)
        g = ref.decode(ts._ref_params(sc), sc.anchor, sc.alive, pose, K, ts.W, ts.H,
                       ts.RCFG["near"], ts.RCFG["far"], ts.RCFG["padding"])
        xyz = rows["xyz"][rows["opacity"] > 0]
        row_err = float((xyz - g["xyz"]).abs().max() / g["xyz"].abs().max())
        res, _ = scaffold.render(sc.params(), sc.anchor, sc.alive, pose, Camera(K, ts.W, ts.H),
                                 mh_dist=cfg.mh_dist, background_rgb=bg, **kw)
        img = ref.render(g, pose, K, ts.W, ts.H, bg, near=ts.RCFG["near"], far=ts.RCFG["far"],
                         padding=ts.RCFG["padding"], mh_dist=ts.RCFG["mh_dist"])
        img_err = float((res.image - img).abs().max())
    print(f"[{tag}] small scene on the card: {g['opacity'].shape[0]} neural gaussians; "
          f"decoded xyz rel err {row_err:.2e}, image max abs err {img_err:.2e}")
    if row_err > ts.ROW_REL_TOL or img_err > ts.IMAGE_ATOL:
        raise AssertionError(f"{tag}: decode {row_err} or image {img_err} off the reference")
    gts = [ts._gt(seed).to(dev) for seed in (1, 2, 3)]
    state = trainer.init_train_state(sc, cfg)
    p = ts._ref_params(sc)
    mu = {k: [torch.zeros_like(t) for t in v] if isinstance(v, list) else torch.zeros_like(v)
          for k, v in p.items()}
    nu = {k: [torch.zeros_like(t) for t in v] if isinstance(v, list) else torch.zeros_like(v)
          for k, v in p.items()}
    start = {k: v.clone() for k, v in state.params.items()}
    for i, gt in enumerate(gts):
        state, info = trainer.train_step(state, gt, K, pose, bg, config=cfg,
                                         camera_hw=(ts.H, ts.W), n_sh_band=0)
        loss, grads, _ = ref.grads(p, sc.anchor, sc.alive, pose, K, gt, bg, ts.RCFG)
        p, mu, nu = ref.adam_step(p, grads, mu, nu, i + 1)
        _scaffold_check_step(tag, i, state, start, p, grads, float(info["loss"]), float(loss))

    # 2. anchors at the trained scene's positions, at 1296x840
    scene, cam, pose0 = scene_view(dev)
    xyz = scene.xyz[scene.alive].detach()
    n = xyz.shape[0]
    gen = torch.Generator(dev).manual_seed(19)
    nn_sq = torch.empty(n, device=dev)
    for i in range(0, n, 4096):
        d = torch.cdist(xyz[i:i + 4096], xyz, compute_mode="donot_use_mm_for_euclid_dist")
        nn_sq[i:i + 4096] = d.topk(4, largest=False).values[:, 1:].square().mean(1)
    cap = 1 << 16
    pad = cap - n

    def slots(t):
        return torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), device=dev)])

    torch.manual_seed(19)
    big = scaffold.ScaffoldScene(
        slots(xyz), slots(torch.rand(n, scaffold.N_OFFSETS, 3, generator=gen, device=dev) * 2 - 1),
        slots(torch.randn(n, scaffold.FEAT_DIM, generator=gen, device=dev)),
        slots(torch.log(nn_sq.clamp_min(1e-7).sqrt())[:, None].repeat(1, 6)),
        torch.arange(cap, device=dev) < n)
    import render_torch

    poses = [torch.from_numpy(q).to(dev)
             for q in render_torch.orbit_poses(xyz.cpu().numpy(), N_VIEWS)[:2]]
    with torch.no_grad():
        rows = scaffold.decode(big.params(), big.anchor, big.alive, poses[0], cam, **kw)
        p_big = ts._ref_params(big)
        g = ref.decode(p_big, big.anchor, big.alive, poses[0], cam.K, WIDTH, HEIGHT,
                       cfg.near_thresh, cfg.far_thresh, float(cfg.cull_mask_padding))
        shown = rows["opacity"] > 0
        rows = {k: v[shown] for k, v in rows.items()}
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in (
            (rows["xyz"], g["xyz"]), (rows["opacity"], g["opacity"]), (rows["rgb"], g["colour"]),
            (torch.exp(rows["scale"]), g["scaling"])))
        targets = []
        for q in poses:  # the unperturbed scene as the port renders it, on black
            r, _ = scaffold.render(big.params(), big.anchor, big.alive, q, cam,
                                   mh_dist=cfg.mh_dist, background_rgb=torch.zeros(3, device=dev),
                                   **kw)
            targets.append(r.image.clamp(0, 1))
    print(f"[{tag}] {n} anchors in {cap} slots at {WIDTH}x{HEIGHT}: view 0 decodes "
          f"{int(shown.numel()) // scaffold.N_OFFSETS} anchors into {shown.numel()} rows, "
          f"{rows['opacity'].shape[0]} of opacity > 0; decoded rows' worst rel err against "
          f"the reference {rel:.2e}")
    if rel > 1e-5 or rows["opacity"].shape[0] != g["opacity"].shape[0]:
        raise AssertionError(f"{tag}: the large decode is off the reference ({rel})")
    with torch.no_grad():
        big.anchor_feat.add_(0.3 * torch.randn(big.anchor_feat.shape, generator=gen, device=dev))
    state = trainer.init_train_state(big, cfg)
    black = torch.zeros(3, device=dev)
    telemetry.LAUNCHES.clear()
    losses, step_ms = [], []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = trainer.train_step(state, targets[i % 2], cam.K, poses[i % 2], black,
                                         config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(info["loss"]))
        print(f"[{tag}] step {i} view {i % 2}: loss {losses[-1]:.6f} rows {info['neural']} "
              f"splats {info['num_splats']} ({step_ms[-1]:.2f} ms)")
    launches = dict(telemetry.LAUNCHES)
    want = with_geometry({"render_fwd": 8, "render_bwd": 8, "adam_step": 8})
    if launches != want or int(state.opt_state.count) != 8:
        raise AssertionError(f"{tag}: expected launches {want} and 8 steps, got {launches}, "
                             f"count {int(state.opt_state.count)}")
    for k, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: leaf {k} not finite")
    for v in range(2):
        if not losses[6 + v] < losses[v]:
            raise AssertionError(f"{tag}: view {v}'s loss did not fall: {losses}")
    with telemetry.recording():
        state, _ = trainer.train_step(state, targets[0], cam.K, poses[0], black, config=cfg,
                                      camera_hw=(HEIGHT, WIDTH), n_sh_band=0)
        torch.cuda.synchronize()
    c = telemetry.window()["counters"]
    print(f"[time] {tag} step at {WIDTH}x{HEIGHT}, {n} anchors: median "
          f"{statistics.median(step_ms[2:]):.3f} ms (host clock, steps 2-7); decode "
          f"{c['decode_us'] / 1e3:.3f} device ms forward and backward, {c['anchors']} anchors, "
          f"{c['neural']} rows, {sum(v for k, v in c.items() if k.startswith('sync.'))}"
          f" blocking reads ({smi})")
    return launches


def dc_steps(state, setup, cfg, first, steps, tag):
    """DC train steps first .. first + steps - 1 on the training setup's
    views and targets; each must launch B1, B2 and the Adam step once, and
    no other kernel, with a finite loss.  Returns (state, launches)."""
    from gaussian_splatting_torch import telemetry, trainer

    kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
    losses = []
    telemetry.LAUNCHES.clear()
    for i in range(first, first + steps):
        state, info = trainer.train_step(state, setup["gts"][i], setup["K"],
                                         setup["poses"][i % N_VIEWS], setup["bgs"][i], **kw)
        losses.append(float(info["loss"]))
    launches = dict(telemetry.LAUNCHES)
    print(f"[{tag}] steps {first}-{first + steps - 1}: losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; launches {launches}")
    want = with_geometry({"render_fwd": steps, "render_bwd": steps, "adam_step": steps})
    if launches != want or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: expected launches {want} and finite losses, got "
                             f"{launches}, {losses}")
    return state, launches


def check_adc(before, after, stats, cfg):
    """The event's results on the card: the slot accounting, zero moments
    at every slot it freed or wrote, zero accumulators, finite parameters,
    and each split sample in the box R (r * exp(scale)), r in [0, 1)^3, of
    its source in the state before the event (sample 1 in the source's
    slot; sample 2 found by the colour and opacity it copies)."""
    import torch

    from gaussian_splatting_torch.geometry import quaternion_to_rotation

    a0, a1 = before.alive, after.alive
    p0, p1 = before.params, after.params
    n_alive = int(stats["n_alive"])
    written = (int(stats["n_clone"]) - int(stats["clone_deferred"])
               + int(stats["n_split"]) - int(stats["split_deferred"]))
    want_alive = int(a0.sum()) - int(stats["n_deleted"]) + written
    print(f"[adc] n_alive {n_alive}: alive.sum() {int(a1.sum())}; alive before "
          f"{int(a0.sum())} - deleted {int(stats['n_deleted'])} + clones and second "
          f"samples written {written} = {want_alive}")
    if not n_alive == int(a1.sum()) == want_alive:
        raise AssertionError("ADC: the alive count does not add up")
    touched = ((a0 != a1) | (p1["xyz"] != p0["xyz"]).any(1)
               | (p1["scale"] != p0["scale"]).any(1))
    adam = after.opt_state
    for name in adam.mu:
        if bool(adam.mu[name][touched].any()) or bool(adam.nu[name][touched].any()):
            raise AssertionError(f"ADC: nonzero moments of {name} at a freed or written slot")
    for acc in (after.uv_grad_accum, after.xyz_grad_accum, after.grad_accum_count):
        if bool(acc.any()):
            raise AssertionError("ADC: accumulators not zeroed")
    for name, v in p1.items():
        if not bool(torch.isfinite(v[a1]).all()):
            raise AssertionError(f"ADC: params['{name}'] not finite on an alive slot")

    # sources: split in place, their scale shrunk by split_scale_factor
    new_scale = torch.log(torch.exp(p0["scale"]) / cfg.split_scale_factor)
    src = torch.nonzero(a0 & a1 & (p1["scale"] == new_scale).all(1)).squeeze(1)
    if len(src) == 0:
        raise AssertionError("ADC split no gaussian")

    def key(p, idx):  # a gaussian's opacity and red bits, which both samples keep
        return ((p["opacity"][idx, 0].view(torch.int32).long() << 32)
                | (p["rgb"][idx, 0].view(torch.int32).long() & 0xFFFFFFFF))

    skeys, order = torch.sort(key(p1, src))
    cand = torch.nonzero(touched & a1).squeeze(1)
    cand = cand[~torch.isin(cand, src)]
    pos = torch.searchsorted(skeys, key(p1, cand)).clamp_max(len(skeys) - 1)
    found = skeys[pos] == key(p1, cand)
    its_src = src[order[pos]]
    second = found & (p1["scale"][cand] == p1["scale"][its_src]).all(1)
    seconds, seconds_src = cand[second], its_src[second]
    distinct = bool((skeys[1:] != skeys[:-1]).all())
    print(f"[adc] split sources {len(src)} (n_split {int(stats['n_split'])}), second "
          f"samples {len(seconds)} (n_split - split_deferred "
          f"{int(stats['n_split']) - int(stats['split_deferred'])}); sources' keys distinct: "
          f"{distinct}")
    if not (distinct and len(src) == int(stats["n_split"])
            and len(seconds) == int(stats["n_split"]) - int(stats["split_deferred"])):
        raise AssertionError("ADC: the split's slots do not match its stats")
    x = torch.cat([p1["xyz"][src], p1["xyz"][seconds]])
    s = torch.cat([src, seconds_src])
    q = p0["quaternion"][s]
    rot = quaternion_to_rotation(q / torch.linalg.vector_norm(q, dim=1, keepdim=True))
    scale = torch.exp(p0["scale"][s])
    r = torch.einsum("nji,nj->ni", rot, x - p0["xyz"][s]) / scale
    eps = torch.finfo(torch.float32).eps
    tol = BOX_TOL + BOX_ULPS * eps * x.abs().amax(1, keepdim=True) / scale
    inside = bool(((r >= -tol) & (r < 1 + tol)).all())
    print(f"[adc] split samples {len(r)}: r = R^T (x - xyz) / exp(scale) in "
          f"[{float(r.min()):.6f}, {float(r.max()):.6f}], each in [0, 1) at tol {BOX_TOL} + "
          f"{BOX_ULPS} ulps of |x| / scale (largest tol {float(tol.max()):.2e}): {inside}; "
          f"mean per axis {[round(float(m), 4) for m in r.mean(0)]}")
    if not inside:
        raise AssertionError("ADC: a split sample lies outside its source's box")


def check_reset(before, after, cfg):
    """Opacity inverse_sigmoid(reset value) in every slot, its moments zero,
    the other leaves' moments as they were, the accumulators zero."""
    import torch

    from gaussian_splatting_torch.geometry import inverse_sigmoid

    want = torch.tensor(inverse_sigmoid(cfg.reset_opacity_value), dtype=torch.float32)
    op = after.params["opacity"]
    ok = bool((op == want.to(op.device)).all())
    m0, m1 = before.opt_state, after.opt_state
    zero = not bool(m1.mu["opacity"].any()) and not bool(m1.nu["opacity"].any())
    kept = all(torch.equal(m1.mu[k], m0.mu[k]) and torch.equal(m1.nu[k], m0.nu[k])
               for k in m0.mu if k != "opacity")
    acc = not any(bool(a.any()) for a in (after.uv_grad_accum, after.xyz_grad_accum,
                                           after.grad_accum_count))
    print(f"[reset] opacity {float(want):.6f} in all {op.shape[0]} slots: {ok}; opacity "
          f"moments zero: {zero}; other moments kept: {kept}; accumulators zero: {acc}; "
          f"Adam count {int(after.opt_state.count)}")
    if not (ok and zero and kept and acc):
        raise AssertionError("reset_opacity: state not as expected")


def event_ms(fn):
    """Host-clock ms of one call of fn, from and to an idle device; returns
    (ms, fn's result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def adc_phase(setup, cfg, smi):
    """The schedule's two events on the garden scene at ADC_CAPACITY slots,
    from the training paths' seeded perturbation: 8 DC steps, adaptive
    density control at ADC_ITERATION, 4 steps, opacity reset, 4 steps.
    Each event is timed on its first call and on a second call with the
    same inputs (neither writes its input state).  Returns (the launches
    of its 16 steps, event ms, reset ms), the second calls' times."""
    import collections

    import torch

    from gaussian_splatting_torch import checkpoint as ckpt
    from gaussian_splatting_torch import trainer

    dev = setup["K"].device
    scene = ckpt.import_ply(SCENE, device=dev, capacity=ADC_CAPACITY)
    n = scene.num_alive()
    if not bool(scene.alive[:n].all()):
        raise AssertionError("the scene's points are not its first slots")
    with torch.no_grad():
        perturb(scene, n)
    state = trainer.init_train_state(scene, cfg)
    print(f"[adc] {n} gaussians in {ADC_CAPACITY} slots (the JAX runner's "
          f"derive_capacity), {ADC_STEPS_BEFORE} DC steps, then the event at iteration "
          f"{ADC_ITERATION}")
    launches = collections.Counter()
    state, got = dc_steps(state, setup, cfg, 0, ADC_STEPS_BEFORE, "adc")
    launches.update(got)

    def event():
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        return trainer.adaptive_density_control(state, gen, ADC_ITERATION, config=cfg)

    first_ms, (after, stats) = event_ms(event)
    adc_ms, _ = event_ms(event)
    names = list(stats)
    vals = dict(zip(names, torch.stack([stats[k].double() for k in names]).cpu().tolist()))
    factor = ((cfg.adaptive_control_end - ADC_ITERATION)
              / (cfg.adaptive_control_end - cfg.adaptive_control_start) * 2.0)
    print(f"[adc] adaptive_density_control at iteration {ADC_ITERATION} (factor "
          f"{factor:.4f}, uv_pct {1 - (1 - cfg.uv_grad_percentile) * factor:.4f}, scale_pct "
          f"{1 - (1 - cfg.scale_norm_percentile) * factor:.4f}): {vals}; {first_ms:.3f} ms "
          f"on its first call, {adc_ms:.3f} ms on a second (host clock; {smi})")
    check_adc(state, after, vals, cfg)

    state, got = dc_steps(after, setup, cfg, ADC_STEPS_BEFORE, ADC_STEPS_AFTER, "adc")
    launches.update(got)
    first_ms, reset = event_ms(lambda: trainer.reset_opacity(state, config=cfg))
    reset_ms, _ = event_ms(lambda: trainer.reset_opacity(state, config=cfg))
    print(f"[reset] reset_opacity: {first_ms:.3f} ms on its first call, {reset_ms:.3f} ms "
          f"on a second (host clock; {smi})")
    check_reset(state, reset, cfg)
    _, got = dc_steps(reset, setup, cfg, ADC_STEPS_BEFORE + ADC_STEPS_AFTER,
                      ADC_STEPS_AFTER, "reset")
    launches.update(got)
    return dict(launches), adc_ms, reset_ms


def refscale_config():
    """runs/refscale7k/config.yaml, read by the port's own YAML reader."""
    from gaussian_splatting_torch.config import SplatConfig

    with open(REFSCALE_CONFIG) as f:
        return SplatConfig.from_yaml(f.read())


def cli_argv(out, preset="synthetic", **overrides):
    """train_torch.py's arguments: ``preset`` at the fields of
    runs/refscale7k/config.yaml, with ``overrides``, on DEVICE."""
    import dataclasses

    cfg = refscale_config().replace(output_dir=out, **overrides)
    argv = [preset, "--device", DEVICE]
    for k, v in dataclasses.asdict(cfg).items():
        if v is None or isinstance(v, tuple):
            v = ",".join(str(x) for x in v or ())
        argv += [f"--{k}", str(v)]
    return argv


@contextlib.contextmanager
def call_times(owner, name, times, sync, after=None):
    """Record the host-clock (start, end) of every call of owner.name in
    ``times`` while the block runs; with ``sync`` the device is synchronised
    before the end is read.  ``after``, if given, is called with each call's
    arguments once it has returned."""
    import torch

    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        times.append((t0, time.perf_counter()))
        if after is not None:
            after(*args, **kwargs)
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def delete_census(trainer, adc_iters, rows, windows=REFSCALE_SHORT_WINDOWS):
    """While the block runs, each trainer.adaptive_density_control call (at
    the iterations ``adc_iters`` of a run that starts at 0) first appends
    (iteration, [opacity, count0, uv0, then count0 and uv0 for each k of
    ``windows``, then the Adam count]) to ``rows``: its deletes by reason
    (trainer.delete_reasons), the count-0 and uv-norm-0 deletes it would
    make had its window counted only its last k steps, and the steps taken
    so far (a skipped step does not advance the count).  The last k steps
    run with zeroed accumulators, their increments are kept apart and then
    added back, so the run's accumulators are the ones it would have had.
    One host read an event."""
    import torch

    step, adc = trainer.train_step, trainer.adaptive_density_control
    events, longest = sorted(adc_iters), max(windows)
    calls, partial = [0], {}

    def train_step(state, *args, **kwargs):
        i = calls[0]
        calls[0] += 1
        ahead = [e - i for e in events if e >= i]
        if not ahead or ahead[0] >= longest:
            return step(state, *args, **kwargs)
        acc = ("uv_grad_accum", "xyz_grad_accum", "grad_accum_count")
        out, info = step(state._replace(**{a: torch.zeros_like(getattr(state, a))
                                           for a in acc}), *args, **kwargs)
        for k in windows:
            if ahead[0] < k:
                c, u = partial.get(k, (0, 0))
                partial[k] = (out.grad_accum_count + c, out.uv_grad_accum + u)
        return out._replace(**{a: getattr(state, a) + getattr(out, a) for a in acc}), info

    def density_control(state, generator, iteration, *, config):
        counts = list(trainer.delete_reasons(state, config).values())
        for k in windows:
            c, u = partial.pop(k)
            short = trainer.delete_reasons(
                state._replace(grad_accum_count=c, uv_grad_accum=u), config)
            counts += [short["count0"], short["uv0"]]
        counts.append(state.opt_state.count)
        rows.append((iteration, torch.stack([x.to(torch.int64) for x in counts]).tolist()))
        return adc(state, generator, iteration, config=config)

    trainer.train_step, trainer.adaptive_density_control = train_step, density_control
    try:
        yield
    finally:
        trainer.train_step, trainer.adaptive_density_control = step, adc


def check_cli_run(runner, out, launches, start_iter, num_iters, tag):
    """A train_torch run's checks: launches the schedule implies (B1 for
    each ground-truth view, step, eval view and debug image, B2 and the Adam
    step for each step, no other kernel), finite parameters, its iterations and the
    metrics file's keys; on a rank of a parallel run, its own launches and
    state, and the eval checks only where it evaluates."""
    import torch

    from gaussian_splatting_torch.structs import GSMetricsLog

    m = runner.metrics
    steps = len(m.train_psnr)
    debug = sorted(f for f in os.listdir(out) if f.startswith("debug_iter"))
    want = with_geometry({"render_fwd": len(runner.data.images) + steps
                          + len(m.eval_iters) * len(runner.test_split) + len(debug),
                          "render_bwd": steps, "adam_step": steps})
    print(f"[{tag}] launches {launches}: {len(runner.data.images)} ground-truth views, "
          f"{steps} steps, {len(m.eval_iters)} evals of {len(runner.test_split)} views, "
          f"{len(debug)} debug images")
    if launches != want:
        raise AssertionError(f"{tag}: expected launches {want}, got {launches}")
    if runner.start_iter != start_iter or steps != num_iters - start_iter:
        raise AssertionError(f"{tag}: started at {runner.start_iter} with {steps} steps")
    if runner.evaluates and (m.eval_iters[0] != start_iter or m.eval_iters[-1] != num_iters):
        raise AssertionError(f"{tag}: evals at {m.eval_iters}")
    for k, v in runner.state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{tag}: params['{k}'] not finite")
    if not all(np.isfinite(m.train_psnr + m.test_psnr)):
        raise AssertionError(f"{tag}: a PSNR is not finite")
    with open(os.path.join(out, "metrics.json")) as f:
        saved = json.load(f)
    if saved.keys() != GSMetricsLog().to_dict().keys() or (
            runner.evaluates and saved["eval_iters"] != m.eval_iters):
        raise AssertionError(f"{tag}: metrics.json {sorted(saved)}")
    return saved


def refscale_phase(smi):
    """The "[refscale]" phase: refscale_run.main into a temporary directory
    (the full 7k schedule of runs/refscale7k through train_torch.main, then
    its bench sample), checked against the JAX run's record, its numbers,
    one profiled step at its final state, then a run resumed from its
    checkpoint at REFSCALE_CHECKPOINT to REFSCALE_RESUME_ITERS.  Each 1.5 GB
    checkpoint is deleted once it is checked.  Returns the B1 and B2
    launches of the two runs."""
    import shutil

    import torch

    import train_torch
    from gaussian_splatting_torch import telemetry, trainer
    from gaussian_splatting_torch import checkpoint as ckpt
    from gaussian_splatting_torch.experiments import refscale_run
    from gaussian_splatting_torch.runner import TrainingRunner, scheduled_events

    with open(REFSCALE_RECORD) as f:
        record = json.load(f)
    totals = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        out, out2 = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        print(f"[refscale] {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free for the "
              f"runs' files; {smi}")
        steps, evals, events, resets, census = [], [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        telemetry.LAUNCHES.clear()
        t0 = time.perf_counter()
        with delete_census(trainer, [e["iter"] for e in record["adc_events"]], census), \
                call_times(trainer, "train_step", steps, sync=False), \
                call_times(trainer, "reset_opacity", resets, sync=True), \
                call_times(TrainingRunner, "evaluate", evals, sync=True), \
                call_times(TrainingRunner, "_densify", events, sync=True):
            runner = refscale_run.main([out, "--device", DEVICE], **REFSCALE_TRACE)
        run_s = time.perf_counter() - t0
        launches = dict(telemetry.LAUNCHES)
        totals.update(launches)
        peak_mem = torch.cuda.max_memory_allocated()
        cfg, m = runner.config, runner.metrics
        n_iters, n_test = cfg.num_iters, len(runner.test_split)
        n_alive = int(runner.state.alive.sum())
        check_cli_run(runner, out, launches, 0, n_iters, "refscale")

        # the numbers, beside the JAX run's record, before the checks
        starts = [a for a, _ in steps]
        step_ms = np.diff(starts) * 1e3
        median_ms = float(np.median(step_ms))
        # the steps at the final state's size, for its profiled step
        late_ms = float(np.median(step_ms[-REFSCALE_LATE_STEPS:]))
        eval_ms = [(b - a) * 1e3 for a, b in evals]
        adc_ms = [(b - a) * 1e3 for a, b in events]
        reset_ms = [(b - a) * 1e3 for a, b in resets]
        # a reset runs after its iteration's step, before the next one starts
        reset_iters = [int(np.searchsorted(starts, a, side="right")) - 1 for a, _ in resets]
        adc = [(e["iter"], m.num_gaussians[e["iter"]], e["deleted"], e["cloned"],
                e["split"], e["alive"], e["cap_hit"]) for e in m.adc_events]
        rec_alive = {e["iter"]: e["alive"] for e in record["adc_events"]}
        print(f"[refscale] refscale_run.main: {n_iters} iterations of "
              f"{len(runner.data.images)} views at {cfg.synthetic_width}x"
              f"{cfg.synthetic_height}, {runner.data.xyz.shape[0]} ground-truth gaussians, "
              f"{cfg.synthetic_init_points} init points in {runner.state.alive.shape[0]} "
              f"slots: {run_s:.1f} s wall, the bench sample included ({smi})")
        print(f"[refscale] step under the runner: median {median_ms:.3f} ms between step "
              f"starts over {len(step_ms)} intervals, min {step_ms.min():.3f}, p90 "
              f"{np.percentile(step_ms, 90):.3f}, median of the last {REFSCALE_LATE_STEPS} "
              f"{late_ms:.3f}; ground truth "
              f"{runner.gt_seconds * 1e3 / len(runner.data.images):.3f} ms a view (host "
              f"clock; {smi})")
        print(f"[refscale] {len(adc_ms)} ADC events: median {np.median(adc_ms):.3f} ms, "
              f"max {max(adc_ms):.3f}, {sum(adc_ms) / 1e3:.2f} s in all; resets at "
              f"{reset_iters}: {', '.join(f'{x:.3f}' for x in reset_ms)} ms; evals "
              f"{np.median(eval_ms) / n_test:.3f} ms a view (median of {len(eval_ms)} evals "
              f"of {n_test} views) (host clock to an idle device; {smi})")
        print(f"[refscale] peak {runner.peak_splats} splats in a train step, truncated "
              f"{m.truncated_cells} cells in {m.truncated_steps} steps (JAX run: "
              f"{record['truncated_cells']} in {record['truncated_steps']}); peak device "
              f"memory {peak_mem / 2**30:.3f} GiB (max_memory_allocated; {smi})")
        print(f"[refscale] eval: iteration, seconds into refscale_run.main (host clock; "
              f"{smi}), test PSNR, SSIM | JAX run's PSNR, SSIM")
        for it, (a, _), p, q in zip(m.eval_iters, evals, m.test_psnr, m.test_ssim):
            j = record["eval_iters"].index(it) if it in record["eval_iters"] else None
            rec = (f"{record['test_psnr'][j]:.4f}, {record['test_ssim'][j]:.4f}"
                   if j is not None else "-")
            print(f"[refscale]   {it:5d}  {a - t0:7.1f}  {p:.4f}  {q:.4f} | {rec}")
        print("[refscale] ADC: iteration, alive before, deleted, cloned, split, alive "
              "after, cap_hit | JAX run's alive after")
        for it, before, d, c, sp, after, hit in adc:
            print(f"[refscale]   {it:5d}  {before:7d}  {d:6d}  {c:5d}  {sp:6d}  {after:7d}  "
                  f"{hit} | {rec_alive.get(it, '-')}")
        rec_deleted = {e["iter"]: e["deleted"] for e in record["adc_events"]}
        print("[refscale] deletes by reason (trainer.delete_reasons, from the state before "
              "the event): iteration, steps in the window, skipped, deleted, opacity, count "
              "0, uv norm 0 | had the window counted only its last k steps, count 0 + uv "
              f"norm 0, for k = {', '.join(map(str, REFSCALE_SHORT_WINDOWS))} | JAX run's "
              "deleted")
        skipped, prev = [], (-1, 0)
        for (it, _, d, *_), (_, row) in zip(adc, census):
            # the window: the steps after the last event up to this one's
            n_steps, taken = it - prev[0], row[-1] - prev[1]
            skipped.append(n_steps - taken)
            prev = (it, row[-1])
            short = "  ".join(f"{row[3 + 2 * j]}+{row[4 + 2 * j]}"
                              for j in range(len(REFSCALE_SHORT_WINDOWS)))
            print(f"[refscale]   {it:5d}  {n_steps:4d}  {skipped[-1]:4d}  {d:6d}  {row[0]:6d}  "
                  f"{row[1]:6d}  {row[2]:6d} | {short} | {rec_deleted.get(it, '-')}")
        print(f"[refscale] steps skipped (a loss or gradient not finite) in the ADC windows: "
              f"{sum(skipped)}")
        rec_peak = max(record["num_gaussians"])
        print(f"[refscale] alive: {m.num_gaussians[0]} at the start, peak "
              f"{max(m.num_gaussians)}, {n_alive} at the end (JAX run: "
              f"{record['num_gaussians'][0]}, {rec_peak}, {record['adc_events'][-1]['alive']})")
        max_psnr, final_psnr = max(m.test_psnr), m.test_psnr[-1]
        print(f"[refscale] test PSNR max {max_psnr:.4f} (floor {REFSCALE_MIN_MAX_PSNR}; JAX "
              f"run {max(record['test_psnr']):.4f}), at {n_iters} {final_psnr:.4f} (floor "
              f"{REFSCALE_MIN_FINAL_PSNR}; JAX run {record['test_psnr'][-1]:.4f}) ({smi})")

        # the checks: the record's schedule, the accounting, the floors
        if [a[0] for a in adc] != list(rec_alive):
            raise AssertionError(f"[refscale] ADC at {[a[0] for a in adc]}, the record's "
                                 f"at {list(rec_alive)}")
        if any(b - d + c + sp != a or hit for _, b, d, c, sp, a, hit in adc):
            raise AssertionError(f"[refscale] an ADC event's accounting or cap_hit: {adc}")
        if adc[-1][5] != n_alive:
            raise AssertionError(f"[refscale] {n_alive} alive, the last event left {adc[-1][5]}")
        if [(i, sum(row[:3])) for i, row in census] != [(a[0], a[2]) for a in adc]:
            raise AssertionError(f"[refscale] the deletes by reason {census} do not add up "
                                 f"to the events' {[(a[0], a[2]) for a in adc]}")
        if m.eval_iters != record["eval_iters"]:
            raise AssertionError(f"[refscale] evals at {m.eval_iters}, the record's at "
                                 f"{record['eval_iters']}")
        if reset_iters != REFSCALE_RESETS:
            raise AssertionError(f"[refscale] resets at {reset_iters}")
        if not (max_psnr >= REFSCALE_MIN_MAX_PSNR and final_psnr >= REFSCALE_MIN_FINAL_PSNR):
            raise AssertionError(f"[refscale] test PSNR under its floors: {m.test_psnr}")

        final = os.path.join(out, "ckpt_final.npz")
        state, it, _ = ckpt.load_checkpoint(final, cfg, device=DEVICE)
        if it != n_iters or not (torch.equal(state.alive, runner.state.alive) and all(
                torch.equal(state.params[k], v) for k, v in runner.state.params.items())):
            raise AssertionError("[refscale] ckpt_final.npz does not hold the final state")
        del state
        os.remove(final)
        ply = ckpt.import_ply(os.path.join(out, "scene_final.ply"), device="cpu")
        if ply.num_alive() != n_alive:
            raise AssertionError(f"[refscale] scene_final.ply has {ply.num_alive()} of "
                                 f"{n_alive}")
        del ply
        if not os.path.isfile(os.path.join(out, "trace", "trace.json")):
            raise AssertionError("[refscale] no torch.profiler trace")

        # the bench sample against the committed one (the JAX run's)
        with np.load(os.path.join(out, refscale_run.SAMPLE)) as z:
            got = {k: z[k] for k in z.files}
        with np.load(BENCH_SAMPLE) as z:
            want = {k: z[k] for k in z.files}
        qs = (0.01, 0.5, 0.99)

        def quantiles(x):
            return ", ".join(f"{v:.5f}" for v in np.quantile(x, qs))

        print(f"[refscale] bench sample: {got['xyz'].shape[0]} of n_alive "
              f"{int(got['n_alive'])} at iteration {int(got['iteration'])} (committed: "
              f"{want['xyz'].shape[0]} of {int(want['n_alive'])}); quantiles {qs} of the "
              f"log-scales {quantiles(got['scale'])} (committed {quantiles(want['scale'])}), "
              f"of nn {quantiles(got['nn'])} (committed {quantiles(want['nn'])})")
        layout = {k: (v.shape, v.dtype) for k, v in got.items()}
        if layout != {k: (v.shape, v.dtype) for k, v in want.items()} or not all(
                np.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"[refscale] bench sample {layout}")
        if (int(got["n_alive"]), int(got["iteration"])) != (n_alive, n_iters):
            raise AssertionError("[refscale] the bench sample is not of the final state")

        idx = int(runner.train_split[0])
        cam, pose = runner._camera(idx)
        kw = dict(config=cfg, camera_hw=(cam.height, cam.width),
                  n_sh_band=trainer.sh_band_for_iteration(cfg, n_iters))
        gt = runner.gt_image_dev(idx)
        bg = runner.background_for(n_iters - 1)
        busy_ms = profile_step(lambda: trainer.train_step(runner.state, gt, cam.K, pose,
                                                          bg, **kw), late_ms, "refscale")
        print(f"[refscale] device busy {busy_ms:.3f} ms in a step at the final state, "
              f"against the last {REFSCALE_LATE_STEPS} steps' median {late_ms:.3f} ms: host "
              f"share {1 - busy_ms / late_ms:.3f} ({smi})")
        del runner, gt, bg, cam, pose

        # resume from the periodic checkpoint, across the next ADC event
        path = os.path.join(out, f"ckpt_iter_{REFSCALE_CHECKPOINT}.npz")
        with np.load(path) as z:
            saved_alive = int(z["alive"].sum())
        telemetry.LAUNCHES.clear()
        t0 = time.perf_counter()
        runner = train_torch.main(refscale_run.train_argv(
            out2, DEVICE, num_iters=REFSCALE_RESUME_ITERS, load_checkpoint=True,
            checkpoint_path=path))
        resume_s = time.perf_counter() - t0
        launches = dict(telemetry.LAUNCHES)
        totals.update(launches)
        m = runner.metrics
        check_cli_run(runner, out2, launches, REFSCALE_CHECKPOINT, REFSCALE_RESUME_ITERS,
                      "refscale-resume")
        want_adc = [i for i in range(REFSCALE_CHECKPOINT, REFSCALE_RESUME_ITERS)
                    if scheduled_events(runner.config, i).adc]
        print(f"[refscale-resume] resumed at iteration {runner.start_iter} from "
              f"{saved_alive} gaussians, {len(m.train_psnr)} steps to "
              f"{REFSCALE_RESUME_ITERS}; ADC (iteration, alive) "
              f"{[(e['iter'], e['alive']) for e in m.adc_events]}; test PSNR at "
              f"{m.eval_iters}: {', '.join(f'{x:.4f}' for x in m.test_psnr)}; "
              f"{resume_s:.1f} s ({smi})")
        if m.num_gaussians[0] != saved_alive:
            raise AssertionError(f"[refscale-resume] started from {m.num_gaussians[0]} "
                                 f"gaussians, the checkpoint holds {saved_alive}")
        if [e["iter"] for e in m.adc_events] != want_adc or max(want_adc) <= runner.start_iter:
            raise AssertionError(f"[refscale-resume] ADC events {m.adc_events}")
        del runner
        for f in (path, os.path.join(out2, f"ckpt_iter_{REFSCALE_CHECKPOINT}.npz"),
                  os.path.join(out2, "ckpt_final.npz")):
            os.remove(f)
    return dict(totals)


# the "[capture]" phase: a COLMAP capture of garden's shape (SURVEY.md: 185
# images, 138,766 SfM points) made from the refscale7k synthetic scene (its
# 1,200,000 secret points, seed 0) seen from a ring of 185 views, its images
# PNGs at 1297x840 in images_4/ (an odd width, as a downsampled capture can
# have), trained through train_torch.py on the per-pixel SH path with the CLI
# phase's schedule (its trace window moved to a band-3 step), then its 24
# test views rendered through render_torch.py with depth
CAPTURE_VIEWS = 185
CAPTURE_POINTS = 138_766
CAPTURE_WIDTH, CAPTURE_HEIGHT = 1297, 840
CAPTURE_FOCAL = 1100.0
CAPTURE_DOWNSAMPLE = 4
CAPTURE_THREADS = 8
CAPTURE_PROFILE_START = 320
# the committed JPEG fixtures (tests/data_torch/jpeg/make_fixtures.py), held
# to their references (cv2's decodes) at the CPU test's tolerance
# (tests/test_torch_imageio.py: bitwise)
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data_torch", "jpeg")
JPEG_FIXTURE_NAMES = ("full_q95_420", "crop_444", "crop_422_restart", "crop_grey",
                      "crop_exif6")
JPEG_MAX_DIFF = 0
DECODE_REPS = 5


def rotation_to_qvec(R):
    """The wxyz quaternion (w >= 0) of a rotation matrix, the inverse of
    ``dataio.colmap.qvec_to_rotation``."""
    R = np.asarray(R, np.float64)
    q = np.zeros(4)
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q[:] = (0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def write_colmap_model(sparse, camera, qvecs, tvecs, names, xyz, rgb):
    """A COLMAP model in its binary format
    (https://colmap.github.io/format.html): cameras.bin with one PINHOLE
    camera, ``camera`` = (width, height, fx, fy, cx, cy); images.bin with
    image i + 1 at ``qvecs[i]``, ``tvecs[i]`` (world to camera) named
    ``names[i]``, without 2D points; points3D.bin with ``xyz``, uint8
    ``rgb``, error 0 and empty tracks."""
    import struct

    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        width, height, *params = camera
        f.write(struct.pack("<QiiQQ4d", 1, 1, 1, width, height, *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, (q, t, name) in enumerate(zip(qvecs, tvecs, names)):
            f.write(struct.pack("<i4d3di", i + 1, *q, *t, 1))
            f.write(name.encode() + b"\0" + struct.pack("<Q", 0))
    n = len(xyz)
    rec = np.zeros(n, dtype=[("id", "<i8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                             ("error", "<f8"), ("track", "<u8")])
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n) + rec.tobytes())


def write_capture(root, n_views, n_points, width, height, *, focal, secret_points,
                  seed=0, downsample=CAPTURE_DOWNSAMPLE, device, threads=CAPTURE_THREADS):
    """A COLMAP capture of the synthetic scene in ``root``:
    ``images_{downsample}/`` holds ``n_views`` PNGs of width x height, the
    renders of ``secret_points`` points of ``make_synthetic_scene_data``
    (seed ``seed``; at the runner's ground-truth opacity and raised scales,
    band 0, on black) from its ring of views, through the port's
    ``rasterize`` on ``device`` at the fields of runs/refscale7k/config.yaml,
    written by ``write_png`` from ``threads`` threads; ``sparse/0`` holds
    one PINHOLE camera at ``downsample`` times the size, focal length and
    principal point (width / 2, height / 2), the views' poses and
    ``n_points`` of the secret points, drawn by a generator seeded with
    ``seed``, with their uint8 colours.  Each view is rendered at its pose
    as ``ColmapDataset`` reads it back.  Returns the model's parts and the
    seconds to render and in all."""
    import concurrent.futures

    import torch

    from gaussian_splatting_torch.dataio import colmap
    from gaussian_splatting_torch.dataio.dataset import (
        create_scene,
        make_synthetic_scene_data,
    )
    from gaussian_splatting_torch.dataio.png import write_png
    from gaussian_splatting_torch.rasterize import rasterize
    from gaussian_splatting_torch.runner import GT_OPACITY, GT_SCALE_RAISE
    from gaussian_splatting_torch.structs import Camera

    t_start = time.perf_counter()
    cfg = refscale_config()
    data = make_synthetic_scene_data(secret_points, n_views, seed, width, height)
    names = [f"frame_{i:05d}.png" for i in range(n_views)]
    qvecs = np.stack([rotation_to_qvec(im.camera_T_world[:3, :3]) for im in data.images])
    tvecs = np.stack([im.camera_T_world[:3, 3].astype(np.float64) for im in data.images])
    sel = np.sort(np.random.default_rng(seed).choice(secret_points, n_points, replace=False))
    xyz = data.xyz[sel]
    rgb = (np.abs(np.sin(xyz * 3.0)) * 255).astype(np.uint8)  # the scene's colours
    cx, cy, s = width / 2, height / 2, downsample
    camera = (s * width, s * height, s * focal, s * focal, s * cx, s * cy)
    write_colmap_model(os.path.join(root, "sparse", "0"), camera, qvecs, tvecs, names,
                       xyz.astype(np.float64), rgb)

    secret = create_scene(data, cfg, secret_points, device)
    params = {k: v.detach() for k, v in secret.params().items()}
    params["opacity"] = torch.full_like(params["opacity"], GT_OPACITY)
    params["scale"] = params["scale"] + torch.tensor(
        np.random.default_rng(seed + 1).uniform(*GT_SCALE_RAISE, params["scale"].shape),
        dtype=torch.float32, device=device)
    K = torch.tensor([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], dtype=torch.float32,
                     device=device)
    cam = Camera(K=K, width=width, height=height)
    black = torch.zeros(3, dtype=torch.float32, device=device)
    img_dir = os.path.join(root, f"images_{downsample}")
    os.makedirs(img_dir)
    render_s = 0.0
    with concurrent.futures.ThreadPoolExecutor(threads) as pool, torch.no_grad():
        writes = []
        for q, t, name in zip(qvecs, tvecs, names):
            t0 = time.perf_counter()
            pose = np.eye(4, dtype=np.float32)  # as ColmapDataset builds it
            pose[:3, :3] = colmap.qvec_to_rotation(q)
            pose[:3, 3] = t
            res = rasterize(params, secret.alive, torch.tensor(pose, device=device), cam,
                            near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                            cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist,
                            background_rgb=black, n_sh_band=0)
            img = (res.image.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            render_s += time.perf_counter() - t0
            writes.append(pool.submit(write_png, os.path.join(img_dir, name), img))
        for w in writes:
            w.result()
    return dict(camera=camera, qvecs=qvecs, tvecs=tvecs, names=names, xyz=xyz, rgb=rgb,
                render_s=render_s, total_s=time.perf_counter() - t_start)


@contextlib.contextmanager
def without_image_packages():
    """Hide OpenCV and Pillow while the block runs, so only the port's own
    decoders can read an image."""
    saved = {name: sys.modules.get(name) for name in ("cv2", "PIL")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def check_decoders(smi):
    """The decoders on this machine: their build, the committed JPEG
    fixtures against their references, and the decode times of the
    full-size fixture."""
    from gaussian_splatting_torch.dataio import dataset, native
    from gaussian_splatting_torch.dataio.jpeg import read_jpeg
    from gaussian_splatting_torch.dataio.png import read_png

    cached = native.library_path("image_decode").exists()
    t0 = time.perf_counter()
    native.decoders()
    print(f"[capture] image decoders {native.library_path('image_decode').name}: "
          + ("loaded from _build_cache" if cached else "built by g++ and loaded")
          + f" in {time.perf_counter() - t0:.2f} s")
    for name in JPEG_FIXTURE_NAMES:
        jpg = os.path.join(JPEG_FIXTURES, f"{name}.jpg")
        got = dataset.read_rgb(jpg)
        decoders = [dataset.last_decoder]
        ref = dataset.read_rgb(jpg[:-4] + ".png")
        decoders.append(dataset.last_decoder)
        if decoders != ["jpeg", "png"]:
            raise AssertionError(f"[capture] {name}: decoded by {decoders}, not the port's")
        if got.shape != ref.shape:
            raise AssertionError(f"[capture] {name}: {got.shape} against {ref.shape}")
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        print(f"[capture] fixture {name}.jpg {got.shape[1]}x{got.shape[0]}: read_jpeg "
              f"against cv2's decode max |diff| {d.max()}, mean {d.mean():.6f} "
              f"(tolerance {JPEG_MAX_DIFF}); decoders {decoders}")
        if d.max() > JPEG_MAX_DIFF:
            raise AssertionError(f"[capture] {name}: read_jpeg differs from cv2's decode")
    full = os.path.join(JPEG_FIXTURES, "full_q95_420.jpg")
    times = {}
    for label, fn, path in (("read_jpeg", read_jpeg, full),
                            ("read_png", read_png, full[:-4] + ".png")):
        ms = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            fn(path)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[label] = statistics.median(ms)
    print(f"[capture] decode of the 1296x840 fixture: read_jpeg {times['read_jpeg']:.3f} ms, "
          f"read_png {times['read_png']:.3f} ms (host clock, median of {DECODE_REPS}; {smi})")
    return times


def expected_capture_launches(runner, out):
    """The launches a per-pixel run's schedule implies, by kernel and, for
    B3/B4, by n_sh: each step renders and differentiates at its SH band and
    takes one Adam step, each eval renders the test views and each debug
    image one view; band 0 stays on the DC path (B1, B2), bands 1-3 take
    B3, B4 at n_sh 4, 9, 16."""
    from gaussian_splatting_torch import trainer

    cfg, m = runner.config, runner.metrics
    want = collections.Counter()

    def render(iteration, n, backward):
        band = trainer.sh_band_for_iteration(cfg, iteration)
        keys = (("render_fwd", "render_bwd") if band == 0 else
                (("render_sh_fwd", (band + 1) ** 2), ("render_sh_bwd", (band + 1) ** 2)))
        want[keys[0]] += n
        if backward:
            want[keys[1]] += n

    for i in range(runner.start_iter, cfg.num_iters):
        render(i, 1, True)
        want["adam_step"] += 1
    for it in m.eval_iters:
        render(it, len(runner.test_split), False)
    for f in os.listdir(out):
        if f.startswith("debug_iter"):
            render(int(f[len("debug_iter"):-len(".png")]), 1, False)
    return want


def capture_phase(smi):
    """The "[capture]" phase: the decoders, the capture written, trained
    through train_torch.main on the per-pixel SH path and its test views
    rendered through render_torch.main, with cv2 and Pillow hidden.
    Returns the phase's launches by kernel."""
    import torch

    import render_torch
    import train_torch
    from gaussian_splatting_torch import telemetry, trainer
    from gaussian_splatting_torch import checkpoint as ckpt
    from gaussian_splatting_torch.dataio import dataset
    from gaussian_splatting_torch.dataio.png import read_png
    from gaussian_splatting_torch.ops import render_sh
    from gaussian_splatting_torch.runner import TrainingRunner, derive_capacity

    totals = collections.Counter()
    with without_image_packages(), tempfile.TemporaryDirectory() as tmp:
        check_decoders(smi)

        # the capture
        root = os.path.join(tmp, "capture")
        secret = refscale_config().synthetic_points
        cap = write_capture(root, CAPTURE_VIEWS, CAPTURE_POINTS, CAPTURE_WIDTH,
                            CAPTURE_HEIGHT, focal=CAPTURE_FOCAL, secret_points=secret,
                            device=DEVICE)
        print(f"[capture] {CAPTURE_VIEWS} views of {secret} secret points at "
              f"{CAPTURE_WIDTH}x{CAPTURE_HEIGHT} (images_{CAPTURE_DOWNSAMPLE}/, PNG) and "
              f"{CAPTURE_POINTS} SfM points written: {cap['render_s']:.1f} s rendering, "
              f"{cap['total_s']:.1f} s in all with {CAPTURE_THREADS} writer threads ({smi})")

        # train it through the CLI on the per-pixel SH path
        out = os.path.join(tmp, "run")
        steps, evals, events, decodes, decoders = [], [], [], [], []
        by_n_sh = collections.Counter()

        def count(name):
            return lambda feat, basis, *a, **k: by_n_sh.update([(name, basis.shape[0])])

        torch.cuda.reset_peak_memory_stats()
        telemetry.LAUNCHES.clear()
        t0 = time.perf_counter()
        with call_times(trainer, "train_step", steps, sync=False), \
                call_times(TrainingRunner, "evaluate", evals, sync=True), \
                call_times(TrainingRunner, "_densify", events, sync=True), \
                call_times(dataset, "read_rgb", decodes, sync=False,
                           after=lambda *a: decoders.append(dataset.last_decoder)), \
                call_times(render_sh, "render_sh_fwd_cuda", [], False, count("render_sh_fwd")), \
                call_times(render_sh, "render_sh_bwd_cuda", [], False, count("render_sh_bwd")):
            runner = train_torch.main(cli_argv(
                out, preset="7k", dataset_path=root, downsample_factor=CAPTURE_DOWNSAMPLE,
                use_sh_precompute=False,
                **dict(CLI_SCHEDULE, profile_start=CAPTURE_PROFILE_START)))
        run_s = time.perf_counter() - t0
        launches = dict(telemetry.LAUNCHES)
        totals.update(launches)
        peak_mem = torch.cuda.max_memory_allocated()
        cfg, m = runner.config, runner.metrics
        n_views, n_test = len(runner.data.images), len(runner.test_split)
        n_alive = int(runner.state.alive.sum())

        unsplit = ("render_fwd", "render_bwd", "adam_step", "geometry_fwd", "geometry_bwd",
                   "layout_count", "layout_fill")
        got = collections.Counter({k: v for k, v in launches.items() if k in unsplit})
        got.update(by_n_sh)
        want = with_geometry(expected_capture_launches(runner, out))
        print(f"[capture] launches {launches}; B3/B4 by n_sh "
              f"{dict(sorted(by_n_sh.items()))}")
        if got != want or set(launches) - {"render_sh_fwd", "render_sh_bwd", *unsplit}:
            raise AssertionError(f"[capture] expected launches {dict(want)}, got {dict(got)}")
        if {n for (_, n) in by_n_sh} != {4, 9, 16}:
            raise AssertionError(f"[capture] B3/B4 not at n_sh 4, 9 and 16: {by_n_sh}")
        n_test_want = -(-CAPTURE_VIEWS // cfg.test_split_ratio)  # every 8th: 24 of 185
        if (n_views, n_test, len(runner.train_split)) != (
                CAPTURE_VIEWS, n_test_want, CAPTURE_VIEWS - n_test_want):
            raise AssertionError(f"[capture] {n_views} views, {n_test} for test")
        slots = derive_capacity(CAPTURE_POINTS, cfg)  # 2,097,152 for 138,766
        if runner.state.alive.shape[0] != slots or m.num_gaussians[0] != CAPTURE_POINTS:
            raise AssertionError(f"[capture] {m.num_gaussians[0]} points in "
                                 f"{runner.state.alive.shape[0]} slots")
        if len(m.train_psnr) != CLI_ITERS or m.eval_iters != [0, CLI_CHECKPOINT, CLI_ITERS]:
            raise AssertionError(f"[capture] {len(m.train_psnr)} steps, evals {m.eval_iters}")
        for k, v in runner.state.params.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"[capture] params['{k}'] not finite")
        if not all(np.isfinite(m.train_psnr + m.test_psnr)):
            raise AssertionError("[capture] a PSNR is not finite")
        # each event's accounting, alive = before - deleted + cloned + split
        # (a split's second sample takes a free slot), and a scene that grows
        # from its SfM points: an event may delete more than it adds
        adc = [(e["iter"], m.num_gaussians[e["iter"]], e["deleted"], e["cloned"],
                e["split"], e["alive"]) for e in m.adc_events]
        if ([a[0] for a in adc] != CLI_ADC_ITERS
                or any(b - d + c + sp != a for _, b, d, c, sp, a in adc)
                or not (adc[0][-1] > CAPTURE_POINTS and n_alive > CAPTURE_POINTS)):
            raise AssertionError(f"[capture] ADC (iteration, alive before, deleted, "
                                 f"cloned, split, alive after) {adc}, {n_alive} at the end")
        if not m.test_psnr[1] > m.test_psnr[0]:
            raise AssertionError(f"[capture] test PSNR did not rise: {m.test_psnr}")
        with open(os.path.join(out, "metrics.json")) as f:
            saved = json.load(f)
        if saved["eval_iters"] != m.eval_iters or saved["test_psnr"] != m.test_psnr:
            raise AssertionError("[capture] metrics.json does not hold the run's metrics")
        state, it, _ = ckpt.load_checkpoint(os.path.join(out, "ckpt_final.npz"), cfg,
                                            device=DEVICE)
        if it != CLI_ITERS or not torch.equal(state.alive, runner.state.alive):
            raise AssertionError("[capture] ckpt_final.npz does not hold the final state")
        del state
        ply = ckpt.import_ply(os.path.join(out, "scene_final.ply"), device="cpu")
        if ply.num_alive() != n_alive:
            raise AssertionError(f"[capture] scene_final.ply has {ply.num_alive()} of {n_alive}")
        del ply
        # every image decoded once by the port's PNG decoder: the first for the
        # image size, then each as a step or an eval first uses it
        if set(decoders) != {"png"} or len(decodes) != 1 + len(runner._gt_dev):
            raise AssertionError(f"[capture] {len(decodes)} decodes by {set(decoders)} for "
                                 f"{len(runner._gt_dev)} staged images")

        starts = [a for a, _ in steps]
        step_ms = np.diff(starts) * 1e3
        median_ms = float(np.median(step_ms))
        decoded = np.searchsorted(starts, [a for a, _ in decodes], side="right") - 1
        in_steps = sorted({int(k) for k in decoded if 0 <= k < len(starts) - 1})
        plain = np.delete(step_ms, in_steps)
        decode_s = sum(b - a for a, b in decodes)
        eval_ms = [(b - a) * 1e3 for a, b in evals]
        print(f"[capture] train_torch.main 7k --dataset_path (capture) --downsample_factor "
              f"{CAPTURE_DOWNSAMPLE} --use_sh_precompute false: {CLI_ITERS} iterations of "
              f"{len(runner.train_split)} training views ({n_test} test), "
              f"{CAPTURE_POINTS} points in {runner.state.alive.shape[0]} slots, "
              f"{run_s:.1f} s ({smi})")
        print(f"[capture] step under the runner: median {median_ms:.3f} ms between step "
              f"starts over {len(step_ms)} intervals, p90 {np.percentile(step_ms, 90):.3f}; "
              f"{len(in_steps)} steps decoded an image (median without them "
              f"{np.median(plain):.3f} ms); {len(decodes)} decodes in "
              f"{decode_s:.2f} s, {decode_s * 1e3 / len(decodes):.3f} ms an image "
              f"(host clock; {smi})")
        print(f"[capture] ADC (iteration, alive before, deleted, cloned, split, alive "
              f"after): {adc}; {n_alive} alive at the end")
        print(f"[capture] evals at {m.eval_iters}: {', '.join(f'{x:.3f}' for x in eval_ms)} "
              f"ms for {n_test} views, {np.median(eval_ms) / n_test:.3f} ms per view "
              f"(host clock; the first decodes the test images; {smi})")
        print(f"[capture] test PSNR at {m.eval_iters}: "
              f"{', '.join(f'{x:.4f}' for x in m.test_psnr)}; SSIM "
              f"{', '.join(f'{x:.4f}' for x in m.test_ssim)} ({smi})")
        print(f"[capture] peak {runner.peak_splats} splats in a train step; peak device "
              f"memory {peak_mem / 2**30:.3f} GiB (max_memory_allocated; {smi})")
        idx = int(runner.train_split[0])
        cam, pose = runner._camera(idx)
        kw = dict(config=cfg, camera_hw=(cam.height, cam.width),
                  n_sh_band=trainer.sh_band_for_iteration(cfg, CLI_ITERS))
        gt = runner.gt_image_dev(idx)
        bg = runner.background_for(CLI_ITERS - 1)
        busy_ms = profile_step(lambda: trainer.train_step(runner.state, gt, cam.K, pose,
                                                          bg, **kw), median_ms, "capture")
        print(f"[capture] device busy {busy_ms:.3f} ms of the {median_ms:.3f} ms step: "
              f"host share {1 - busy_ms / median_ms:.3f} ({smi})")
        test = [int(i) for i in runner.test_split]
        del runner, gt, bg, cam, pose

        # the test views through render_torch, from a model that lists only them
        root2 = os.path.join(tmp, "capture_test")
        write_colmap_model(os.path.join(root2, "sparse", "0"), cap["camera"],
                           cap["qvecs"][test], cap["tvecs"][test],
                           [cap["names"][i] for i in test], cap["xyz"], cap["rgb"])
        images = f"images_{CAPTURE_DOWNSAMPLE}"
        os.symlink(os.path.join(root, images), os.path.join(root2, images))
        renders = os.path.join(tmp, "renders")
        telemetry.LAUNCHES.clear()
        t0 = time.perf_counter()
        views = render_torch.main([
            os.path.join(out, "ckpt_final.npz"), "--dataset_path", root2,
            "--downsample_factor", str(CAPTURE_DOWNSAMPLE), "--depth", "--out", renders,
            "--device", DEVICE])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        launches = dict(telemetry.LAUNCHES)
        totals.update(launches)
        pngs = sorted(os.listdir(renders))
        print(f"[capture] render_torch.main --dataset_path (the {len(test)} test views) "
              f"--depth: launches {launches}, {len(pngs)} PNGs, {render_s:.1f} s, "
              f"{render_s * 1e3 / len(test):.3f} ms a view with the checkpoint's load "
              f"and both PNGs ({smi})")
        if launches != with_geometry({"render_fwd": len(test), "depth_fwd": len(test)}):
            raise AssertionError(f"[capture] render_torch launches {launches}")
        if len(pngs) != 2 * len(test) or len(views) != len(test):
            raise AssertionError(f"[capture] {len(views)} views, {len(pngs)} PNGs")
        psnrs = []
        for j, v in enumerate(views):
            img = (v["image"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            if img.shape != (CAPTURE_HEIGHT, CAPTURE_WIDTH, 3):
                raise AssertionError(f"[capture] {v['name']}: shape {img.shape}")
            if not np.array_equal(read_png(os.path.join(renders, f"{v['name']}.png")), img):
                raise AssertionError(f"[capture] {v['name']}.png is not the returned image")
            dn = v["depth"].cpu().numpy()
            dimg = (np.where(dn < 0, 0, dn / max(float(dn.max()), 1e-6)) * 255).astype(np.uint8)
            back = read_png(os.path.join(renders, f"{v['name']}_depth.png"))
            if not (np.array_equal(back[..., 0], dimg) and (dn > 0).any()):
                raise AssertionError(f"[capture] {v['name']}_depth.png is not the depth")
            want_img = read_png(os.path.join(root, images, cap["names"][test[j]]))
            mse = np.mean((img / 255.0 - want_img / 255.0) ** 2)
            psnrs.append(float(-10 * np.log10(max(mse, 1e-12))))
        print(f"[capture] renders against the capture's test images (precomputed SH, "
              f"not the per-pixel path trained): median PSNR {np.median(psnrs):.4f}, "
              f"min {min(psnrs):.4f}, max {max(psnrs):.4f} ({smi})")
    return dict(totals)


# the multi-GPU phase (gaussian_splatting_torch/parallel): the garden scene
# padded to an even capacity for the comparisons, and the training CLI on
# the reference-scale scene with --model_parallel 2 (ADC at 50 and 100,
# evals at 0 and the end, a checkpoint at 100) and --data_parallel 2 (ADC
# at 30).  The card is one: ranks share it over gloo (parallel/comm.py)
MGPU_CAPACITY = 65_536
MGPU_CHECKPOINT = 100
MGPU_SCHEDULE = dict(
    test_eval_interval=1000, print_interval=50, adaptive_control_start=0,
    reset_opacity_start=1000, add_sh_band_interval=1000, save_debug_image_interval=0,
    profile_steps=0)
MGPU_RUNS = {
    "mp": dict(MGPU_SCHEDULE, num_iters=150, model_parallel=2, adaptive_control_interval=50,
               adaptive_control_end=101, checkpoint_interval=MGPU_CHECKPOINT),
    "dp": dict(MGPU_SCHEDULE, num_iters=60, data_parallel=2, adaptive_control_interval=30,
               adaptive_control_end=31, checkpoint_interval=0),
}
MGPU_ADC_ITERS = {"mp": [50, 100], "dp": [30]}
# steps each rank takes after (d) and (e) with its collectives timed
MGPU_COLL_STEPS = 3


def _rel(got, want):
    """Largest |got - want| over the largest |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else float(got.abs().max())


def _step_errors(got, want, info, winfo):
    """A parallel step's state against the single-device step's: the
    gradient leaves (Adam's first and second moments from zero, the uv and
    xyz accumulators) relative to each leaf's largest entry, and the exact
    leaves."""
    import torch

    errs = {f"mu.{k}": _rel(got.opt_state.mu[k], v) for k, v in want.opt_state.mu.items()}
    errs.update({f"nu.{k}": _rel(got.opt_state.nu[k], v) for k, v in want.opt_state.nu.items()})
    errs["uv_grad_accum"] = _rel(got.uv_grad_accum, want.uv_grad_accum)
    errs["xyz_grad_accum"] = _rel(got.xyz_grad_accum, want.xyz_grad_accum)
    exact = (torch.equal(got.alive, want.alive)
             and torch.equal(got.grad_accum_count, want.grad_accum_count)
             and int(got.opt_state.count) == int(want.opt_state.count) == 1)
    loss = abs(float(info["loss"]) - float(winfo["loss"])) / abs(float(winfo["loss"]))
    return dict(max_rel=max(errs.values()), worst=max(errs, key=errs.get), exact=exact,
                loss_rel=loss)


def _mgpu_scene(dev, views):
    """The garden scene in MGPU_CAPACITY slots, uint8 targets of ``views``
    orbit views rendered from it on black, then the training phases'
    perturbation of colour and opacity."""
    import torch

    import render_torch
    from gaussian_splatting_torch import checkpoint as ckpt
    from gaussian_splatting_torch.rasterize import rasterize
    from gaussian_splatting_torch.structs import Camera

    scene = ckpt.import_ply(SCENE, device=dev, capacity=MGPU_CAPACITY)
    xyz = scene.xyz[scene.alive].detach().cpu().numpy()
    poses = [torch.from_numpy(p).to(dev) for p in render_torch.orbit_poses(xyz, N_VIEWS)]
    K = torch.tensor([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    cam = Camera(K, WIDTH, HEIGHT)
    black = torch.zeros(3, device=dev)
    params = {k: v.detach() for k, v in scene.params().items()}
    with torch.no_grad():
        gts = [(rasterize(params, scene.alive, poses[v], cam, background_rgb=black,
                          n_sh_band=SH_BAND, **_scene_kw()).image.clamp(0, 1) * 255)
               .round().to(torch.uint8) for v in range(views)]
        perturb(scene, int(scene.alive.sum()))
    return scene, cam, poses, gts, black


def _scene_kw():
    from gaussian_splatting_torch.config import SplatConfig

    cfg = SplatConfig()
    return dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist)


def _mgpu_nccl_rank():
    """(a) One rank on cuda:0 over NCCL: mp_train_step and dp_train_step
    against trainer.train_step on garden view 0."""
    import torch

    from gaussian_splatting_torch import telemetry, trainer
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.parallel import comm, gsharded
    from gaussian_splatting_torch.parallel import mesh as pmesh

    dev = torch.device(DEVICE)
    scene, cam, poses, gts, black = _mgpu_scene(dev, 1)
    cfg = SplatConfig()
    kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
    state = trainer.init_train_state(scene, cfg)
    want, winfo = trainer.train_step(state, gts[0], cam.K, poses[0], black, **kw)
    launches = collections.Counter()
    out = {}
    for name, make, step in (("mp_train_step", comm.make_model_mesh, gsharded.mp_train_step),
                             ("dp_train_step", comm.make_mesh, pmesh.dp_train_step)):
        mesh = make(device_type="cuda")
        telemetry.LAUNCHES.clear()
        got, info = step(state, gts[0], cam.K, poses[0], black, mesh=mesh, **kw)
        launches.update(telemetry.LAUNCHES)
        out[name] = _step_errors(got, want, info, winfo)
    return dict(out, backend=torch.distributed.get_backend(), launches=dict(launches))


def _mgpu_pair_rank():
    """(b) Two ranks sharing the card over gloo: mp_render against rasterize
    on both colour paths, mp_train_step against trainer.train_step on both,
    dp_train_step (rank r on view r) against the mean of the two views'
    gradients taken in one process."""
    import torch

    from gaussian_splatting_torch import telemetry, trainer
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.parallel import comm, gsharded
    from gaussian_splatting_torch.parallel import mesh as pmesh
    from gaussian_splatting_torch.rasterize import rasterize

    rank = torch.distributed.get_rank()
    dev = comm.rank_device("cuda", rank)
    scene, cam, poses, gts, black = _mgpu_scene(dev, 2)
    state = trainer.init_train_state(scene, SplatConfig())
    mesh = comm.make_model_mesh(device_type="cuda")
    shard = gsharded.shard_state(state, mesh.model_rank, mesh.mp)
    launches = collections.Counter()
    out = {"backend": mesh.backend}
    bg = torch.full((3,), 0.25, device=dev)
    for path, pre in (("dc", True), ("per_pixel", False)):
        cfg = SplatConfig(use_sh_precompute=pre)
        kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
        with torch.no_grad():
            want = rasterize(state.params, state.alive, poses[0], cam, background_rgb=bg,
                             n_sh_band=SH_BAND, use_sh_precompute=pre, **_scene_kw())
            telemetry.LAUNCHES.clear()
            img, vis, info = gsharded.mp_render(
                shard.params, shard.alive, poses[0], cam.K, background_rgb=bg,
                mesh=mesh, **kw)
            launches.update(telemetry.LAUNCHES)
        out[f"render_{path}"] = dict(
            err=float((img - want.image).abs().max()), splats=int(info["num_splats"]),
            want_splats=want.num_splats,
            visible_ok=bool(torch.equal(vis, want.visible.chunk(mesh.mp)[mesh.model_rank])))
        ref, rinfo = trainer.train_step(state, gts[0], cam.K, poses[0], bg, **kw)
        telemetry.LAUNCHES.clear()
        got, ginfo = gsharded.mp_train_step(shard, gts[0], cam.K, poses[0], bg,
                                            mesh=mesh, **kw)
        launches.update(telemetry.LAUNCHES)
        out[f"step_{path}"] = _step_errors(gsharded.gather_state(got, mesh), ref, ginfo, rinfo)

    # data parallelism: the mean of the two views' gradients in one process
    cfg = SplatConfig()
    kw = dict(config=cfg, camera_hw=(HEIGHT, WIDTH), n_sh_band=SH_BAND)
    dmesh = comm.make_mesh(device_type="cuda")
    telemetry.LAUNCHES.clear()
    got, ginfo = pmesh.dp_train_step(state, gts[rank], cam.K, poses[rank], bg,
                                     mesh=dmesh, **kw)
    launches.update(telemetry.LAUNCHES)
    runs = [trainer.camera_loss(state, gts[v], cam.K, poses[v], bg, **kw) for v in range(2)]
    grads = {k: (runs[0][2][k] + runs[1][2][k]) / 2 for k in runs[0][2]}
    loss = (runs[0][0] + runs[1][0]) / 2
    ok = trainer.step_ok(loss, grads)
    want = trainer.adam_step(state, grads, ok, cfg)
    uv = sum(trainer.uv_grad_rows(r[3], cam.K, r[1][1].visible) for r in runs)
    seen = sum(r[1][1].visible.to(torch.int32) for r in runs)
    want = trainer.accumulate(want, uv, grads["xyz"].abs(), seen, ok)
    out["step_dp"] = _step_errors(got, want, ginfo, dict(loss=loss.detach()))
    out["launches"] = dict(launches)

    # gloo's all-gather of CUDA tensors at the size of (d)'s feature bundle
    # (11 rows of 1,048,576 slots a rank, 92 MB gathered)
    x = torch.ones(11 << 20, device=dev)
    out["gather_ms"] = []
    for _ in range(3):
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        comm.gather(x, 0, mesh.model_group)
        torch.cuda.synchronize(dev)
        out["gather_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _checksums(state):
    """sha256 of every tensor of a TrainState, by leaf."""
    import hashlib

    from gaussian_splatting_torch import trainer

    sums = {}

    def add(x):
        sums[len(sums)] = hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()
        return x

    trainer.map_state(add, state)
    return sums


@contextlib.contextmanager
def collective_times(times):
    """Record in ``times`` the host-clock seconds of every collective of
    parallel/comm.py made inside the block, with the device synchronised
    before and after each: the collective's own time and its wait for the
    peers."""
    import torch

    from gaussian_splatting_torch.parallel import comm

    def timed(fn):
        def collective(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return collective

    names = ("gather", "reduce_scatter", "all_reduce", "broadcast")
    plain = {n: getattr(comm, n) for n in names}
    for n in names:
        setattr(comm, n, timed(plain[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(comm, n, plain[n])


def _mgpu_cli_rank(argv, out, iters, tag):
    """(d), (e) One rank of train_torch.main(argv): check_cli_run on its
    runner, its step times, launches and peak memory, the state it
    checkpointed at MGPU_CHECKPOINT against the file read back, checksums
    of its state after each ADC event and at the end; then, after the run,
    one profiled step (device busy) and MGPU_COLL_STEPS steps with every
    collective timed."""
    import torch

    import train_torch
    from gaussian_splatting_torch import telemetry, trainer
    from gaussian_splatting_torch import checkpoint as ckpt
    from gaussian_splatting_torch.parallel import gsharded
    from gaussian_splatting_torch.parallel import mesh as pmesh
    from gaussian_splatting_torch.runner import TrainingRunner

    steps, events, saved, sums = [], [], {}, {"adc": []}

    def keep_checkpoint(runner, path, iteration, ply=None):
        if iteration == MGPU_CHECKPOINT:
            saved[path] = trainer.map_state(lambda x: x.detach().cpu(), runner.state)

    torch.cuda.reset_peak_memory_stats()
    telemetry.LAUNCHES.clear()
    with call_times(pmesh, "dp_train_step", steps, sync=False), \
            call_times(gsharded, "dp_mp_train_step", steps, sync=False), \
            call_times(TrainingRunner, "_densify", events, sync=True,
                       after=lambda runner, i: sums["adc"].append(_checksums(runner.state))), \
            call_times(TrainingRunner, "_save_checkpoint", [], sync=False,
                       after=keep_checkpoint):
        runner = train_torch.main(argv)
    launches = dict(telemetry.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    torch.distributed.barrier()  # rank 0 has written the run's files
    check_cli_run(runner, out, launches, 0, iters, f"{tag} rank {runner.mesh.rank}")
    mesh, m = runner.mesh, runner.metrics
    step_ms = float(np.median(np.diff([a for a, _ in steps])) * 1e3)
    sums["end"] = _checksums(runner.state)

    ckpt_ok = None
    for path, state in saved.items():
        full, it, _ = ckpt.load_checkpoint(path, runner.config, device="cpu")
        if mesh.mp > 1:
            full = gsharded.shard_state(full, mesh.model_rank, mesh.mp)
        ckpt_ok = it == MGPU_CHECKPOINT and all(
            torch.equal(a, b) for a, b in zip(_checksum_leaves(full), _checksum_leaves(state)))

    # after the run, so that its step times carry no instrumentation
    idx = int(runner.train_split[0])
    cam, pose = runner._camera(idx)
    step = pmesh.dp_train_step if mesh.mp == 1 else gsharded.dp_mp_train_step
    kw = dict(config=runner.config, camera_hw=(cam.height, cam.width), n_sh_band=0,
              mesh=mesh)
    gt, bg = runner.gt_image_dev(idx), runner.background_for(0)

    def one_step():
        step(runner.state, gt, cam.K, pose, bg, **kw)

    busy_ms = profile_step(one_step, step_ms, f"{tag} rank {mesh.rank}")
    coll = []
    with collective_times(coll):
        for _ in range(MGPU_COLL_STEPS):
            one_step()
    return dict(rank=mesh.rank, backend=mesh.backend, launches=launches, steps=len(steps),
                step_ms=step_ms, coll_ms=sum(coll) * 1e3 / MGPU_COLL_STEPS,
                coll_calls=len(coll) // MGPU_COLL_STEPS, busy_ms=busy_ms,
                peak_gib=peak / 2**30, metrics=m.to_dict(),
                n_alive=int(runner.state.alive.sum()), ckpt_ok=ckpt_ok, sums=sums,
                gt_ms=runner.gt_seconds * 1e3 / len(runner.data.images),
                capacity=runner.state.alive.shape[0])


def _checksum_leaves(state):
    from gaussian_splatting_torch import trainer

    leaves = []
    trainer.map_state(lambda x: leaves.append(x) or x, state)
    return leaves


def _check_step(tag, errs):
    print(f"[mgpu] {tag}: gradient leaves within {errs['max_rel']:.3e} of the largest "
          f"entry ({errs['worst']}), loss {errs['loss_rel']:.2e} relative, counts and "
          f"masks {'equal' if errs['exact'] else 'DIFFER'}")
    if not (errs["max_rel"] <= BWD_REL_TOL and errs["exact"] and errs["loss_rel"] < 1e-6):
        raise AssertionError(f"[mgpu] {tag}: {errs}")


def mgpu_cli_run(kind, smi, out):
    """(d) or (e): train_torch.main on the synthetic reference-scale scene
    with the MGPU_RUNS[kind] schedule on two ranks sharing the card; its
    checks and numbers.  Returns the launches summed over the ranks."""
    from gaussian_splatting_torch.parallel import comm

    sched = MGPU_RUNS[kind]
    tag = f"mgpu-{kind}"
    iters = sched["num_iters"]
    t0 = time.perf_counter()
    ranks = comm.launch(_mgpu_cli_rank, 2, cli_argv(out, **sched), out, iters, tag,
                        device_type="cuda")
    run_s = time.perf_counter() - t0
    total = collections.Counter()
    for r in ranks:
        total.update(r["launches"])
        print(f"[{tag}] rank {r['rank']} ({r['backend']}): {r['steps']} steps, launches "
              f"{r['launches']}; step {r['step_ms']:.3f} ms median between step starts "
              f"(host clock, no instrumentation), collectives {r['coll_ms']:.3f} ms a step "
              f"in {r['coll_calls']} calls (a sync before and after each, over "
              f"{MGPU_COLL_STEPS} steps after the run), device busy {r['busy_ms']:.3f} ms "
              f"in one profiled step, peak memory {r['peak_gib']:.3f} GiB, ground truth "
              f"{r['gt_ms']:.3f} ms a view; {r['capacity']} slots a rank ({smi})")
        if r["steps"] != iters:
            raise AssertionError(f"[{tag}] rank {r['rank']}: {r['steps']} steps")
        if [e["iter"] for e in r["metrics"]["adc_events"]] != MGPU_ADC_ITERS[kind]:
            raise AssertionError(f"[{tag}] ADC events {r['metrics']['adc_events']}")
    m0 = ranks[0]["metrics"]
    alive = [e["alive"] for e in m0["adc_events"]]
    n_alive = sum(r["n_alive"] for r in ranks) if kind == "mp" else ranks[0]["n_alive"]
    print(f"[{tag}] {iters} iterations in {run_s:.1f} s; ADC at {MGPU_ADC_ITERS[kind]}: "
          f"alive {alive}, {n_alive} at the end; test PSNR at {m0['eval_iters']}: "
          f"{', '.join(f'{x:.4f}' for x in m0['test_psnr'])} ({smi})")
    if not m0["test_psnr"][-1] > m0["test_psnr"][0]:
        raise AssertionError(f"[{tag}] test PSNR did not rise: {m0['test_psnr']}")
    if alive[-1] != n_alive:
        raise AssertionError(f"[{tag}] {n_alive} alive, the last event left {alive[-1]}")
    names = sorted(os.listdir(out))
    want_files = {"config.yaml", "metrics.json", "ckpt_final.npz", "scene_final.ply"}
    if kind == "mp":
        want_files.add(f"ckpt_iter_{MGPU_CHECKPOINT}.npz")
        if not all(r["ckpt_ok"] for r in ranks):
            raise AssertionError(f"[{tag}] a shard differs from ckpt_iter_{MGPU_CHECKPOINT}")
        print(f"[{tag}] ckpt_iter_{MGPU_CHECKPOINT}.npz read back through load_checkpoint: "
              "each rank's shard of it equals the shard it held, bitwise")
    else:
        sums = [(r["sums"]["adc"], r["sums"]["end"]) for r in ranks]
        if sums[0] != sums[1]:
            raise AssertionError(f"[{tag}] the replicas differ")
        print(f"[{tag}] the two replicas are bitwise equal after the ADC event and at "
              f"the end ({len(sums[0][1])} tensors, sha256)")
    if not want_files <= set(names):
        raise AssertionError(f"[{tag}] files {names}")
    return dict(total)


def mgpu_phase(smi):
    """The multi-GPU phase: (a) NCCL at world size 1, (b) two ranks sharing
    the card over gloo, (c) the dry run on four ranks, (d) the training CLI
    with --model_parallel 2, (e) with --data_parallel 2.  Returns the
    launches summed over every rank of (a), (b), (d), (e)."""
    import torch

    from gaussian_splatting_torch.parallel import comm
    from gaussian_splatting_torch.parallel.dryrun import dryrun_multigpu

    torch.cuda.empty_cache()  # the ranks share the card with this process
    totals = collections.Counter()
    with phase("multi-GPU (a): NCCL, one rank"):
        [a] = comm.launch(_mgpu_nccl_rank, 1, device_type="cuda")
        print(f"[mgpu] (a) backend {a['backend']}, one rank on {DEVICE}, garden view 0 at "
              f"{WIDTH}x{HEIGHT}, {MGPU_CAPACITY} slots; launches {a['launches']}")
        for name in ("mp_train_step", "dp_train_step"):
            _check_step(f"(a) {name} vs trainer.train_step", a[name])
        totals.update(a["launches"])
    with phase("multi-GPU (b): two ranks over gloo"):
        pair = comm.launch(_mgpu_pair_rank, 2, device_type="cuda")
        for r, b in enumerate(pair):
            print(f"[mgpu] (b) rank {r} ({b['backend']}): launches {b['launches']}")
            for path in ("dc", "per_pixel"):
                rd = b[f"render_{path}"]
                print(f"[mgpu] (b) rank {r} mp_render {path} vs rasterize: image within "
                      f"{rd['err']:.3e}, {rd['splats']} splats in the bands against "
                      f"{rd['want_splats']}, visibility {'equal' if rd['visible_ok'] else 'DIFFERS'}")
                if not (rd["err"] <= IMG_TOL and rd["visible_ok"]
                        and rd["splats"] >= rd["want_splats"]):
                    raise AssertionError(f"[mgpu] (b) mp_render {path}: {rd}")
                _check_step(f"(b) rank {r} mp_train_step {path} vs train_step", b[f"step_{path}"])
            _check_step(f"(b) rank {r} dp_train_step vs the mean of two views", b["step_dp"])
            print(f"[mgpu] (b) rank {r}: all-gather of 46 MB a rank (92 MB gathered) of "
                  f"CUDA tensors over gloo: {', '.join(f'{t:.3f}' for t in b['gather_ms'])} "
                  f"ms (host clock between synchronisations; {smi})")
            want = with_geometry({"render_fwd": 3, "render_bwd": 2, "render_sh_fwd": 2,
                                  "render_sh_bwd": 1, "adam_step": 3})
            if b["launches"] != want:
                raise AssertionError(f"[mgpu] (b) rank {r} launches {b['launches']} != {want}")
            totals.update(b["launches"])
    with phase("multi-GPU (c): dry run, four ranks"):
        lines = dryrun_multigpu(4, "cuda")
        if len(lines) != 6 or not all(line.endswith("OK") for line in lines):
            raise AssertionError(f"[mgpu] (c) {lines}")
    for kind, part in (("mp", "(d)"), ("dp", "(e)")):
        with phase(f"multi-GPU {part}: train_torch --{kind} 2"), \
                tempfile.TemporaryDirectory() as tmp:
            totals.update(mgpu_cli_run(kind, smi, os.path.join(tmp, "run")))
    print(f"[mgpu] launches over every rank of (a), (b), (d), (e): {dict(totals)}")
    return dict(totals)


# the TPU probes: launch counter, name, source, the TPU kernel it replaces
# and the sweep point that stands for it in the kernels line
PROBES = (
    ("permute_probe", "permute_probe (E1, group-local permutation)",
     "gaussian_splatting_torch/csrc/probes/permute_probe.cu",
     "experiments/permute_probe.py:34", "G=1024"),
    ("scan_probe", "scan_probe (E2, segmented exclusive prefix sum)",
     "gaussian_splatting_torch/csrc/probes/cumsum_scan.cu",
     "experiments/cumsum_bench.py:30", "chunk=256"),
    ("place_probe", "place_probe (E3, block placement at row offsets)",
     "gaussian_splatting_torch/csrc/probes/dma_scatter.cu",
     "experiments/dma_scatter_bench.py:34", "rows_blk=512 nsub=16"),
)


def run_probes(smi):
    """Every probe's full sweep on the card (E1 4 points, E2 2, E3 8): each
    point's kernel against its plain version (E1 and E3 bitwise, E2 within
    cumsum_bench.SCAN_TOL), the kernel, plain and library-call times, and
    the bound.  Returns ({counter: the representative point}, launches)."""
    from gaussian_splatting_torch import telemetry
    from gaussian_splatting_torch.experiments import (
        cumsum_bench,
        dma_scatter_bench,
        permute_probe,
        sort_line,
    )
    from gaussian_splatting_torch.timing import bound

    modules = {"permute_probe": permute_probe, "scan_probe": cumsum_bench,
               "place_probe": dma_scatter_bench}
    agreement = {"permute_probe": "bitwise",
                 "scan_probe": f"tol {cumsum_bench.SCAN_TOL}",
                 "place_probe": "bitwise"}
    telemetry.LAUNCHES.clear()
    sweeps, failed = {}, []
    for key, mod in modules.items():
        points, info = mod.sweep(DEVICE)
        for p in points:
            p["bound_ms"], p["bound_by"] = bound(p["bytes"], p["ops"])
            print(f"[probe] {key} {p['point']}: kernel {p['ms']:.4f} ms, plain "
                  f"{p['plain_ms']:.3f} ms, library {p['library_ms']:.4f} ms "
                  f"({info['clock']}; {smi}); bound {p['bound_ms']:.4f} ms by "
                  f"{p['bound_by']} ({p['bytes']} bytes, {p['ops']} float32 "
                  f"operations), {p['bound_ms'] / p['ms']:.1%} of it; "
                  f"max|kernel - plain| {p['max_abs_err']:.3e} "
                  f"({agreement[key]}): {'OK' if p['ok'] else 'MISMATCH'}")
            if not p["ok"]:
                failed.append(f"{key} {p['point']}")
        if "sort" in info:
            print(f"[probe] {key}: {sort_line(info['sort'])} ({info['clock']})")
        sweeps[key] = points
    launches = dict(telemetry.LAUNCHES)
    print(f"[probe] launches {launches}")
    if failed:
        raise AssertionError(f"probe kernels disagree with their plain versions: {failed}")
    if set(launches) != set(modules) or any(
            launches[k] < len(sweeps[k]) for k in modules):
        raise AssertionError(f"expected every probe kernel at each point, got {launches}")
    chosen = {}
    for key, _, _, _, point in PROBES:
        chosen[key] = next(p for p in sweeps[key] if p["point"] == point)
    return chosen, launches


def kernel_bench_block(smi):
    """[kernel-bench]: B1 and B2 alone at the JAX package's bench point
    (gaussian_splatting_torch/experiments/kernel_bench.py: 1,970,487 splats,
    459 in each of 1296x840's 4,293 tiles), each held to its plain version,
    with kernel and plain ms, bound and share; then one short point of the
    sort ladder (experiments/sort_bench.py: 2^22 elements, 1 and 12
    operands, and the layout's int64 key).  Its launches are comparisons,
    not a main path: the counter is cleared before and after it.  Returns
    the kernel_bench result."""
    from gaussian_splatting_torch import telemetry
    from gaussian_splatting_torch.experiments import kernel_bench, sort_bench

    t0 = time.perf_counter()
    telemetry.LAUNCHES.clear()
    res = kernel_bench.run(DEVICE)
    for line in kernel_bench.lines(res):
        print(f"[kernel-bench] {line}; {smi}")
    points, info = sort_bench.ladder(DEVICE, sizes=(1 << 22,), operands=(1, 12),
                                     packing=(), batch_rows=())
    for p in points:
        print(f"[kernel-bench] sort {sort_bench.line(p)} ({info['clock']}; {smi})")
    print(f"[kernel-bench] launches {dict(telemetry.LAUNCHES)} (comparisons and timing); "
          f"{time.perf_counter() - t0:.1f} s")
    telemetry.LAUNCHES.clear()
    return res


# the parts of a step that gsbench.trace.read attributes device time to
PART_LABELS = {
    "fwd_prep": "pack and tile order of B1/B3/B5",
    "render_fwd": "B1 (DC forward kernel)",
    "render_bwd": "B2 (DC backward kernel)",
    "render_sh_fwd": "B3 (per-pixel SH forward kernel)",
    "render_sh_bwd": "B4 (per-pixel SH backward kernel)",
    "layout": "forward tile layout",
    "render": "forward geometry, SH, compositing glue",
    "loss": "L1 + SSIM forward",
    "adam": "Adam, step skip, accumulators",
    "backward": "backward: the gs::backward span",
    "unspanned": "backward: autograd through SSIM, L1, geometry",
}


def profile_step(step, median_ms, tag):
    """One training step under torch.profiler, read by the benchmark's
    reader of a trace (``gsbench.trace.read``): device time by part of the
    step and by kernel, and the device's idle share of a step.  Returns the
    device-busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsbench import trace

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t = trace.read(prof, 1, window_s)
    busy_ms = t.busy_s * 1e3
    print(f"[profile] one {tag} step: device busy {busy_ms:.3f} ms; idle share "
          f"{1 - busy_ms / median_ms:.3f} of the {median_ms:.3f} ms median step")
    total = sum(t.parts.values())
    for part, s in sorted(t.parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {s * 1e3:8.3f} ms  {s / total:6.1%}  {PART_LABELS.get(part, part)}")
    print("[profile] largest device ops:")
    for name, s in t.device_ops:
        print(f"[profile]   {s * 1e3:8.3f} ms  {name[:100]}")
    # the full table goes to standard error, out of the way of the summary
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40),
          file=sys.stderr)
    return busy_ms


def check_goldens(fx, fx_cam, fx_pose, fx_alpha, dev):
    """The reference golden pixels on the card: DC image, depth, per-pixel
    SH image, and zero higher bands through B3 equal to the DC path."""
    import torch

    from gaussian_splatting_torch.rasterize import rasterize, render_depth

    fx_params = {k: v.detach() for k, v in fx.params().items()}
    bg = torch.zeros(3, device=dev)
    img = rasterize(fx_params, fx.alive, fx_pose, fx_cam, background_rgb=bg,
                    n_sh_band=0, **FX_RENDER).image
    depth = render_depth(fx_params, fx.alive, fx_pose, fx_cam,
                         alpha_threshold=FX_ALPHA, **fx_alpha).cpu().numpy()
    for (y, x), ch, want in IMAGE_GOLDENS:
        got = float(img[y, x, ch])
        print(f"[golden] image[{y},{x},{ch}] {got:.8f} vs {want} (tol {GOLDEN_TOL})")
        if abs(got - want) > GOLDEN_TOL:
            raise AssertionError("image golden pixel off")
    for (y, x), want in DEPTH_GOLDENS:
        got = float(depth[y, x, 0])
        print(f"[golden] depth[{y},{x}] {got:.6f} vs {want:.6f} (tol {DEPTH_GOLDEN_TOL})")
        if abs(got - want) > DEPTH_GOLDEN_TOL:
            raise AssertionError("depth golden pixel off")

    from gaussian_splatting_torch import telemetry

    telemetry.LAUNCHES.clear()
    sh_img = rasterize(with_sh(fx_params, np.full((6, 3, 15), 0.1)), fx.alive,
                       fx_pose, fx_cam, background_rgb=bg, n_sh_band=3,
                       use_sh_precompute=False, **FX_RENDER).image.cpu().numpy()
    for (y, x), want in SH_GOLDENS:
        got = sh_img[y, x]
        err = float(np.abs(got - np.array(want)).max())
        print(f"[golden] per-pixel SH image[{y},{x}] {np.round(got, 8).tolist()} vs "
              f"{want} (max err {err:.2e}, tol {GOLDEN_TOL})")
        if err > GOLDEN_TOL:
            raise AssertionError("per-pixel SH golden pixel off")
    zero_hi = rasterize(with_sh(fx_params, np.zeros((6, 3, 15))), fx.alive, fx_pose,
                        fx_cam, background_rgb=bg, n_sh_band=3,
                        use_sh_precompute=False, **FX_RENDER).image
    dc_err = float((zero_hi - img).abs().max())
    print(f"[golden] zero bands 1-3 through B3 vs the DC path through B1: max "
          f"|image| {dc_err:.3e} (tol {SH_DC_TOL}); launches {dict(telemetry.LAUNCHES)}")
    if dc_err > SH_DC_TOL or telemetry.LAUNCHES["render_sh_fwd"] != 2:
        raise AssertionError("per-pixel SH with zero higher bands differs from DC")


def serve_per_pixel(params, alive, poses, cam, scene_kw, dev):
    """The per-pixel SH serving path: the orbit views through rasterize with
    use_sh_precompute=False.  Returns the launches."""
    import torch

    from gaussian_splatting_torch import telemetry
    from gaussian_splatting_torch.rasterize import rasterize

    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        telemetry.LAUNCHES.clear()
        results = [rasterize(params, alive, pose, cam, background_rgb=bg,
                             n_sh_band=SH_BAND, use_sh_precompute=False, **scene_kw)
                   for pose in poses]
        torch.cuda.synchronize()
        launches = dict(telemetry.LAUNCHES)
    print(f"[main-sh] launches {launches}")
    if launches != with_geometry({"render_sh_fwd": N_VIEWS}):
        raise AssertionError(f"expected {N_VIEWS} launches of B3 and its geometry only, "
                             f"got {launches}")
    for i, res in enumerate(results):
        im = res.image
        if tuple(im.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(im).all()):
            raise AssertionError(f"per-pixel view {i}: image not finite or wrong shape")
        mean = float(im.clamp(0, 1).mean())
        print(f"[main-sh] view {i}: num_visible {res.num_visible}, num_splats "
              f"{res.num_splats}, truncated {res.truncated}, image mean {mean:.4f}")
        if not (mean > 0.01 and res.num_splats > 0):
            raise AssertionError(f"per-pixel view {i}: empty render")
    return launches


INSTALL_PACKAGE = "gaussian_splatting_torch"
INSTALL_TIMEOUT = 600  # seconds for the process that builds and runs the copy
# the COLMAP model the installed reader reads: 3 views, 64 points
INSTALL_VIEWS, INSTALL_POINTS = 3, 64


def shipped_tree(dest):
    """Copy into ``dest`` what an install of the port carries and nothing
    else: the .py files of the package and of each subpackage (a directory
    with an __init__.py), and the files that pyproject.toml's package-data
    globs match.  Returns the data files, relative to ``dest``."""
    import shutil
    import tomllib
    from pathlib import Path

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    files = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, INSTALL_PACKAGE)):
        if "__init__.py" not in filenames:
            dirnames.clear()
            continue
        files += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    data = [str(p) for package, globs in package_data.items() for pattern in globs
            for p in Path(ROOT, *package.split(".")).glob(pattern)]
    for path in files + data:
        rel = os.path.relpath(path, ROOT)
        os.makedirs(os.path.join(dest, os.path.dirname(rel)), exist_ok=True)
        shutil.copyfile(path, os.path.join(dest, rel))
    return sorted(os.path.relpath(p, ROOT) for p in data)


def install_results(dev, colmap_dir):
    """What the imported package gives on fixed inputs: the fixture through
    B1 (one launch), the COLMAP model in ``colmap_dir`` through the native
    reader, and the JPEG fixtures and their PNGs through the port's own
    decoders.  Arrays by name."""
    import torch

    from gaussian_splatting_torch import telemetry
    from gaussian_splatting_torch.dataio import colmap, dataset
    from gaussian_splatting_torch.rasterize import rasterize

    fx, cam, pose = fixture_scene(dev)
    params = {k: v.detach() for k, v in fx.params().items()}
    telemetry.LAUNCHES.clear()
    res = rasterize(params, fx.alive, pose, cam, background_rgb=torch.zeros(3, device=dev),
                    n_sh_band=0, **FX_RENDER)
    torch.cuda.synchronize()
    if dict(telemetry.LAUNCHES) != with_geometry({"render_fwd": 1}):
        raise AssertionError(f"[install] fixture render launched {dict(telemetry.LAUNCHES)}")
    out = {"image": res.image.cpu().numpy(), "T": res.transmittance.cpu().numpy()}

    sparse = os.path.join(colmap_dir, "sparse", "0")
    cams = colmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    readers = [colmap.last_reader]
    images = colmap.read_images_bin(os.path.join(sparse, "images.bin"))
    readers.append(colmap.last_reader)
    out["xyz"], out["rgb"] = colmap.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    readers.append(colmap.last_reader)
    if readers != ["native"] * 3:
        raise AssertionError(f"[install] COLMAP model read by {readers}, not the native reader")
    out["camera"] = np.array([cams[1].width, cams[1].height, *cams[1].params])
    out["qvec"] = np.stack([images[i].qvec for i in sorted(images)])
    out["tvec"] = np.stack([images[i].tvec for i in sorted(images)])

    with without_image_packages():
        for name in JPEG_FIXTURE_NAMES:
            for ext, decoder in ((".jpg", "jpeg"), (".png", "png")):
                out[name + ext] = dataset.read_rgb(os.path.join(JPEG_FIXTURES, name + ext))
                if dataset.last_decoder != decoder:
                    raise AssertionError(f"[install] {name}{ext} decoded by "
                                         f"{dataset.last_decoder}, not {decoder}")
    return out


def installed_run(tree, out, colmap_dir):
    """The install check's process, with ``tree`` (shipped_tree's copy)
    first on sys.path: build the two kernel libraries from the copy's
    sources, save install_results (which builds the two dataio libraries)
    to ``out``, and check that all four libraries were built in the copy."""
    import gaussian_splatting_torch
    from gaussian_splatting_torch import _build
    from gaussian_splatting_torch.dataio import native

    root = os.path.realpath(tree) + os.sep
    if not os.path.realpath(gaussian_splatting_torch.__file__).startswith(root):
        raise AssertionError(f"[install] imported {gaussian_splatting_torch.__file__}, "
                             f"not the copy in {tree}")
    t0 = time.perf_counter()
    libraries = _build.build(*_build.SOURCE_DIRS)
    for name in _build.SOURCE_DIRS:
        _build.library(name)
    np.savez(out, **install_results(DEVICE, colmap_dir))
    libraries += [native.library_path(name) for name in native.SOURCES]
    for so in libraries:
        if not (os.path.realpath(so).startswith(root) and so.exists()):
            raise AssertionError(f"[install] {so} is not a library built in the copy")
    print(f"[install] built {', '.join(so.name for so in libraries)} from the copy and "
          f"ran it in {time.perf_counter() - t0:.1f} s", flush=True)


def install_phase(dev):
    """An installed port builds and runs from what it ships: shipped_tree's
    copy, imported by a process of its own, builds every library and gives
    the results of this checkout bitwise (install_results)."""
    with tempfile.TemporaryDirectory() as tmp:
        tree, colmap_dir = os.path.join(tmp, "tree"), os.path.join(tmp, "colmap")
        native_files = shipped_tree(tree)
        print(f"[install] shipped {len(native_files)} native sources: "
              f"{', '.join(native_files)}")
        rng = np.random.default_rng(0)
        q = rng.normal(size=(INSTALL_VIEWS, 4))
        write_colmap_model(
            os.path.join(colmap_dir, "sparse", "0"), (97, 61, 82.0, 82.0, 48.5, 30.5),
            q / np.linalg.norm(q, axis=1, keepdims=True),
            rng.normal(size=(INSTALL_VIEWS, 3)),
            [f"{i:03d}.png" for i in range(INSTALL_VIEWS)],
            rng.normal(size=(INSTALL_POINTS, 3)),
            rng.integers(0, 256, (INSTALL_POINTS, 3), dtype=np.uint8))
        out = os.path.join(tmp, "installed.npz")
        code = ("import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
                "chip_smoke.installed_run(sys.argv[1], *sys.argv[3:])")
        proc = subprocess.run([sys.executable, "-c", code, tree, ROOT, out, colmap_dir],
                              cwd=tree, timeout=INSTALL_TIMEOUT)
        if proc.returncode != 0:
            raise AssertionError(f"[install] the installed copy failed ({proc.returncode})")
        want = install_results(dev, colmap_dir)
        with np.load(out) as got:
            if set(got.files) != set(want):
                raise AssertionError(f"[install] results {got.files} against {list(want)}")
            for key, w in want.items():
                g = got[key]
                if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
                    raise AssertionError(f"[install] {key} differs from this checkout's")
        print(f"[install] the copy's fixture render through B1, COLMAP read and "
              f"{2 * len(JPEG_FIXTURE_NAMES)} decodes equal this checkout's bitwise")


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    from gaussian_splatting_torch import _build, telemetry

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    print("[device] TF32 off for matmul and cuDNN")

    # 2. build
    with phase("build"):
        t0 = time.perf_counter()
        libraries = _build.build("kernels", "probes")
        print(f"[build] {', '.join(so.name for so in libraries)} in "
              f"{time.perf_counter() - t0:.1f} s "
              f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped'})")
        for so in libraries:
            for line in so.with_suffix(".log").read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"[build]   {line.strip()}")
        _build.library("kernels")
        _build.library("probes")

    # 2b. what an install ships builds and runs, in a process of its own
    with phase("install"):
        install_phase(dev)

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.ops.render import render_bwd_cuda, render_bwd_plain
    from gaussian_splatting_torch.ops.render_sh import (
        render_sh_bwd_cuda,
        render_sh_bwd_plain,
    )

    cfg = SplatConfig()
    scene_kw = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                    cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist)
    depth_kw = dict(near_thresh=cfg.near_thresh,
                    cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist)
    fx, fx_cam, fx_pose = fixture_scene(dev)
    fx_alpha = dict(near_thresh=0.3, cull_mask_padding=10.0, mh_dist=3.0)
    scene, cam, pose = scene_view(dev)
    params = {k: v.detach() for k, v in scene.params().items()}
    sh_rows = "u v op a b c, then 3*n_sh coefficients"

    # 3. kernel vs plain on the card: B1, B5
    with phase("B1/B5 vs plain"):
        print("[compare] kernel vs plain PyTorch version, same inputs, on the card")
        dc, dep, grid = kernel_inputs(fx, fx_cam, fx_pose, FX_RENDER, 0, dict(fx_alpha))
        compare("fixture 640x480", dc, dep, grid, FX_ALPHA)
        s_dc, s_dep, s_grid = kernel_inputs(scene, cam, pose, scene_kw, SH_BAND,
                                            depth_kw)
        img_err, d_err = compare(f"scene view 0 {WIDTH}x{HEIGHT}", s_dc, s_dep,
                                 s_grid, ALPHA_THRESHOLD)

    # 4. B3 and B4 against their plain versions: fixture at n_sh 4, 9, 16
    # with seeded coefficients, garden view 0 at n_sh 16
    with phase("B3/B4 vs plain"):
        print("[compare] B3/B4 (per-pixel SH) vs their plain versions, seeded cotangent")
        for n_sh, band in BAND_OF_N_SH.items():
            fx_sh = sh_kernel_inputs(fixture_sh_params(fx, n_sh), fx.alive, fx_pose,
                                     fx_cam, FX_RENDER, band)
            compare_sh("fixture 640x480", fx_sh)
            compare_bwd(f"fixture 640x480 n_sh {n_sh}", "B4", render_sh_bwd_cuda,
                        render_sh_bwd_plain, sh_bwd_args(fx_sh, seed=10 + n_sh), sh_rows)
        s_sh = sh_kernel_inputs(params, scene.alive, pose, cam, scene_kw, SH_BAND)
        b3_err = compare_sh(f"scene view 0 {WIDTH}x{HEIGHT}", s_sh)
        s_sh_bwd = sh_bwd_args(s_sh, seed=3)
        b4_abs, b4_rel, b4_spread = compare_bwd(
            f"scene view 0 {WIDTH}x{HEIGHT} n_sh 16", "B4", render_sh_bwd_cuda,
            render_sh_bwd_plain, s_sh_bwd, sh_rows)

    # 5. goldens on the card
    with phase("goldens"):
        check_goldens(fx, fx_cam, fx_pose, fx_alpha, dev)

    # 6. main path: render_torch.render_views, 4 orbit views + depth
    import render_torch

    with phase("serving"), tempfile.TemporaryDirectory() as out:
        telemetry.LAUNCHES.clear()
        views = render_torch.render_views(
            SCENE, out=out, orbit=N_VIEWS, width=WIDTH, height=HEIGHT,
            focal=FOCAL, sh_band=SH_BAND, depth=True,
            alpha_threshold=ALPHA_THRESHOLD, device=DEVICE,
        )
        torch.cuda.synchronize()
        launches = dict(telemetry.LAUNCHES)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        print(f"[main] launches {launches}; {len(pngs)} PNGs written")
        if launches.get("render_fwd") != N_VIEWS or launches.get("depth_fwd") != N_VIEWS:
            raise AssertionError(f"expected {N_VIEWS} launches of each kernel, got {launches}")
        if len(pngs) != 2 * N_VIEWS:
            raise AssertionError(f"expected {2 * N_VIEWS} PNGs, got {pngs}")
        for v in views:
            im, d = v["image"], v["depth"]
            if tuple(im.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(im).all()):
                raise AssertionError(f"{v['name']}: image not finite or wrong shape")
            mean = float(im.clamp(0, 1).mean())
            hits = int((d > 0).sum())
            print(f"[main] {v['name']}: num_visible {v['num_visible']}, num_splats "
                  f"{v['num_splats']}, truncated {v['truncated']}, image mean "
                  f"{mean:.4f}, depth hits {hits}")
            if not (mean > 0.01 and hits > 0 and v["num_splats"] > 0):
                raise AssertionError(f"{v['name']}: empty render")
            if not isinstance(v["truncated"], int):
                raise AssertionError(f"{v['name']}: truncated not reported")

    # 7. main path, per-pixel SH: the same 4 orbit views through B3
    xyz = params["xyz"][scene.alive].cpu().numpy()
    poses = [torch.from_numpy(p).to(dev) for p in render_torch.orbit_poses(xyz, N_VIEWS)]
    with phase("serving, per-pixel SH"):
        sh_launches = serve_per_pixel(params, scene.alive, poses, cam, scene_kw, dev)

    # timings at the main paths' shapes (view 0)
    from gaussian_splatting_torch.ops.depth import depth_fwd_cuda, depth_fwd_plain
    from gaussian_splatting_torch.ops.render import render_fwd_cuda, render_fwd_plain
    from gaussian_splatting_torch.ops.render_sh import (
        render_sh_fwd_cuda,
        render_sh_fwd_plain,
    )
    from gaussian_splatting_torch.rasterize import rasterize, render_depth

    with phase("view and kernel timings"):
        bg = torch.zeros(3, device=dev)
        render_ms = host_ms(lambda: rasterize(
            params, scene.alive, pose, cam, background_rgb=bg, n_sh_band=SH_BAND,
            **scene_kw), 5)
        sh_render_ms = host_ms(lambda: rasterize(
            params, scene.alive, pose, cam, background_rgb=bg, n_sh_band=SH_BAND,
            use_sh_precompute=False, **scene_kw), 5)
        depth_ms = host_ms(lambda: render_depth(
            params, scene.alive, pose, cam, alpha_threshold=ALPHA_THRESHOLD,
            **depth_kw), 5)
        print(f"[time] per view at {WIDTH}x{HEIGHT}: render {render_ms:.3f} ms, "
              f"per-pixel SH render {sh_render_ms:.3f} ms, depth {depth_ms:.3f} ms "
              f"(host clock, median of 5 after a warm-up; {smi})")

        feat, lay = s_dc
        dfeat, dlay = s_dep
        sfeat, basis, slay, sx = s_sh
        times = {
            "render_fwd": time_kernel(
                "render_fwd", render_fwd_cuda, render_fwd_plain,
                (feat, lay.gaussian_idx, lay.tile_starts, s_grid.x_tiles), smi),
            "depth_fwd": time_kernel(
                "depth_fwd", depth_fwd_cuda, depth_fwd_plain,
                (dfeat, dlay.gaussian_idx, dlay.tile_starts, s_grid.x_tiles,
                 ALPHA_THRESHOLD), smi),
            "render_sh_fwd": time_kernel(
                "render_sh_fwd", render_sh_fwd_cuda, render_sh_fwd_plain,
                (sfeat, basis, slay.gaussian_idx, slay.tile_starts, sx), smi),
        }

    # 8. B2 against its plain version on the card, fixture and garden view
    with phase("B2 vs plain"):
        print("[compare] B2 (DC backward) vs its plain version, seeded cotangent")
        dc_rows = "u v op a b c r g b"
        compare_bwd("fixture 640x480", "B2", render_bwd_cuda, render_bwd_plain,
                    bwd_args(dc, grid, seed=1), dc_rows)
        s_bwd = bwd_args(s_dc, s_grid, seed=2)
        b2_abs, b2_rel, b2_spread = compare_bwd(
            f"scene view 0 {WIDTH}x{HEIGHT}", "B2", render_bwd_cuda, render_bwd_plain,
            s_bwd, dc_rows)

    # 9. the fused Adam step against its plain version at the training
    # cells' shapes, then the training paths: DC (B1, B2), per-pixel SH (B3, B4)
    with phase("Adam vs plain"):
        adam_entry = adam_phase(smi)
    with phase("geometry kernel pair vs plain"):
        geometry_entries = geometry_phase(smi)
    with phase("layout kernels vs plain"):
        layout_entry = layout_phase(smi)
    with phase("training setup"):
        setup = training_setup(dev, scene_kw)
    with phase("training, DC"):
        train_launches, step_ms = training_phase(
            setup, cfg, TRAIN_STEPS, "train", ("render_fwd", "render_bwd"))
    with phase("training, per-pixel SH"):
        sh_cfg = SplatConfig(use_sh_precompute=False)
        sh_train_launches, sh_step_ms = training_phase(
            setup, sh_cfg, SH_TRAIN_STEPS, "train-sh", ("render_sh_fwd", "render_sh_bwd"))
    with phase("training, ADC and opacity reset"):
        adc_launches, adc_ms, reset_ms = adc_phase(setup, cfg, smi)

    with phase("training, Scaffold-GS"):
        scaffold_launches = scaffold_phase(smi)

    with phase("backward timings and bounds"):
        times["render_bwd"] = time_kernel("render_bwd", render_bwd_cuda,
                                          render_bwd_plain, s_bwd, smi)
        times["render_sh_bwd"] = time_kernel("render_sh_bwd", render_sh_bwd_cuda,
                                             render_sh_bwd_plain, s_sh_bwd, smi)
        bounds = kernel_bounds(s_dc, s_dep, s_grid, s_sh)

    # 10. the TPU probes E1-E3, full sweeps
    with phase("probes"):
        probes, probe_launches = run_probes(smi)
        bench_point = kernel_bench_block(smi)

    # 11. the reference-scale run: the full 7k schedule of runs/refscale7k
    # through train_torch.main on the synthetic reference-scale scene
    with phase("refscale"):
        refscale_launches = refscale_phase(smi)

    # 12. a COLMAP capture of garden's shape through train_torch.py (per-pixel
    # SH) and render_torch.py, with the port's own image decoders
    with phase("capture"):
        capture_launches = capture_phase(smi)

    # 13. multi-GPU training: the ranks share the one card
    mgpu_launches = mgpu_phase(smi)

    def at_bench(k):
        b = bench_point[k]
        return dict(splats=bench_point["splats"], ms=b["ms"], plain_ms=b["plain_ms"],
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"])

    def entry(key, name, source, replaces, launches, err, **extra):
        ms, plain_ms = times[key]
        bound_ms, bound_by = bounds[key]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    # no single PyTorch call composites depth-sorted splats
                    library_ms=None, **extra)

    kernels = [
        entry("render_fwd", "render_fwd (B1, DC forward)",
              "gaussian_splatting_torch/csrc/render_fwd.cu",
              "gaussian_splatting_tpu/ops/render.py:525",
              launches["render_fwd"] + train_launches["render_fwd"]
              + adc_launches["render_fwd"] + scaffold_launches["render_fwd"]
              + refscale_launches["render_fwd"] + capture_launches["render_fwd"]
              + mgpu_launches["render_fwd"], img_err,
              kernel_bench_point=at_bench("B1"),
              pack="gs_pack_fwd_rows launched first, bitwise equal to pack_fwd_rows_plain",
              tile_order="gs_tile_order launched second, equal to tile_order_plain up to ties"),
        entry("depth_fwd", "depth_fwd (B5, depth)",
              "gaussian_splatting_torch/csrc/depth_fwd.cu",
              "gaussian_splatting_tpu/ops/depth.py:53",
              launches["depth_fwd"] + capture_launches["depth_fwd"], d_err,
              pack="gs_pack_fwd_rows launched first, bitwise equal to pack_fwd_rows_plain",
              tile_order="gs_tile_order launched second, equal to tile_order_plain up to ties"),
        entry("render_bwd", "render_bwd (B2, DC backward)",
              "gaussian_splatting_torch/csrc/render_bwd.cu",
              "gaussian_splatting_tpu/ops/render.py:635",
              train_launches["render_bwd"] + adc_launches["render_bwd"]
              + scaffold_launches["render_bwd"] + refscale_launches["render_bwd"]
              + capture_launches["render_bwd"] + mgpu_launches["render_bwd"], b2_abs,
              max_rel_err_per_row=b2_rel, run_to_run_spread=b2_spread,
              kernel_bench_point=at_bench("B2")),
        entry("render_sh_fwd", "render_sh_fwd (B3, per-pixel SH forward)",
              "gaussian_splatting_torch/csrc/render_sh_fwd.cu",
              "gaussian_splatting_tpu/ops/render_sh.py:93",
              sh_launches["render_sh_fwd"] + sh_train_launches["render_sh_fwd"]
              + capture_launches["render_sh_fwd"] + mgpu_launches["render_sh_fwd"], b3_err,
              pack="gs_pack_fwd_rows launched first, bitwise equal to pack_fwd_rows_plain",
              tile_order="gs_tile_order launched second, equal to tile_order_plain up to ties"),
        entry("render_sh_bwd", "render_sh_bwd (B4, per-pixel SH backward)",
              "gaussian_splatting_torch/csrc/render_sh_bwd.cu",
              "gaussian_splatting_tpu/ops/render_sh.py:187",
              sh_train_launches["render_sh_bwd"] + capture_launches["render_sh_bwd"]
              + mgpu_launches["render_sh_bwd"], b4_abs,
              max_rel_err_per_row=b4_rel, run_to_run_spread=b4_spread),
    ]
    adam_entry["launches"] += sum(
        part.get("adam_step", 0) for part in (
            train_launches, sh_train_launches, adc_launches, scaffold_launches,
            refscale_launches,
            capture_launches, mgpu_launches))
    kernels.append(adam_entry)
    parts = (launches, sh_launches, train_launches, sh_train_launches, adc_launches,
             scaffold_launches, refscale_launches, capture_launches, mgpu_launches)
    for e in geometry_entries:
        key = e["name"].split()[0]
        e["launches"] = sum(part.get(key, 0) for part in parts)
        kernels.append(e)
    layout_entry["launches"] = sum(part.get("layout_count", 0) for part in parts)
    kernels.append(layout_entry)
    for key, label, source, replaces, point in PROBES:
        p = probes[key]
        kernels.append(dict(
            name=label, route="cuda", source=source, replaces=replaces,
            launches=probe_launches[key], max_abs_err=p["max_abs_err"], ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"], point=point))
    print(f"[time] training step {step_ms:.3f} ms, per-pixel SH training step "
          f"{sh_step_ms:.3f} ms, ADC event {adc_ms:.3f} ms, opacity reset {reset_ms:.3f} "
          f"ms (host clock; {smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
