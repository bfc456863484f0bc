#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port: serving and training, on one card.

Builds the port's CUDA kernels from gaussian_splatting_torch/csrc, holds each
kernel against its plain PyTorch version on the card, checks the reference
golden pixels, then drives the paths below on the trained scene
runs/refscale7k/scene_final.ply at 1296x840 and shows, by the launch
counters, that each went through its kernels:

- serving: 4 orbit views (plus depth) through render_torch.render_views
  (kernels B1, B5);
- serving, per-pixel SH: the 4 orbit views through
  rasterize(..., n_sh_band=3, use_sh_precompute=False) (kernel B3);
- training: 20 trainer.train_step calls on a seeded perturbation of the
  scene, cycling through the 4 views (kernels B1, B2), checked for finite
  parameters, the densification counts and a falling loss on every view;
- training, per-pixel SH: 8 steps of the same with
  SplatConfig(use_sh_precompute=False) (kernels B3, B4);
- the TPU probes E1-E3 (gaussian_splatting_torch/experiments): each
  probe's full sweep, every point's kernel against its plain version,
  with kernel, plain and library-call times and the bound.

It times the kernels against their plain versions, works out each kernel's
bound (the least time the card could take for the same work), and
profiles one step of each training path.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits nonzero on any failure.  The last line
of standard output is {"ok": true, "device": {...}}; the line before it is
the per-kernel JSON summary.
"""

import contextlib
import json
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
# kernel per warp and block and then by atomics, the plain walk by parallel
# scans, batched products and index_add_), and D = E - prefix cancels in
# near-saturated pixels, where 1 / (1 - alpha) reaches 1e4.  B2 measured on
# an H100 at 1.6e-6 (fixture) and 9.7e-7 (garden view), with a run-to-run
# spread of the atomics of up to 9.4e-7: the bound leaves ~60x of that
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

# The H100 SXM's peaks (NVIDIA's data sheet, at its 700 W limit): device
# memory and float32 outside the tensor cores.  A kernel's bound is the
# larger of its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per splat-pixel pair, counted from csrc/*.cu: every pair
# a pixel reaches before T < T_EPS evaluates alpha (offsets, the conic
# quadratic, rdet, exp, opacity); a pair that composites (alpha >= 1/255)
# adds the rest.  Per-pixel SH adds 2 * 3 * n_sh for the colour contraction
# (B3, B4) and 2 * 3 * n_sh for the coefficient rows (B4).
ALPHA_OPS = 15
FWD_COMPOSITE_OPS = 10  # weight, 3 colour multiply-adds, T update
BWD_COMPOSITE_OPS = 46  # clamp, weight, A, prefix, D, 1/(1-a), q, 9 rows, T
DEPTH_OPS = 4  # B5: T update and the threshold test on every evaluated pair

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
    from gaussian_splatting_torch.rasterize import depth_kernel_inputs
    from gaussian_splatting_torch.rasterize import kernel_inputs as raster_inputs

    params = {k: v.detach() for k, v in scene.params().items()}
    k = raster_inputs(params, scene.alive, pose, cam, n_sh_band=sh_band, **render_kw)
    dfeat, dlayout, _ = depth_kernel_inputs(
        params, scene.alive, pose, cam, **alpha_kw)
    return (k.feat.contiguous(), k.layout), (dfeat.contiguous(), dlayout), k.grid


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


def pair_counts(feat, lay, x_tiles, clamp=False):
    """(evaluated, composited) splat-pixel pairs of a compositing walk on
    these inputs: pairs a pixel reaches while T >= T_EPS, and those of them
    with alpha >= 1/255 (``clamp``: the backward's clamped alpha)."""
    import torch

    from gaussian_splatting_torch.ops import render as tr

    n_tiles = lay.tile_starts.numel() - 1
    T = torch.ones(n_tiles, 256, device=feat.device)
    evaluated = composited = 0
    for tiles, gid, ok in tr._tile_chunks(lay.gaussian_idx, lay.tile_starts,
                                          tr.PLAIN_CHUNK):
        alpha = tr._alpha_chunk(feat, gid, tiles, x_tiles)
        at, prod, active, _ = tr._composite_chunk(T[tiles], alpha, ok, clamp=clamp)
        evaluated += int((active & ok[:, None, :]).sum())
        composited += int((active & (at > 0)).sum())
        T[tiles] = tr._t_after(prod, active)
    return evaluated, composited


def depth_pairs(dfeat, dlay, x_tiles, alpha_threshold):
    """Splat-pixel pairs B5 evaluates: up to and including each pixel's
    crossing, every pair where nothing crosses."""
    import torch

    from gaussian_splatting_torch.ops import render as tr

    n_tiles = dlay.tile_starts.numel() - 1
    T = torch.ones(n_tiles, 256, device=dfeat.device)
    found = torch.zeros(n_tiles, 256, dtype=torch.bool, device=dfeat.device)
    n = 0
    for tiles, gid, ok in tr._tile_chunks(dlay.gaussian_idx, dlay.tile_starts,
                                          tr.PLAIN_CHUNK):
        alpha = tr._alpha_chunk(dfeat, gid, tiles, x_tiles)
        at = torch.where(ok[:, None, :], alpha, torch.zeros_like(alpha))
        prod = torch.cumprod(torch.cat([T[tiles, :, None], 1.0 - at], dim=2), dim=2)
        crossed = ((1.0 - prod[..., 1:]) > alpha_threshold).int()
        earlier = (torch.cumsum(crossed, dim=2) - crossed) > 0
        n += int((ok[:, None, :] & ~found[tiles][:, :, None] & ~earlier).sum())
        found[tiles] |= crossed.bool().any(dim=2)
        T[tiles] = prod[..., -1]
    return n


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the float32 operations over its peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bounds(s_dc, s_dep, s_grid, s_sh):
    """Each kernel's bound at the main path's shapes (garden view 0): each
    input read once, each output written once, and the operations these
    inputs need."""
    feat, lay = s_dc
    dfeat, dlay = s_dep
    sfeat, basis, slay, x_tiles = s_sh
    n_sh = basis.shape[0]
    n_pix = s_grid.tile_count * 256
    f32 = 4

    def layout_bytes(la):
        return f32 * (la.num_splats + la.tile_starts.numel())

    ev, co = pair_counts(feat, lay, s_grid.x_tiles)
    ev_b, co_b = pair_counts(feat, lay, s_grid.x_tiles, clamp=True)
    sev, sco = pair_counts(sfeat, slay, x_tiles)
    sev_b, sco_b = pair_counts(sfeat, slay, x_tiles, clamp=True)
    dev = depth_pairs(dfeat, dlay, s_grid.x_tiles, ALPHA_THRESHOLD)
    feat_b, sfeat_b = f32 * feat.numel(), f32 * sfeat.numel()
    raw_b = f32 * 4 * n_pix
    sh_ops = 2 * 3 * n_sh
    work = {
        "render_fwd": (feat_b + layout_bytes(lay) + raw_b,
                       ALPHA_OPS * ev + FWD_COMPOSITE_OPS * co),
        "render_bwd": (2 * feat_b + layout_bytes(lay) + 2 * raw_b,
                       ALPHA_OPS * ev_b + BWD_COMPOSITE_OPS * co_b),
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
        rng = np.random.default_rng(TRAIN_SEED)
        n = scene.capacity
        scene.rgb.add_(torch.from_numpy(
            rng.normal(0, RGB_NOISE, (n, 3)).astype(np.float32)).to(dev))
        scene.opacity.add_(torch.from_numpy(
            rng.normal(0, OPACITY_NOISE, (n, 1)).astype(np.float32)).to(dev))
    return dict(scene=scene, poses=poses, K=K, cam=cam, bgs=bgs, gts=gts)


def training_phase(setup, cfg, steps, tag, kernels):
    """trainer.train_step for ``steps`` steps from the perturbed scene,
    cycling through the views; ``kernels`` = (forward, backward) launch
    counter names that each step must launch once, and no other
    rasterizer.  Returns (launches, median step ms)."""
    import torch

    from gaussian_splatting_torch import _build, trainer

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
    _build.LAUNCHES.clear()
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
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] launches {launches}")

    want = {name: steps for name in kernels}
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
    from gaussian_splatting_torch import _build
    from gaussian_splatting_torch.experiments import (
        cumsum_bench,
        dma_scatter_bench,
        permute_probe,
        sort_line,
    )

    modules = {"permute_probe": permute_probe, "scan_probe": cumsum_bench,
               "place_probe": dma_scatter_bench}
    agreement = {"permute_probe": "bitwise",
                 "scan_probe": f"tol {cumsum_bench.SCAN_TOL}",
                 "place_probe": "bitwise"}
    _build.LAUNCHES.clear()
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
    launches = dict(_build.LAUNCHES)
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


# device kernels named in the step profile, by a part of their symbol
KERNEL_PARTS = (
    ("render_fwd_kernel", "B1 (DC forward kernel)"),
    ("render_bwd_kernel", "B2 (DC backward kernel)"),
    ("render_sh_fwd_kernel", "B3 (per-pixel SH forward kernel)"),
    ("render_sh_bwd_kernel", "B4 (per-pixel SH backward kernel)"),
)


def profile_step(step, median_ms, tag):
    """One training step under torch.profiler: device time by part of the
    step and by kernel, and the device's idle share of a step.

    The trainer's record_function ranges (gs::render, gs::layout, gs::loss,
    gs::adam) appear on the device timeline as spans; a kernel belongs to
    the innermost span it starts in.  Autograd launches the backward from
    its own thread, outside those spans: the kernels in no span are the
    backward (B2 or B4, autograd through SSIM, L1 and the geometry)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = ("gs::render", "gs::layout", "gs::loss", "gs::backward", "gs::adam")
    spans = {}
    for e in device:
        if e.name in ranges:
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    kernels = [e for e in device if e.name not in ranges]

    def within(name, k):
        return any(a <= k.time_range.start < b for a, b in spans.get(name, []))

    def part_of(k):
        for sym, part in KERNEL_PARTS:
            if sym in k.name:
                return part
        if within("gs::layout", k):
            return "forward tile layout"
        if within("gs::render", k):
            return "forward geometry, SH, compositing glue"
        if within("gs::loss", k):
            return "L1 + SSIM forward"
        if within("gs::adam", k):
            return "Adam, step skip, accumulators"
        return "backward: autograd through SSIM, L1, geometry"

    parts, by_kernel = {}, {}
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3
        by_kernel[k.name] = by_kernel.get(k.name, 0.0) + ms
        part = part_of(k)
        parts[part] = parts.get(part, 0.0) + ms
    busy_ms = sum(parts.values())
    print(f"[profile] one {tag} step: device busy {busy_ms:.3f} ms in {len(kernels)} "
          f"device ops; idle share {1 - busy_ms / median_ms:.3f} of the "
          f"{median_ms:.3f} ms median step")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:8.3f} ms  {ms / busy_ms:6.1%}  {part}")
    print("[profile] largest device ops:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {ms:8.3f} ms  {name[:100]}")
    # the full table goes to standard error, out of the way of the summary
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40),
          file=sys.stderr)


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

    from gaussian_splatting_torch import _build

    _build.LAUNCHES.clear()
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
          f"|image| {dc_err:.3e} (tol {SH_DC_TOL}); launches {dict(_build.LAUNCHES)}")
    if dc_err > SH_DC_TOL or _build.LAUNCHES["render_sh_fwd"] != 2:
        raise AssertionError("per-pixel SH with zero higher bands differs from DC")


def serve_per_pixel(params, alive, poses, cam, scene_kw, dev):
    """The per-pixel SH serving path: the orbit views through rasterize with
    use_sh_precompute=False.  Returns the launches."""
    import torch

    from gaussian_splatting_torch import _build
    from gaussian_splatting_torch.rasterize import rasterize

    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        _build.LAUNCHES.clear()
        results = [rasterize(params, alive, pose, cam, background_rgb=bg,
                             n_sh_band=SH_BAND, use_sh_precompute=False, **scene_kw)
                   for pose in poses]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(f"[main-sh] launches {launches}")
    if launches != {"render_sh_fwd": N_VIEWS}:
        raise AssertionError(f"expected {N_VIEWS} launches of B3 only, got {launches}")
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


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, ROOT)
    from gaussian_splatting_torch import _build

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
        _build.LAUNCHES.clear()
        views = render_torch.render_views(
            SCENE, out=out, orbit=N_VIEWS, width=WIDTH, height=HEIGHT,
            focal=FOCAL, sh_band=SH_BAND, depth=True,
            alpha_threshold=ALPHA_THRESHOLD, device=DEVICE,
        )
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
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

    # 9. training paths: DC (B1, B2), then per-pixel SH (B3, B4)
    with phase("training setup"):
        setup = training_setup(dev, scene_kw)
    with phase("training, DC"):
        train_launches, step_ms = training_phase(
            setup, cfg, TRAIN_STEPS, "train", ("render_fwd", "render_bwd"))
    with phase("training, per-pixel SH"):
        sh_cfg = SplatConfig(use_sh_precompute=False)
        sh_train_launches, sh_step_ms = training_phase(
            setup, sh_cfg, SH_TRAIN_STEPS, "train-sh", ("render_sh_fwd", "render_sh_bwd"))

    with phase("backward timings and bounds"):
        times["render_bwd"] = time_kernel("render_bwd", render_bwd_cuda,
                                          render_bwd_plain, s_bwd, smi)
        times["render_sh_bwd"] = time_kernel("render_sh_bwd", render_sh_bwd_cuda,
                                             render_sh_bwd_plain, s_sh_bwd, smi)
        bounds = kernel_bounds(s_dc, s_dep, s_grid, s_sh)

    # 10. the TPU probes E1-E3, full sweeps
    with phase("probes"):
        probes, probe_launches = run_probes(smi)

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
              launches["render_fwd"] + train_launches["render_fwd"], img_err),
        entry("depth_fwd", "depth_fwd (B5, depth)",
              "gaussian_splatting_torch/csrc/depth_fwd.cu",
              "gaussian_splatting_tpu/ops/depth.py:53",
              launches["depth_fwd"], d_err),
        entry("render_bwd", "render_bwd (B2, DC backward)",
              "gaussian_splatting_torch/csrc/render_bwd.cu",
              "gaussian_splatting_tpu/ops/render.py:635",
              train_launches["render_bwd"], b2_abs,
              max_rel_err_per_row=b2_rel, run_to_run_spread=b2_spread),
        entry("render_sh_fwd", "render_sh_fwd (B3, per-pixel SH forward)",
              "gaussian_splatting_torch/csrc/render_sh_fwd.cu",
              "gaussian_splatting_tpu/ops/render_sh.py:93",
              sh_launches["render_sh_fwd"] + sh_train_launches["render_sh_fwd"], b3_err),
        entry("render_sh_bwd", "render_sh_bwd (B4, per-pixel SH backward)",
              "gaussian_splatting_torch/csrc/render_sh_bwd.cu",
              "gaussian_splatting_tpu/ops/render_sh.py:187",
              sh_train_launches["render_sh_bwd"], b4_abs,
              max_rel_err_per_row=b4_rel, run_to_run_spread=b4_spread),
    ]
    for key, label, source, replaces, point in PROBES:
        p = probes[key]
        kernels.append(dict(
            name=label, route="cuda", source=source, replaces=replaces,
            launches=probe_launches[key], max_abs_err=p["max_abs_err"], ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"], point=point))
    print(f"[time] training step {step_ms:.3f} ms, per-pixel SH training step "
          f"{sh_step_ms:.3f} ms (host clock; {smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
