"""B1 and B2 alone at bench scale (counterpart of
``experiments/kernel_bench.py``).

A synthetic tile-grouped splat list shaped like the JAX package's bench
workload: 1296x840 (4,293 tiles) and 459 live splats in every tile,
1,970,487 splats, drawn from ``default_rng(0)`` in the JAX script's order:
u and v from 4 px before their tile to 4 px past it, opacity U(0.1, 0.9),
the covariance rows a, c U(1, 40) with the +0.25 regularisation and
b = U(-0.3, 0.3) * sqrt(a c), colour U(0, 3.5); then the backward's
cotangent U(-1, 1) in the raw output's shape.  In the port's layout each
splat is a gaussian of its own: ``gaussian_idx = arange`` and
``tile_starts = arange(n_tiles + 1) * 459``.

Each kernel is held to its plain version at this size (image and T where
T >= 1e-4 within 1e-4; the backward within 1e-4 of each gradient row's
largest) and timed against it on ``timing.Timer``'s clock: B1 as it runs
on the main path (the pack, the tile order and the walk), B2 alone.  Each
kernel's bound counts the pairs these inputs make (``ops.render.dc_work``,
as ``chip_smoke.py``'s ``kernel_bounds`` does for garden view 0).  The JAX script's ``chunk`` and ``precision``
arguments size the Pallas kernels' steps and pick bfloat16 matmul operands;
the CUDA kernels have neither, so this script takes neither.

    python -m gaussian_splatting_torch.experiments.kernel_bench [--device cuda]

On ``--device cpu`` the dispatchers run the plain versions at a cut size of
the port's own (64x48, 12 tiles of 64 splats).
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch import timing
from gaussian_splatting_torch.experiments import device_label, probe_args
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops.render import (
    dc_work,
    render_bwd,
    render_bwd_plain,
    render_fwd,
    render_fwd_plain,
)
from gaussian_splatting_torch.structs import TILE_PX, TileGrid

HEIGHT, WIDTH = 840, 1296
HEIGHT_CPU, WIDTH_CPU = 48, 64
DEPTH = 459  # live splats per tile (the JAX bench probe's ~1.97M / 4293)
# the plain walks take a step for every 32 splats of a tile: two on the CPU
DEPTH_CPU = 64
SEED = 0
IMG_TOL = 1e-4
T_TOL = 1e-4  # where the plain T >= T_EPS (below it the kernel stops)
BWD_REL_TOL = 1e-4  # of each gradient row's largest magnitude


def bench_inputs(device, height: int = HEIGHT, width: int = WIDTH, depth: int = DEPTH):
    """(feat (9, S), gaussian_idx, tile_starts, x_tiles, cotangent (4, n_tiles*256))
    on ``device``, the JAX script's draws in its order."""
    grid = TileGrid(height, width)
    n_tiles, x_tiles = grid.tile_count, grid.x_tiles
    s_live = n_tiles * depth
    rng = np.random.default_rng(SEED)
    tile_of = np.repeat(np.arange(n_tiles), depth)
    tx, ty = tile_of % x_tiles, tile_of // x_tiles
    u = tx * TILE_PX + rng.uniform(-4, 20, s_live)
    v = ty * TILE_PX + rng.uniform(-4, 20, s_live)
    op = rng.uniform(0.1, 0.9, s_live)
    sa = rng.uniform(1.0, 40.0, s_live)
    sc = rng.uniform(1.0, 40.0, s_live)
    sb = rng.uniform(-0.3, 0.3, s_live) * np.sqrt(sa * sc)
    rgb = rng.uniform(0, 3.5, (3, s_live))
    feat = np.stack([u, v, op, sa + 0.25, sb, sc + 0.25, *rgb]).astype(np.float32)
    cot = rng.uniform(-1, 1, (4, n_tiles * cc.PIXELS_PER_TILE)).astype(np.float32)
    dev = torch.device(device)
    gaussian_idx = torch.arange(s_live, dtype=torch.int32, device=dev)
    tile_starts = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) * depth
    return (torch.from_numpy(feat).to(dev), gaussian_idx, tile_starts, x_tiles,
            torch.from_numpy(cot).to(dev))


def run(device) -> dict:
    """B1 and B2 against their plain versions at the bench point (the cut
    point on the CPU): errors, ms, plain ms, bound and the pairs counted.
    Raises if a kernel disagrees with its plain version."""
    timer = timing.Timer(device)
    size = (HEIGHT, WIDTH, DEPTH) if timer.cuda else (HEIGHT_CPU, WIDTH_CPU, DEPTH_CPU)
    feat, gid, starts, x_tiles, cot = bench_inputs(device, *size)
    args = (feat, gid, starts, x_tiles)

    raw = render_fwd(*args)
    plain = render_fwd_plain(*args)
    img_err = float((raw[:3] - plain[:3]).abs().max())
    t_mask = plain[3] >= cc.T_EPS
    t_err = float((raw[3] - plain[3]).abs()[t_mask].max()) if bool(t_mask.any()) else 0.0
    grad = render_bwd(*args, raw, cot)
    grad_plain = render_bwd_plain(*args, raw, cot)
    scale = grad_plain.abs().amax(dim=1).clamp_min(1e-30)
    bwd_rel = float(((grad - grad_plain).abs().amax(dim=1) / scale).max())
    bwd_abs = float((grad - grad_plain).abs().max())
    finite = bool(torch.isfinite(raw).all()) and bool(torch.isfinite(grad).all())
    del plain, grad, grad_plain

    fwd_ms, fwd_plain_ms, _ = timing.compare(
        timer, lambda: render_fwd(*args), lambda: render_fwd_plain(*args))
    bwd_ms, bwd_plain_ms, _ = timing.compare(
        timer, lambda: render_bwd(*args, raw, cot),
        lambda: render_bwd_plain(*args, raw, cot))

    work = dc_work(feat, gid, starts, x_tiles)
    b1 = timing.bound(*work["render_fwd"])
    b2 = timing.bound(*work["render_bwd"])
    ev, co = work["evaluated"], work["composited"]
    ev_b, co_b = work["evaluated_bwd"], work["composited_bwd"]
    out = dict(
        height=size[0], width=size[1], splats=gid.numel(), tiles=starts.numel() - 1,
        device=timer.device.type, clock=timer.clock,
        B1=dict(ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=b1[0], bound_by=b1[1],
                evaluated=ev, composited=co, img_err=img_err, t_err=t_err,
                ok=img_err <= IMG_TOL and t_err <= T_TOL),
        B2=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=b2[0], bound_by=b2[1],
                evaluated=ev_b, composited=co_b, rel_err=bwd_rel, abs_err=bwd_abs,
                ok=bwd_rel <= BWD_REL_TOL),
    )
    if not (finite and out["B1"]["ok"] and out["B2"]["ok"]):
        raise AssertionError(
            f"kernel_bench: B1 or B2 disagrees with its plain version (B1 image "
            f"{img_err:.3e}, T {t_err:.3e}; B2 {bwd_rel:.3e} of a row's max; finite "
            f"{finite})")
    return out


def lines(res: dict) -> list:
    """The report, one line a kernel."""
    head = (f"{res['splats']} splats in {res['tiles']} tiles of {res['splats'] // res['tiles']} "
            f"at {res['width']}x{res['height']}")
    b1, b2 = res["B1"], res["B2"]

    def share(k):
        # a share of the card's bound means something only on the card's clock
        return (f"{k['bound_ms'] / k['ms']:.1%} of it" if res["device"] == "cuda"
                else "share not measured on the CPU")

    return [
        f"B1 (pack, tile order, walk), {head}: {b1['ms']:.4f} ms, plain {b1['plain_ms']:.3f} "
        f"ms; bound {b1['bound_ms']:.4f} ms by {b1['bound_by']} ({b1['evaluated']} pairs "
        f"evaluated, {b1['composited']} composited), {share(b1)}; max|image| "
        f"{b1['img_err']:.2e} (tol {IMG_TOL}), max|T| {b1['t_err']:.2e} (tol {T_TOL}) "
        f"({res['clock']})",
        f"B2, {head}: {b2['ms']:.4f} ms, plain {b2['plain_ms']:.3f} ms; bound "
        f"{b2['bound_ms']:.4f} ms by {b2['bound_by']} ({b2['evaluated']} pairs evaluated, "
        f"{b2['composited']} composited), {share(b2)}; max|grad| "
        f"{b2['rel_err']:.2e} of a row's max (tol {BWD_REL_TOL}) ({res['clock']})",
    ]


def main(argv=None):
    args = probe_args("B1 and B2 alone at bench scale", argv)
    res = run(args.device)
    print(f"kernel_bench on {device_label(args.device)}", flush=True)
    for line in lines(res):
        print(line, flush=True)
    return res


if __name__ == "__main__":
    main()
