"""The yardstick: what the rasterizer kernels and a whole step must do on
given inputs, in bytes and float32 operations, and the card's peaks.

A frozen copy of the program's arithmetic as it stood when the benchmark
was defined (``chip_smoke.py::kernel_bounds``, ``ops/render.py::dc_work``
and ``pair_counts``, the constants of ``timing.py``), so that no change to
the program moves it.  The pairs are counted with the plain reference's
own layout and walk (``reference/splat.py``), never read from the program.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the float32 rate: each input read once, each output
written once, and the operations of the splat-pixel pairs the walk reaches.
"""

from __future__ import annotations

import torch

from gsbench.reference import splat as ref

# NVIDIA H100 SXM, data sheet, at its 700 W limit: HBM3 and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# float32 operations per splat-pixel pair, counted from the kernels'
# sources: a pair a pixel reaches while T >= 1e-4 evaluates alpha (offsets,
# the conic quadratic, rdet, exp, opacity); a pair that composites (alpha >=
# 1/255) adds the rest.  Per-pixel SH adds 2 * 3 * n_sh for the colour
# contraction (B3, B4) and 2 * 3 * n_sh for the coefficient gradients (B4).
ALPHA_OPS = 15
FWD_COMPOSITE_OPS = 10  # weight, 3 colour multiply-adds, T update
BWD_COMPOSITE_OPS = 46  # clamp, weight, A, prefix, D, 1/(1-a), q, 9 rows, T
ALPHA_CLAMP = 0.9999  # the backward's clamp of alpha before 1/(1 - alpha)
F32 = 4

# Whole-step operations beside the pairs, per alive gaussian or per pixel,
# counted from the plain statement of each part (reference/splat.py):
# transform 18, projection 7, quaternion normalisation 12, rotation 42,
# scales 6, covariance 30, Jacobian 8, J.W 18, (J.W).Sigma 30, conic 17,
# sigmoid 4, the +0.25 and /2 of the features 3.
GEOMETRY_OPS = 195
# SH colour once per gaussian, beside the 2 * 3 * n_sh of the contraction:
# view direction and its norm 12, the basis (16 terms) 35, the two scalings 6.
SH_DIR_OPS = 53
# The per-pixel basis: ray 7, rotation 15, normalisation 12, basis 35.
PIXEL_BASIS_OPS = 69
# Adam per float of a parameter: first moment 3, second 4, the update with
# its bias corrections, square root, eps, rate and sign 7, the add and the
# step's select 2; 59 floats a gaussian (xyz 3, rgb 3, opacity 1, scale 3,
# rotation 4, sh 45).  The accumulators: |uv grad| * f and its add 6, |xyz
# grad| and its add 6.
ADAM_OPS_PER_FLOAT = 16
PARAM_FLOATS = 59
ACCUMULATOR_OPS = 12
# L1 + SSIM per pixel and channel: the difference and |.| 3, five blurred
# images of two 11-tap passes (2 * 11 * 2 each) 220, the SSIM map 16.
LOSS_OPS = 239
# A backward costs about twice its forward (two products per product).
BACKWARD_FACTOR = 2


def pair_counts(params: dict, alive, view: ref.View, chunk: int = 128) -> dict:
    """Splat-pixel pairs of the compositing walk on these inputs: the pairs
    each pixel reaches while T >= T_EPS ("evaluated") and those of them
    whose alpha reaches 1/255 ("composited"), with the forward's alpha and
    with the backward's, clamped at ALPHA_CLAMP; and the sizes the bounds
    read: splats, tiles, slots and alive gaussians."""
    with torch.no_grad():
        rows = ref.gaussian_rows(params, view)
        lay = ref.layout(rows, ref.visible(rows, alive, view), view)
        tiles = torch.arange(view.x_tiles * view.y_tiles, device=alive.device)
        zero = torch.zeros((), dtype=torch.int64, device=alive.device)
        sums = dict(evaluated=zero, composited=zero, evaluated_bwd=zero,
                    composited_bwd=zero)
        T_bwd = [torch.ones(len(tiles), ref.PIXELS, dtype=rows["u"].dtype,
                            device=alive.device)]

        def walk(T_in, at):
            prod = torch.cumprod(torch.cat([T_in[:, :, None], 1.0 - at], dim=2), dim=2)
            active = prod[..., :-1] >= ref.T_EPS
            return active, prod.gather(2, active.sum(dim=2, keepdim=True)).squeeze(2)

        def visit(n, ids, g, ok, alpha, T_in):
            keep = ok[:, None, :] & (alpha >= ref.ALPHA_SKIP)
            at = torch.where(keep, alpha, torch.zeros_like(alpha))
            active, T_out = walk(T_in, at)
            sums["evaluated"] = sums["evaluated"] + (active & ok[:, None, :]).sum()
            sums["composited"] = sums["composited"] + (active & keep).sum()
            at_b = torch.where(keep, alpha.clamp_max(ALPHA_CLAMP), torch.zeros_like(alpha))
            active_b, T_b = walk(T_bwd[0][:n], at_b)
            T_bwd[0] = torch.cat([T_b, T_bwd[0][n:]])
            sums["evaluated_bwd"] = sums["evaluated_bwd"] + (active_b & ok[:, None, :]).sum()
            sums["composited_bwd"] = sums["composited_bwd"] + (active_b & keep).sum()
            return T_out

        ref._walk(rows, lay, view, tiles, chunk, visit)
        out = {k: int(v) for k, v in sums.items()}
    out.update(splats=lay.num_splats, tiles=view.x_tiles * view.y_tiles,
               slots=int(alive.shape[0]), alive=int(alive.sum()), n_sh=view.n_sh)
    return out


def kernel_work(c: dict) -> dict:
    """(bytes, operations) of kernels B1-B4 on one view's pair counts ``c``:
    B1/B2 the DC rasterizer (9 feature rows a slot), B3/B4 the per-pixel SH
    rasterizer (6 + 3 n_sh rows and the basis)."""
    n_pix = c["tiles"] * ref.PIXELS
    layout_b = F32 * (c["splats"] + c["tiles"] + 1)
    raw_b = F32 * 4 * n_pix
    feat_b = F32 * 9 * c["slots"]
    sfeat_b = F32 * (6 + 3 * c["n_sh"]) * c["slots"]
    basis_b = F32 * c["n_sh"] * n_pix
    sh_ops = 2 * 3 * c["n_sh"]
    ev, co, ev_b, co_b = c["evaluated"], c["composited"], c["evaluated_bwd"], c["composited_bwd"]
    return {
        "render_fwd": (feat_b + layout_b + raw_b, ALPHA_OPS * ev + FWD_COMPOSITE_OPS * co),
        "render_bwd": (2 * feat_b + layout_b + 2 * raw_b,
                       ALPHA_OPS * ev_b + BWD_COMPOSITE_OPS * co_b),
        "render_sh_fwd": (sfeat_b + basis_b + layout_b + raw_b,
                          ALPHA_OPS * ev + (FWD_COMPOSITE_OPS + sh_ops) * co),
        "render_sh_bwd": (2 * sfeat_b + basis_b + layout_b + 2 * raw_b,
                          ALPHA_OPS * ev_b + (BWD_COMPOSITE_OPS + 2 * sh_ops) * co_b),
    }


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a kernel: the larger of its bytes over the memory
    rate and its operations over the float32 rate, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


def step_ops(c: dict, *, train: bool, per_pixel: bool) -> float:
    """float32 operations of one training step (``train``) or one served
    view on one view's counts: the pairs' work forward (and backward), and
    per alive gaussian the geometry and SH colour (forward, and backward),
    Adam and the accumulators; per pixel the basis (per-pixel SH) and the
    loss (forward and backward)."""
    k = kernel_work(c)
    fwd, bwd = ("render_sh_fwd", "render_sh_bwd") if per_pixel else ("render_fwd", "render_bwd")
    n_pix = c["tiles"] * ref.PIXELS
    sh = 0 if per_pixel else SH_DIR_OPS + 2 * 3 * c["n_sh"]
    per_gaussian = GEOMETRY_OPS + sh
    ops = k[fwd][1] + c["alive"] * per_gaussian
    if per_pixel:
        ops += n_pix * PIXEL_BASIS_OPS
    if train:
        ops += k[bwd][1] + c["alive"] * per_gaussian * BACKWARD_FACTOR
        ops += c["alive"] * (PARAM_FLOATS * ADAM_OPS_PER_FLOAT + ACCUMULATOR_OPS)
        ops += n_pix * 3 * LOSS_OPS * (1 + BACKWARD_FACTOR)
    return float(ops)


def roofline(t, kernel: str):
    """Percent of its bound that ``kernel`` reached in the traced stretch
    ``t``: the sum of the bounds of its traced launches, on the pairs the
    plain reference's layout counts for each launch's inputs, over its
    device time there; None if it did not run or nothing was counted."""
    time_s = t.kernel_s(kernel)
    if time_s is None or not t.work:
        return None
    return 100.0 * sum(bound_s(*kernel_work(c)[kernel]) for c in t.work) / time_s


def mfu(t, *, train: bool):
    """Percent of the card's float32 peak that a whole step (``train``) or
    view reached: the operations of the traced steps' inputs
    (``step_ops``), averaged over them, over the seconds a step took on the
    host's clock in the same run outside the traced stretch (where the
    profiler's own host work does not slow the host); None if nothing was
    counted."""
    if not t.work:
        return None
    ops = sum(step_ops(c, train=train, per_pixel=t.per_pixel) for c in t.work) / len(t.work)
    return 100.0 * ops / (t.step_s * PEAK_F32_PER_S)
