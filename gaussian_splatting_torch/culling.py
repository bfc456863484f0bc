"""Frustum culling, tile assignment and per-tile depth order (counterpart
of ``gaussian_splatting_tpu/culling.py``).

Every visible gaussian gets an oriented bounding box of its mh_dist-sigma
ellipse, a clipped tile window, and a separating-axis test against each
window tile (the reference's ``compute_obb`` / ``split_axis_test``).  The
(gaussian, tile) hits are sorted once, by an int64 key
``tile << 32 | float32_bits(z)``: for z > 0 the bit pattern is monotone in
z, so the order is exact, as the reference's fp64 key was.  The JAX package
sorts a quantised int32 key instead; the two orders differ only where two
depths agree to within that quantisation.

The layout is dynamic in size: ``gaussian_idx`` holds exactly the live
splats, grouped by tile and front to back within a tile.  This is tensor
code; the JAX package does the same work in XLA, not in a kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.structs import TILE_PX, TileGrid

# A window larger than this many tiles renders only its first MAX_WINDOW_CELLS
# cells in enumeration order (x outer, y inner); the rest are counted in
# SplatLayout.truncated.  Same cap as the JAX package's TIER_CELLS[-1].
MAX_WINDOW_CELLS = 4096


class SplatLayout(NamedTuple):
    """Tile-grouped, depth-sorted splat list.

    gaussian_idx   : (S,) int32   gaussian id per splat, S = num_splats;
                     tile t owns [tile_starts[t], tile_starts[t+1])
    tile_starts    : (n_tiles+1,) int32
    tile_counts    : (n_tiles,) int32
    tile_has_output: (n_tiles,) bool   tile has at least one splat
    num_splats     : int   live (gaussian, tile) pairs
    num_visible    : int   gaussians with at least one window cell
    truncated      : int   window cells dropped past MAX_WINDOW_CELLS
    """

    gaussian_idx: torch.Tensor
    tile_starts: torch.Tensor
    tile_counts: torch.Tensor
    tile_has_output: torch.Tensor
    num_splats: int
    num_visible: int
    truncated: int


def frustum_visible_rows(u, v, z, grid_wh, near_thresh, far_thresh,
                         cull_mask_padding):
    """Visibility mask from (N,) rows.  ``far_thresh=inf`` gives the depth
    renderer's no-far-cull."""
    width, height = grid_wh
    culled = (z < near_thresh) | (z > far_thresh)
    culled |= (u < -cull_mask_padding) | (u > width + cull_mask_padding)
    culled |= (v < -cull_mask_padding) | (v > height + cull_mask_padding)
    return ~culled


def _obb_and_radius(u, v, a, b, c, mh_dist):
    """Ellipse OBB corners and tile search radius per gaussian.

    a/b/c are the regularised 2D covariance entries (a = conic0 + 0.25,
    b = conic1 / 2, c = conic2 + 0.25); ``mh_dist`` is a float or an (N,)
    tensor.  Returns obb (N, 8) packed [tlx,tly,trx,try,blx,bly,brx,bry]
    and radius_tiles (N,) int32.
    """
    mean = (a + c) * 0.5
    half = torch.sqrt((a - c) * (a - c) * 0.25 + b * b)
    lam1 = mean + half
    lam2 = mean - half
    r_major = mh_dist * torch.sqrt(lam1.clamp_min(0.0))
    r_minor = mh_dist * torch.sqrt(lam2.clamp_min(0.0))

    theta = torch.where(
        b.abs() < 1e-16,
        torch.where(a >= c, torch.zeros_like(a),
                    torch.full_like(a, math.pi / 2)),
        torch.atan2(lam1 - a, b),
    )
    ct, st = torch.cos(theta), torch.sin(theta)
    obb = torch.stack(
        [
            -r_major * ct + r_minor * st + u,
            -r_major * st - r_minor * ct + v,
            r_major * ct + r_minor * st + u,
            r_major * st - r_minor * ct + v,
            -r_major * ct - r_minor * st + u,
            -r_major * st + r_minor * ct + v,
            r_major * ct - r_minor * st + u,
            r_major * st + r_minor * ct + v,
        ],
        dim=-1,
    )
    radius_tiles = torch.ceil(r_major / TILE_PX).to(torch.int32) + 1
    return obb, radius_tiles


def _split_axis_test(obb, tile_x, tile_y):
    """Separating-axis test of OBBs (..., 8) against 16 px tiles at integer
    tile coordinates tile_x / tile_y (...)."""
    left = tile_x.to(obb.dtype) * TILE_PX
    right = left + TILE_PX
    top = tile_y.to(obb.dtype) * TILE_PX
    bottom = top + TILE_PX

    xs = obb[..., 0::2]
    ys = obb[..., 1::2]
    # axis 0: X
    ok = ~((xs.amin(-1) > right) | (xs.amax(-1) < left))
    # axis 1: Y
    ok &= ~((ys.amin(-1) > bottom) | (ys.amax(-1) < top))

    def axis_overlap(ax, ay, p0x, p0y, p1x, p1y):
        tl = ax * left + ay * top
        tr = ax * right + ay * top
        bl = ax * left + ay * bottom
        br = ax * right + ay * bottom
        tmin = torch.minimum(torch.minimum(tl, tr), torch.minimum(bl, br))
        tmax = torch.maximum(torch.maximum(tl, tr), torch.maximum(bl, br))
        o0 = ax * p0x + ay * p0y
        o1 = ax * p1x + ay * p1y
        omin = torch.minimum(o0, o1)
        omax = torch.maximum(o0, o1)
        return ~((tmin > omax) | (tmax < omin))

    # axis 2: OBB major axis (top-right - top-left)
    ok &= axis_overlap(
        obb[..., 2] - obb[..., 0], obb[..., 3] - obb[..., 1],
        obb[..., 0], obb[..., 1], obb[..., 2], obb[..., 3],
    )
    # axis 3: OBB minor axis (top-right - bottom-right)
    ok &= axis_overlap(
        obb[..., 2] - obb[..., 6], obb[..., 3] - obb[..., 7],
        obb[..., 2], obb[..., 3], obb[..., 6], obb[..., 7],
    )
    return ok


def _window(obb, x_tiles, y_tiles):
    """Clipped candidate tile window (sx, sy, wx, wy) from the OBB's
    axis-aligned bounds, each (N,) int64."""
    xs = obb[:, 0::2]
    ys = obb[:, 1::2]

    def lo_hi(vals, n):
        # clamped before the cast, so a huge footprint saturates alike on
        # every device
        lo = torch.floor(vals.amin(1) / TILE_PX).clamp(0, n)
        hi = (torch.floor(vals.amax(1) / TILE_PX) + 1).clamp(0, n)
        return lo.to(torch.int64), hi.to(torch.int64)

    sx, ex = lo_hi(xs, x_tiles)
    sy, ey = lo_hi(ys, y_tiles)
    return sx, sy, (ex - sx).clamp_min(0), (ey - sy).clamp_min(0)


def _depth_bits(z):
    """int64 sort key of a positive depth: its float32 bit pattern."""
    zf = z.to(torch.float32).clamp_min(1e-30)
    return zf.view(torch.int32).to(torch.int64)


def build_layout(u, v, conic, z, visible, grid: TileGrid, mh_dist: float,
                 opacity: Optional[torch.Tensor] = None) -> SplatLayout:
    """Assign gaussians to tiles and depth-sort each tile's list.

    u, v, z, visible: (N,) rows; conic: (c0, c1, c2) rows of [a, 2b, c].
    ``opacity`` (post-sigmoid, (N,)) turns on the render path's
    opacity-aware window: a gaussian with opacity <= ALPHA_SKIP is
    invisible, and the window shrinks to the ellipse where alpha can still
    reach ALPHA_SKIP.  Without it (golden splat lists) the window is the
    pure mh_dist ellipse.
    """
    a = conic[0] + 0.25
    b = conic[1] * 0.5
    c = conic[2] + 0.25

    # non-finite entries are invisible, so the sort keys stay well ordered
    finite = torch.isfinite(u) & torch.isfinite(v) & torch.isfinite(z)
    finite &= torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    visible = visible & finite
    u = torch.where(finite, u, torch.zeros_like(u))
    v = torch.where(finite, v, torch.zeros_like(v))
    a = torch.where(finite, a, torch.ones_like(a))
    b = torch.where(finite, b, torch.zeros_like(b))
    c = torch.where(finite, c, torch.ones_like(c))

    if opacity is not None:
        # cells whose whole tile lies beyond the iso-alpha ellipse
        # {mh = 2 ln(op / ALPHA_SKIP)} contribute nothing
        q_max = 2.0 * torch.log(opacity.clamp_min(1e-12) * (1.0 / cc.ALPHA_SKIP))
        mh_eff = torch.sqrt(q_max.clamp_min(0.0)).clamp_max(mh_dist)
        visible = visible & (opacity > cc.ALPHA_SKIP)
    else:
        mh_eff = mh_dist

    obb, _ = _obb_and_radius(u, v, a, b, c, mh_eff)
    sx, sy, wx, wy = _window(obb, grid.x_tiles, grid.y_tiles)
    area = torch.where(visible, wx * wy, torch.zeros_like(wx))
    contributes = area > 0
    num_visible = int(contributes.sum())
    truncated = int((area - MAX_WINDOW_CELLS).clamp_min(0).sum())

    # enumerate each window's first MAX_WINDOW_CELLS cells, x outer / y inner
    gid_c = torch.nonzero(contributes).squeeze(1)
    cells = area[gid_c].clamp_max(MAX_WINDOW_CELLS)
    gid = torch.repeat_interleave(gid_c, cells)
    first = torch.cumsum(cells, 0) - cells
    k = torch.arange(gid.numel(), device=gid.device) - torch.repeat_interleave(
        first, cells
    )
    wy_g = wy[gid]
    tx = sx[gid] + k // wy_g
    ty = sy[gid] + k % wy_g
    hit = _split_axis_test(obb[gid], tx, ty)
    gid, tx, ty = gid[hit], tx[hit], ty[hit]

    tile = ty * grid.x_tiles + tx
    key = (tile << 32) | _depth_bits(z)[gid]
    key, order = torch.sort(key, stable=True)
    gaussian_idx = gid[order].to(torch.int32)
    tile_sorted = key >> 32
    tile_ids = torch.arange(grid.tile_count + 1, device=key.device,
                            dtype=torch.int64)
    starts = torch.searchsorted(tile_sorted, tile_ids).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    return SplatLayout(
        gaussian_idx=gaussian_idx,
        tile_starts=starts,
        tile_counts=counts,
        tile_has_output=counts > 0,
        num_splats=int(gaussian_idx.numel()),
        num_visible=num_visible,
        truncated=truncated,
    )


def sorted_splat_list(layout: SplatLayout):
    """The dense depth-sorted gaussian list and the (n_tiles+1,) tile
    boundaries as numpy arrays, as the reference's
    ``get_sorted_gaussian_list`` returns them.  For tests and tooling."""
    return (layout.gaussian_idx.cpu().numpy(),
            layout.tile_starts.cpu().numpy().astype(np.int32))
