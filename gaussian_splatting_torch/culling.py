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
splats, grouped by tile and front to back within a tile.  It dispatches on
the device of its rows: on a CUDA tensor it launches the hand-written
layout ``csrc/layout.cu`` (a count kernel and a scan, one host read of the
layout's sizes, a fill kernel, one radix sort), on a CPU tensor it runs
``_layout_plain``, the same work as tensor code.  There is no fallback from
one to the other, and the two give the same layout bit for bit.  The JAX
package does this work in XLA, not in a kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_torch import _build, telemetry
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.structs import TILE_PX, TileGrid

# A window larger than this many tiles renders only its first MAX_WINDOW_CELLS
# cells in enumeration order (x outer, y inner); the rest are counted in
# SplatLayout.truncated.  Same cap as the JAX package's TIER_CELLS[-1].
MAX_WINDOW_CELLS = 4096
# candidate cells per piece of the plain layout's separating-axis test: its
# temporaries stay this size whatever the splat count
SAT_CHUNK = 1 << 21


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


def frustum_visible(xyz_camera, uv, grid_wh, near_thresh, far_thresh,
                    cull_mask_padding):
    """(N, C)-array wrapper over ``frustum_visible_rows``: camera-frame xyz
    (N, 3) and uv (N, 2) -> (N,) bool."""
    return frustum_visible_rows(uv[:, 0], uv[:, 1], xyz_camera[:, 2], grid_wh,
                                near_thresh, far_thresh, cull_mask_padding)


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


def _regularised(conic):
    """The regularised 2D covariance entries a = conic0 + 0.25, b = conic1 / 2,
    c = conic2 + 0.25 of the raw [a, 2b, c] rows, with the feature rows'
    operations (``ops.render.splat_feature_rows``)."""
    return conic[0] + 0.25, conic[1] * 0.5, conic[2] + 0.25


def _sanitised(u, v, a, b, c, z):
    """(finite, u, v, a, b, c) of the regularised entries a, b, c: each
    gaussian with a non-finite u, v, z, a, b or c marked not finite and
    given u = v = b = 0, a = c = 1, so the sort keys stay well ordered."""
    finite = torch.isfinite(u) & torch.isfinite(v) & torch.isfinite(z)
    finite &= torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    u = torch.where(finite, u, torch.zeros_like(u))
    v = torch.where(finite, v, torch.zeros_like(v))
    a = torch.where(finite, a, torch.ones_like(a))
    b = torch.where(finite, b, torch.zeros_like(b))
    c = torch.where(finite, c, torch.ones_like(c))
    return finite, u, v, a, b, c


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
    return _layout(u, v, *_regularised(conic), z, visible, grid, mh_dist, opacity)


def feature_layout(feat, z, visible, grid: TileGrid, mh_dist: float) -> SplatLayout:
    """``build_layout`` of the rasterizer's feature rows (``ops.geometry.
    splat_rows``): u, v, opacity, a + 1/4, b / 2, c + 1/4, with the
    opacity-aware window.  Bit for bit the layout ``build_layout`` gives
    the rows they were formed from: the feature rows hold the regularised
    entries it would form."""
    return _layout(feat[cc.FEAT_U], feat[cc.FEAT_V], feat[cc.FEAT_A], feat[cc.FEAT_B],
                   feat[cc.FEAT_C], z, visible, grid, mh_dist, feat[cc.FEAT_OPACITY])


def _layout(u, v, a, b, c, z, visible, grid: TileGrid, mh_dist: float,
            opacity: Optional[torch.Tensor]) -> SplatLayout:
    """``build_layout`` of the regularised entries a, b, c: the kernels on a
    CUDA tensor, ``_layout_plain`` on a CPU tensor."""
    if u.device.type == "cpu":
        return _layout_plain(u, v, a, b, c, z, visible, grid, mh_dist, opacity)
    if not u.is_cuda:
        raise ValueError(f"build_layout: no kernel for device {u.device}")
    return _layout_cuda(u, v, a, b, c, z, visible, grid, mh_dist, opacity)


def _row_args(rows):
    """(pointers, strides in elements) of the layout's (N,) rows on one CUDA
    device, as the launchers take them (0 for an absent opacity)."""
    n, dev = rows[0].shape[0], rows[0].device
    for name, t in zip(("u", "v", "a", "b", "c", "z", "visible", "opacity"), rows):
        if t is None:
            continue
        want = torch.bool if name == "visible" else torch.float32
        if t.dtype != want or t.device != dev or tuple(t.shape) != (n,):
            raise ValueError(f"build_layout: {name} must be {want} ({n},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ptrs = (ctypes.c_longlong * 8)(*(0 if t is None else t.data_ptr() for t in rows))
    strides = (ctypes.c_longlong * 8)(*(0 if t is None else t.stride(0) for t in rows))
    return ptrs, strides


def _temp_bytes(lib, n: int, s: int, end_bit: int):
    """(scan, sort) scratch bytes of ``n`` counts and ``s`` keys."""
    out = (ctypes.c_longlong * 2)()
    _build.check(lib.gs_layout_temp_bytes(n, s, end_bit, out), "gs_layout_temp_bytes")
    return out[0], out[1]


def _layout_cuda(u, v, a, b, c, z, visible, grid: TileGrid, mh_dist: float,
                 opacity: Optional[torch.Tensor]) -> SplatLayout:
    """``_layout_plain``'s layout from the kernels of ``csrc/layout.cu``, on
    the current stream, with one blocking read: the layout's three sizes,
    which size its buffers."""
    rows = (u, v, a, b, c, z, visible, opacity)
    ptrs, strides = _row_args(rows)
    n, dev = u.shape[0], u.device
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid_args = (float(mh_dist), grid.x_tiles, grid.y_tiles)
    # the key's bits: the depth's 32 under the tile index's
    end_bit = 32 + (grid.tile_count - 1).bit_length()
    with telemetry.span("gs::layout.count"):
        counts = torch.empty(n, dtype=torch.int32, device=dev)
        first = torch.empty(n, dtype=torch.int32, device=dev)
        sizes = torch.empty(3, dtype=torch.int64, device=dev)
        scan_bytes, _ = _temp_bytes(lib, n, 0, end_bit)
        temp = torch.empty(scan_bytes, dtype=torch.uint8, device=dev)
        err = lib.gs_layout_count(ptrs, strides, n, *grid_args, counts.data_ptr(),
                                  first.data_ptr(), sizes.data_ptr(), temp.data_ptr(),
                                  scan_bytes, stream)
        _build.check(err, "gs_layout_count")
        telemetry.LAUNCHES["layout_count"] += 1
        del temp
        num_splats, num_visible, truncated = sizes.tolist()
        telemetry.count("sync.layout.size")
    if num_splats >= 1 << 31:
        raise ValueError(f"build_layout: {num_splats} splats do not fit an int32 index")

    with telemetry.span("gs::layout.fill"):
        keys = torch.empty(num_splats, dtype=torch.int64, device=dev)
        ids = torch.empty(num_splats, dtype=torch.int32, device=dev)
        err = lib.gs_layout_fill(ptrs, strides, n, *grid_args, counts.data_ptr(),
                                 first.data_ptr(), keys.data_ptr(), ids.data_ptr(), stream)
        _build.check(err, "gs_layout_fill")
        telemetry.LAUNCHES["layout_fill"] += 1
        del counts, first

    with telemetry.span("gs::layout.sort"):
        keys_alt = torch.empty_like(keys)
        ids_alt = torch.empty_like(ids)
        _, sort_bytes = _temp_bytes(lib, n, num_splats, end_bit)
        temp = torch.empty(sort_bytes, dtype=torch.uint8, device=dev)
        starts = torch.empty(grid.tile_count + 1, dtype=torch.int32, device=dev)
        tile_counts = torch.empty(grid.tile_count, dtype=torch.int32, device=dev)
        has_output = torch.empty(grid.tile_count, dtype=torch.bool, device=dev)
        selector = ctypes.c_int(0)
        err = lib.gs_layout_sort(keys.data_ptr(), keys_alt.data_ptr(), ids.data_ptr(),
                                 ids_alt.data_ptr(), num_splats, end_bit, temp.data_ptr(),
                                 sort_bytes, grid.tile_count, starts.data_ptr(),
                                 tile_counts.data_ptr(), has_output.data_ptr(),
                                 ctypes.byref(selector), stream)
        _build.check(err, "gs_layout_sort")
        gaussian_idx = ids_alt if selector.value else ids
        del keys, keys_alt, ids, ids_alt, temp
    telemetry.count("splats", num_splats)
    telemetry.count("visible", num_visible)
    telemetry.count("truncated_cells", truncated)
    return SplatLayout(
        gaussian_idx=gaussian_idx,
        tile_starts=starts,
        tile_counts=tile_counts,
        tile_has_output=has_output,
        num_splats=num_splats,
        num_visible=num_visible,
        truncated=truncated,
    )


def _layout_plain(u, v, a, b, c, z, visible, grid: TileGrid, mh_dist: float,
                  opacity: Optional[torch.Tensor]) -> SplatLayout:
    """Plain PyTorch version of the layout kernels (``_layout``'s CPU path).

    Each temporary is let go once it has been read, the candidate cells are
    held as int32 (gaussian, tile x, tile y: 12 bytes a cell), and the
    separating-axis test runs over them in pieces of SAT_CHUNK: the
    layout's memory peak is its (N,) rows' and one piece's, and hardly
    moves with the splat count.
    """
    with telemetry.span("gs::layout.cull"):
        finite, u, v, a, b, c = _sanitised(u, v, a, b, c, z)
        visible = visible & finite
        del finite

        if opacity is not None:
            # cells whose whole tile lies beyond the iso-alpha ellipse
            # {mh = 2 ln(op / ALPHA_SKIP)} contribute nothing
            q_max = 2.0 * torch.log(opacity.clamp_min(1e-12) * (1.0 / cc.ALPHA_SKIP))
            mh_eff = torch.sqrt(q_max.clamp_min(0.0)).clamp_max(mh_dist)
            del q_max
            visible = visible & (opacity > cc.ALPHA_SKIP)
        else:
            mh_eff = mh_dist

        obb, _ = _obb_and_radius(u, v, a, b, c, mh_eff)
        del u, v, a, b, c, mh_eff
        sx, sy, wx, wy = _window(obb, grid.x_tiles, grid.y_tiles)
        area = torch.where(visible, wx * wy, torch.zeros_like(wx))
        del visible, wx
        # tile coordinates and window heights are below the grid's size
        sx, sy, wy = sx.to(torch.int32), sy.to(torch.int32), wy.to(torch.int32)
        contributes = area > 0
        num_visible = int(contributes.sum())
        telemetry.count("sync.layout.visible")
        truncated = int((area - MAX_WINDOW_CELLS).clamp_min(0).sum())
        telemetry.count("sync.layout.truncated")

    with telemetry.span("gs::layout.enumerate"):
        # enumerate each window's first MAX_WINDOW_CELLS cells, x outer / y inner
        gid_c = torch.nonzero(contributes).squeeze(1)
        telemetry.count("sync.layout.nonzero")
        cells = area[gid_c].clamp_max(MAX_WINDOW_CELLS)
        del contributes, area
        # a repeat_interleave with tensor repeats reads twice: the output's
        # size, and the check that no repeat is negative
        gid = torch.repeat_interleave(gid_c.to(torch.int32), cells)
        telemetry.count("sync.layout.repeat_gid", 2)
        del gid_c
        first = torch.cumsum(cells, 0) - cells
        k = torch.arange(gid.numel(), device=gid.device) - torch.repeat_interleave(
            first, cells
        )
        telemetry.count("sync.layout.repeat_first", 2)
        del first, cells
        k = k.to(torch.int32)  # the cell's place in its window, below MAX_WINDOW_CELLS
        wy_g = wy.index_select(0, gid)
        tx = sx.index_select(0, gid) + k // wy_g
        ty = sy.index_select(0, gid) + k % wy_g
        del k, wy_g, sx, sy, wy

    with telemetry.span("gs::layout.sat"):
        hit = torch.empty(gid.numel(), dtype=torch.bool, device=gid.device)
        for s in range(0, gid.numel(), SAT_CHUNK):
            e = s + SAT_CHUNK
            hit[s:e] = _split_axis_test(obb.index_select(0, gid[s:e]), tx[s:e], ty[s:e])
        del obb
        gid = gid[hit]
        telemetry.count("sync.layout.hit_gid")
        tx = tx[hit]
        telemetry.count("sync.layout.hit_tx")
        ty = ty[hit]
        telemetry.count("sync.layout.hit_ty")
        del hit

    with telemetry.span("gs::layout.sort"):
        tile = (ty * grid.x_tiles + tx).to(torch.int64)
        del tx, ty
        key = (tile << 32) | _depth_bits(z).index_select(0, gid)
        del tile
        key, order = torch.sort(key, stable=True)
        gaussian_idx = gid[order]
        del gid, order
        tile_sorted = key >> 32
        del key
        tile_ids = torch.arange(grid.tile_count + 1, device=tile_sorted.device,
                                dtype=torch.int64)
        starts = torch.searchsorted(tile_sorted, tile_ids).to(torch.int32)
        counts = starts[1:] - starts[:-1]
    num_splats = int(gaussian_idx.numel())
    telemetry.count("splats", num_splats)
    telemetry.count("visible", num_visible)
    telemetry.count("truncated_cells", truncated)
    return SplatLayout(
        gaussian_idx=gaussian_idx,
        tile_starts=starts,
        tile_counts=counts,
        tile_has_output=counts > 0,
        num_splats=num_splats,
        num_visible=num_visible,
        truncated=truncated,
    )


def _rows_of(uv, conic):
    """u, v and the conic's three rows from (N, 2) / (N, 3) arrays or from
    tuples of (N,) rows."""
    u, v = uv if isinstance(uv, tuple) else uv.unbind(1)
    return u, v, tuple(conic) if isinstance(conic, tuple) else tuple(conic.unbind(1))


def build_splat_layout(uv, conic, z_camera, visible, grid: TileGrid,
                       mh_dist: float) -> SplatLayout:
    """The layout alone, for tests and tooling (the JAX package's
    ``build_splat_layout``).  uv (N, 2) and conic (N, 3) [a, 2b, c] are
    arrays or tuples of (N,) rows; the window is the pure mh_dist ellipse.

    It takes none of the JAX function's ``splat_capacity``, ``chunk``,
    ``visible_capacity``, ``tier_capacities`` or ``precision``: the port's
    layout holds exactly the live splats, sorts one exact int64 key, and
    has no capacity to overflow and no bfloat16 sort operands.
    """
    u, v, rows = _rows_of(uv, conic)
    return build_layout(u, v, rows, z_camera, visible, grid, mh_dist)


class _CarryColumns(torch.autograd.Function):
    """carried[:, gid] in the forward; the cotangent of each splat column
    summed onto its gaussian's column of ``feat_g`` in the backward."""

    @staticmethod
    def forward(ctx, feat_g, carried, gid):
        ctx.save_for_backward(gid)
        ctx.n = feat_g.shape[1]
        return carried.index_select(1, gid)

    @staticmethod
    def backward(ctx, grad):
        (gid,) = ctx.saved_tensors
        out = grad.new_zeros(grad.shape[0], ctx.n)
        return out.index_add_(1, gid, grad), None, None


def layout_with_features(uv, conic, z_camera, visible, feat_g, grid: TileGrid,
                         mh_dist: float):
    """(layout, feat): the layout and the per-splat columns of the (R, N)
    per-gaussian rows ``feat_g``, (R, num_splats), differentiable in
    ``feat_g`` only (the JAX package's ``layout_with_features``).  uv and
    conic as in ``build_splat_layout``, which says which of the JAX
    function's arguments it does not take, and why.

    As in the JAX function, a bundle of at least 6 rows is the rasterizer's
    (u, v, opacity, a, b, c, ...): its rows 0, 1, 3, 4, 5 are replaced by
    the layout's own sanitised u, v, a, b, c (the same values for finite
    entries of a bundle that follows ``ops.render.splat_feature_rows``),
    and row 2, the opacity, turns on the opacity-aware window.  A shorter
    bundle is carried as it is and the window is the pure mh_dist ellipse.
    The backward sums each splat's cotangent onto its gaussian, every row
    onto ``feat_g`` (the JAX function inverts its two sort permutations
    for this, ``culling._reduce_splat_grads``); uv, conic and z get none.
    """
    u, v, rows = _rows_of(uv, conic)
    carried, opacity = feat_g.detach(), None
    if feat_g.shape[0] >= 6:
        _, su, sv, a, b, c = _sanitised(u, v, *_regularised(rows), z_camera)
        carried = torch.cat([torch.stack([su, sv, carried[2], a, b, c]).detach(),
                             carried[6:]])
        opacity = carried[2]
    layout = build_layout(u.detach(), v.detach(), tuple(r.detach() for r in rows),
                          z_camera.detach(), visible, grid, mh_dist, opacity=opacity)
    gid = layout.gaussian_idx.long()
    return layout, _CarryColumns.apply(feat_g, carried, gid)


def sorted_splat_list(layout: SplatLayout):
    """The dense depth-sorted gaussian list and the (n_tiles+1,) tile
    boundaries as numpy arrays, as the reference's
    ``get_sorted_gaussian_list`` returns them.  For tests and tooling."""
    return (layout.gaussian_idx.cpu().numpy(),
            layout.tile_starts.cpu().numpy().astype(np.int32))
