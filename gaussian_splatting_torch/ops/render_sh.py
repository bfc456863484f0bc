"""Per-pixel spherical-harmonics rasterizer: kernels B3 (forward) and B4
(backward) and their host side (counterpart of
``gaussian_splatting_tpu/ops/render_sh.py``).

Instead of one colour per gaussian, every pixel evaluates the SH basis at
its own world-frame view ray, and a splat's colour at pixel p is
colour_c(p) = sum_k coeff[c*n_sh + k] * basis[k, p]; the compositing is
the DC rasterizer's (``ops/render.py``).

``render_sh_fwd`` dispatches on the device of its input: on a CUDA tensor
it launches the hand-written kernel ``csrc/render_sh_fwd.cu`` (which
replaces the Pallas kernel ``gaussian_splatting_tpu/ops/render_sh.py::
_fwd_kernel``), on a CPU tensor it runs ``render_sh_fwd_plain``.  The
backward, ``csrc/render_sh_bwd.cu`` (replacing ``_bwd_kernel``),
dispatches the same way through ``render_sh_bwd``.  There is no fallback
from a kernel to its plain version.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch import _build
from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops.reference_impl import image_to_tiles
from gaussian_splatting_torch.ops.render import (
    PLAIN_CHUNK,
    _check_cuda_args,
    _check_layout_args,
    _check_raw_args,
    _finish,
    bwd_walk,
    fwd_walk,
    pack_fwd_rows_cuda,
    tile_order_cuda,
)

SH_BASE_ROWS = 6  # u, v, opacity, a, b, c: the DC feature matrix's first rows
KERNEL_N_SH = (4, 9, 16)  # the kernels' template instances (bands 1..3)


def sh_feat_rows(n_sh: int) -> int:
    """Rows of the per-pixel SH feature matrix: base + 3*n_sh coefficients."""
    return SH_BASE_ROWS + 3 * n_sh


def sh_splat_feature_rows(u, v, opacity_v, conic3, coeffs):
    """Per-gaussian rows ((N,) each, conic3 the raw [a, 2b, c] rows) and
    coefficients (N, 3, n_sh) -> the (6 + 3*n_sh, N) feature matrix.

    Rows: u, v, opacity, a + 1/4, b / 2, c + 1/4, then the coefficients in
    the order c*n_sh + k.  The DC coefficient is NOT scaled by SH_0: basis
    row 0 carries SH_0 (unlike the DC path, which folds SH_0 into colour).
    """
    n_sh = coeffs.shape[2]
    c0, c1, c2 = conic3
    base = torch.stack([u, v, opacity_v, c0 + 0.25, c1 * 0.5, c2 + 0.25])
    return torch.cat([base, coeffs.permute(1, 2, 0).reshape(3 * n_sh, -1)])


def build_pixel_basis(camera_K, camera_T_world, n_sh: int, grid):
    """SH basis at every pixel of the padded tile grid, (n_sh, n_tiles*256)
    in tile-major pixel order (``image_to_tiles``).  The view direction is
    the world-frame unit ray through the pixel."""
    rays = geo.compute_rays_in_world_frame(
        camera_K, grid.image_width_padded, grid.image_height_padded, camera_T_world)
    tiles = image_to_tiles(geo.sh_basis(rays, n_sh), grid)  # (n_tiles, 256, n_sh)
    return tiles.permute(2, 0, 1).reshape(n_sh, -1).contiguous()


def _sh_colour(feat, basis, n_sh):
    """Colour of the SH rows at every pixel, one (A, 256, C) channel at a
    time: sum_k coeff[c*n_sh + k] * basis[k, p], summed over k in order,
    as the kernels do."""
    bt = basis.reshape(n_sh, -1, cc.PIXELS_PER_TILE)

    def colour(gid, tiles):
        for ch in range(3):
            col = None
            for k in range(n_sh):
                term = (feat[SH_BASE_ROWS + ch * n_sh + k][gid][:, None, :]
                        * bt[k][tiles][:, :, None])
                col = term if col is None else col + term
            yield col
    return colour


def _sh_colour_grads(basis, n_sh):
    """d/d(coefficients), summed over the tile's pixels: (3*n_sh, A, C),
    sum_p (g_c * basis_k)[p] * w[p, s] as one batched product per chunk."""
    bt = basis.reshape(n_sh, -1, cc.PIXELS_PER_TILE)

    def colour_grads(gch, w, tiles):
        # gb[a, p, c*n_sh + k] = g_c * basis_k at pixel p of tile a
        gb = (gch[0:3, :, :, 0][:, None] * bt[:, tiles][None])  # (3, n_sh, A, 256)
        gb = gb.reshape(3 * n_sh, len(tiles), -1).permute(1, 2, 0)
        return torch.bmm(w.transpose(1, 2), gb).permute(2, 0, 1)
    return colour_grads


def _check_sh_args(name, feat, basis, gaussian_idx, tile_starts, contiguous=False):
    """The per-pixel SH entry points take an (n_sh, n_tiles*256) basis, for
    an n_sh the kernels are built for, beside (6 + 3*n_sh, N) features of
    the same type and device, and the layout.  Returns n_sh."""
    if basis.dim() != 2:
        raise ValueError(f"{name}: basis must be (n_sh, n_tiles*256), got {tuple(basis.shape)}")
    n_sh = basis.shape[0]
    if n_sh not in KERNEL_N_SH:
        raise ValueError(f"{name}: n_sh must be one of {KERNEL_N_SH}, got {n_sh}")
    _check_layout_args(name, feat, sh_feat_rows(n_sh), gaussian_idx, tile_starts)
    want = cc.PIXELS_PER_TILE * (tile_starts.numel() - 1)
    if basis.shape[1] != want:
        raise ValueError(f"{name}: basis must have {want} pixel columns, "
                         f"got {basis.shape[1]}")
    if basis.dtype != feat.dtype or basis.device != feat.device:
        raise ValueError(f"{name}: basis is {basis.dtype} on {basis.device}, "
                         f"feat {feat.dtype} on {feat.device}")
    if contiguous and not basis.is_contiguous():
        raise ValueError(f"{name}: basis must be contiguous")
    return n_sh


def render_sh_fwd_plain(feat, basis, gaussian_idx, tile_starts, x_tiles: int,
                        chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B3, same inputs and output.

    feat: (6 + 3*n_sh, N) from ``sh_splat_feature_rows``; basis: (n_sh,
    n_tiles*256) from ``build_pixel_basis``; gaussian_idx, tile_starts from
    ``culling.build_layout``.  Returns (4, n_tiles*256): premultiplied
    r, g, b and the final T of every tile pixel.
    """
    n_sh = basis.shape[0]
    return fwd_walk(feat, gaussian_idx, tile_starts, x_tiles,
                    _sh_colour(feat, basis, n_sh), chunk)


def render_sh_bwd_plain(feat, basis, gaussian_idx, tile_starts, x_tiles: int,
                        raw, grad_raw, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B4: the VJP of ``render_sh_fwd``'s
    raw output with the JAX backward's semantics (``ops/render.bwd_walk``),
    where A = sum_c g_c * colour_c.  Returns grad_feat (6 + 3*n_sh, N); the
    basis gets no gradient."""
    n_sh = basis.shape[0]
    return bwd_walk(feat, gaussian_idx, tile_starts, x_tiles, raw, grad_raw,
                    _sh_colour(feat, basis, n_sh), _sh_colour_grads(basis, n_sh),
                    chunk)


def render_sh_fwd_cuda(feat, basis, gaussian_idx, tile_starts, x_tiles: int):
    """Launch kernel B3 on the current stream; same contract as
    ``render_sh_fwd_plain``.  Like B1, three launches: the pack of ``feat``
    into gaussian-major records (``ops/render.py::pack_fwd_rows_cuda``), the
    tile order (``tile_order_cuda``), then the walk."""
    n_sh = _check_sh_args("render_sh_fwd", feat, basis, gaussian_idx, tile_starts,
                          contiguous=True)
    _check_cuda_args("render_sh_fwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    out = torch.empty(4, n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                      device=feat.device)
    rec = pack_fwd_rows_cuda(feat)
    order = tile_order_cuda(tile_starts)
    err = _build.library().gs_render_sh_fwd(
        rec.data_ptr(), basis.data_ptr(), n_sh, gaussian_idx.data_ptr(),
        tile_starts.data_ptr(), order.data_ptr(), n_tiles, x_tiles, out.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "gs_render_sh_fwd")
    _build.LAUNCHES["render_sh_fwd"] += 1
    return out


def render_sh_fwd(feat, basis, gaussian_idx, tile_starts, x_tiles: int):
    """Kernel B3 on a CUDA tensor, its plain version on a CPU tensor."""
    _check_sh_args("render_sh_fwd", feat, basis, gaussian_idx, tile_starts)
    if feat.is_cuda:
        return render_sh_fwd_cuda(feat, basis, gaussian_idx, tile_starts, x_tiles)
    if feat.device.type == "cpu":
        return render_sh_fwd_plain(feat, basis, gaussian_idx, tile_starts, x_tiles)
    raise ValueError(f"render_sh_fwd: no kernel for device {feat.device}")


def render_sh_bwd_cuda(feat, basis, gaussian_idx, tile_starts, x_tiles: int,
                       raw, grad_raw):
    """Launch kernel B4 on the current stream; same contract as
    ``render_sh_bwd_plain``.  The kernel adds into a zero-filled grad_feat."""
    n_sh = _check_sh_args("render_sh_bwd", feat, basis, gaussian_idx, tile_starts,
                          contiguous=True)
    _check_cuda_args("render_sh_bwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    _check_raw_args("render_sh_bwd", feat, n_tiles, raw, grad_raw)
    grad = torch.zeros(feat.shape[0], feat.shape[1], dtype=torch.float32,
                       device=feat.device)
    lib = _build.library()
    err = lib.gs_render_sh_bwd(
        feat.data_ptr(), feat.shape[1], basis.data_ptr(), n_sh,
        gaussian_idx.data_ptr(), tile_starts.data_ptr(), n_tiles, x_tiles,
        raw.data_ptr(), grad_raw.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "gs_render_sh_bwd")
    _build.LAUNCHES["render_sh_bwd"] += 1
    return grad


def render_sh_bwd(feat, basis, gaussian_idx, tile_starts, x_tiles: int, raw,
                  grad_raw):
    """Kernel B4 on a CUDA tensor, its plain version on a CPU tensor."""
    _check_sh_args("render_sh_bwd", feat, basis, gaussian_idx, tile_starts)
    if feat.is_cuda:
        return render_sh_bwd_cuda(feat, basis, gaussian_idx, tile_starts, x_tiles,
                                  raw, grad_raw)
    if feat.device.type == "cpu":
        return render_sh_bwd_plain(feat, basis, gaussian_idx, tile_starts, x_tiles,
                                   raw, grad_raw)
    raise ValueError(f"render_sh_bwd: no kernel for device {feat.device}")


class _RenderShFwd(torch.autograd.Function):
    """Raw per-pixel SH render through B3; its backward is B4
    (``render_sh_bwd``), which gives the feature rows their gradient.  The
    basis and the layout get none."""

    @staticmethod
    def forward(ctx, feat, basis, gaussian_idx, tile_starts, x_tiles):
        raw = render_sh_fwd(feat, basis, gaussian_idx, tile_starts, x_tiles)
        ctx.save_for_backward(feat, basis, gaussian_idx, tile_starts, raw)
        ctx.x_tiles = x_tiles
        return raw

    @staticmethod
    def backward(ctx, grad_raw):
        feat, basis, gaussian_idx, tile_starts, raw = ctx.saved_tensors
        grad = render_sh_bwd(feat, basis, gaussian_idx, tile_starts, ctx.x_tiles,
                             raw, grad_raw.contiguous())
        return grad, None, None, None, None


def render_tiles_sh(feat, basis, layout, background_rgb, x_tiles: int):
    """Rasterize per-gaussian SH features through the layout's splat lists.

    feat: (6 + 3*n_sh, N) from ``sh_splat_feature_rows``; basis: (n_sh,
    n_tiles*256) from ``build_pixel_basis``; layout: ``culling.SplatLayout``.
    Returns (image incl. background (n_tiles, 256, 3), final transmittance
    (n_tiles, 256)).
    """
    raw = _RenderShFwd.apply(feat, basis.detach(), layout.gaussian_idx,
                             layout.tile_starts, x_tiles)
    out = _finish(raw, background_rgb, layout.tile_has_output)
    n_tiles = layout.tile_starts.numel() - 1
    img = out[0:3].reshape(3, n_tiles, cc.PIXELS_PER_TILE).permute(1, 2, 0)
    return img, out[3].reshape(n_tiles, cc.PIXELS_PER_TILE)
