"""DC forward rasterizer: kernel B1 and its host side (counterpart of
``gaussian_splatting_tpu/ops/render.py``).

``render_fwd`` dispatches on the device of its input: on a CUDA tensor it
launches the hand-written kernel ``csrc/render_fwd.cu`` (which replaces the
Pallas kernel ``gaussian_splatting_tpu/ops/render.py::_fwd_kernel``), on a
CPU tensor it runs ``render_fwd_plain``, the plain PyTorch version of the
same function.  There is no fallback from one to the other.  The kernel's
source note says what bounds it on the H100 and what its design does
about that.

The backward kernel (B2) is not ported yet: ``render_tiles`` runs through
an autograd Function whose backward raises.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch import _build
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.structs import TILE_PX

# splats per step of the plain versions' walk over a tile's list
PLAIN_CHUNK = 32


def splat_feature_rows(u, v, opacity_v, c0, c1, c2, r, g, b):
    """Per-gaussian render rows ((N,) each) -> the (9, N) feature matrix,
    with the +0.25 diagonal regularisation and conic[1] / 2 folded in."""
    return torch.stack([u, v, opacity_v, c0 + 0.25, c1 * 0.5, c2 + 0.25, r, g, b])


def _pixel_local_coords(dtype, device):
    """(256,) tile-local pixel coordinates centred on the tile (+-7.5)."""
    p = torch.arange(cc.PIXELS_PER_TILE, device=device)
    half = (TILE_PX - 1) / 2
    return (p % TILE_PX).to(dtype) - half, (p // TILE_PX).to(dtype) - half


def _tile_chunks(gaussian_idx, tile_starts, chunk):
    """Walk every tile's splat list in steps of ``chunk`` splats.

    Yields (tiles (A,), gid (A, C), ok (A, C)): the tiles that still have
    splats at this step, the gaussian ids of their next C splats, and which
    of those slots are real.  One step covers every tile at once, so the
    walk takes max_count / chunk steps, not one per splat.
    """
    counts = (tile_starts[1:] - tile_starts[:-1]).long()
    max_count = int(counts.max()) if counts.numel() else 0
    pos = torch.arange(chunk, device=tile_starts.device)
    for j0 in range(0, max_count, chunk):
        tiles = torch.nonzero(counts > j0).squeeze(1)
        slot = j0 + pos[None, :]
        ok = slot < counts[tiles, None]
        idx = tile_starts[tiles, None].long() + slot
        gid = gaussian_idx[torch.where(ok, idx, torch.zeros_like(idx))].long()
        yield tiles, gid, ok


def _alpha_chunk(feat, gid, tiles, x_tiles):
    """Raw alpha (A, 256, C) of the splats ``gid`` (A, C) at every pixel of
    their tiles.  The same float operations, in the same order, as the
    kernels' ``load_geom`` / ``splat_alpha`` (csrc/common.cuh)."""
    up, vp = _pixel_local_coords(feat.dtype, feat.device)
    ox = ((tiles % x_tiles) * TILE_PX).to(feat.dtype)[:, None]
    oy = ((tiles // x_tiles) * TILE_PX).to(feat.dtype)[:, None]
    half = (TILE_PX - 1) / 2
    ul = ((feat[cc.FEAT_U][gid] - ox) - half)[:, None, :]
    vl = ((feat[cc.FEAT_V][gid] - oy) - half)[:, None, :]
    op = feat[cc.FEAT_OPACITY][gid][:, None, :]
    a = feat[cc.FEAT_A][gid][:, None, :]
    b = feat[cc.FEAT_B][gid][:, None, :]
    c = feat[cc.FEAT_C][gid][:, None, :]
    rdet = 1.0 / (a * c - b * b)
    du = up[None, :, None] - ul
    dv = vp[None, :, None] - vl
    mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) * rdet
    prob = torch.where(mh > 0.0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
    return op * prob


def render_fwd_plain(feat, gaussian_idx, tile_starts, x_tiles: int,
                     chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B1, same inputs and output.

    feat: (9, N) rows from ``splat_feature_rows`` (colour pre-scaled by
    SH_0); gaussian_idx (S,) and tile_starts (n_tiles+1,) from
    ``culling.build_layout``.  Returns (4, n_tiles*256): premultiplied
    r, g, b and the final transmittance T of every tile pixel.
    """
    n_tiles = tile_starts.numel() - 1
    dt, dev = feat.dtype, feat.device
    T = torch.ones(n_tiles, cc.PIXELS_PER_TILE, dtype=dt, device=dev)
    rgb = torch.zeros(3, n_tiles, cc.PIXELS_PER_TILE, dtype=dt, device=dev)
    for tiles, gid, ok in _tile_chunks(gaussian_idx, tile_starts, chunk):
        alpha = _alpha_chunk(feat, gid, tiles, x_tiles)
        keep = ok[:, None, :] & (alpha >= cc.ALPHA_SKIP)
        at = torch.where(keep, alpha, torch.zeros_like(alpha))
        # T before each splat, then after: the carried T leads the product
        prod = torch.cumprod(torch.cat([T[tiles, :, None], 1.0 - at], dim=2), dim=2)
        t_before = prod[..., :-1]
        # a pixel composites a splat only while T >= T_EPS before it
        active = t_before >= cc.T_EPS
        w = torch.where(active, at * t_before, torch.zeros_like(at))
        for ch in range(3):
            col = feat[cc.FEAT_R + ch][gid][:, None, :]
            rgb[ch, tiles] += (w * col).sum(dim=2)
        # active is a prefix of the chunk: T stops after the last active splat
        T[tiles] = prod.gather(2, active.sum(dim=2, keepdim=True)).squeeze(2)
    return torch.cat([rgb.reshape(3, -1), T.reshape(1, -1)])


def _check_layout_args(name, feat, rows, gaussian_idx, tile_starts):
    if feat.dim() != 2 or feat.shape[0] != rows:
        raise ValueError(f"{name}: feat must be ({rows}, N), got {tuple(feat.shape)}")
    for t, nm in ((gaussian_idx, "gaussian_idx"), (tile_starts, "tile_starts")):
        if t.dim() != 1:
            raise ValueError(f"{name}: {nm} must be 1-D, got {tuple(t.shape)}")
    if tile_starts.numel() < 1:
        raise ValueError(f"{name}: tile_starts needs n_tiles + 1 entries")


def _check_cuda_args(name, feat, gaussian_idx, tile_starts):
    """The kernels take float32 features and int32 indices, contiguous, on
    one CUDA device."""
    if feat.dtype != torch.float32:
        raise TypeError(f"{name}: feat must be float32, got {feat.dtype}")
    for t, nm in ((gaussian_idx, "gaussian_idx"), (tile_starts, "tile_starts")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {nm} must be int32, got {t.dtype}")
        if t.device != feat.device:
            raise ValueError(f"{name}: {nm} on {t.device}, feat on {feat.device}")
    for t, nm in ((feat, "feat"), (gaussian_idx, "gaussian_idx"),
                  (tile_starts, "tile_starts")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


def render_fwd_cuda(feat, gaussian_idx, tile_starts, x_tiles: int):
    """Launch kernel B1 on the current stream; same contract as
    ``render_fwd_plain``."""
    _check_cuda_args("render_fwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    out = torch.empty(4, n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                      device=feat.device)
    lib = _build.library()
    err = lib.gs_render_fwd(
        feat.data_ptr(), feat.shape[1], gaussian_idx.data_ptr(),
        tile_starts.data_ptr(), n_tiles, x_tiles, out.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "gs_render_fwd")
    _build.LAUNCHES["render_fwd"] += 1
    return out


def render_fwd(feat, gaussian_idx, tile_starts, x_tiles: int):
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor."""
    _check_layout_args("render_fwd", feat, cc.N_FEAT, gaussian_idx, tile_starts)
    if feat.is_cuda:
        return render_fwd_cuda(feat, gaussian_idx, tile_starts, x_tiles)
    if feat.device.type == "cpu":
        return render_fwd_plain(feat, gaussian_idx, tile_starts, x_tiles)
    raise ValueError(f"render_fwd: no kernel for device {feat.device}")


class _RenderFwd(torch.autograd.Function):
    """Forward through B1; the DC backward kernel is not ported, so a
    backward pass fails instead of returning zero gradients."""

    @staticmethod
    def forward(ctx, feat, gaussian_idx, tile_starts, x_tiles):
        return render_fwd(feat, gaussian_idx, tile_starts, x_tiles)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "DC backward kernel (ops/render.py::_bwd_kernel) not ported yet"
        )


def _finish(raw, background_rgb, tile_has_output):
    """Empty tiles get colour 0 and T 1; the background is blended where
    T > BG_T_EPS.  raw: (4, n_tiles*256) -> (4, n_tiles*256)."""
    empty = (~tile_has_output).repeat_interleave(cc.PIXELS_PER_TILE)
    rgb = torch.where(empty[None, :], torch.zeros_like(raw[0:3]), raw[0:3])
    T = torch.where(empty, torch.ones_like(raw[3]), raw[3])
    bg_w = torch.where(T > cc.BG_T_EPS, T, torch.zeros_like(T))
    img = rgb + bg_w[None, :] * background_rgb[:, None]
    return torch.cat([img, T[None, :]])


def render_tiles(feat, layout, background_rgb, x_tiles: int):
    """Rasterize per-gaussian features through the layout's splat lists.

    feat: (9, N) from ``splat_feature_rows``; layout: ``culling.SplatLayout``.
    Returns (image incl. background (n_tiles, 256, 3), final transmittance
    (n_tiles, 256)).
    """
    raw = _RenderFwd.apply(feat, layout.gaussian_idx, layout.tile_starts, x_tiles)
    out = _finish(raw, background_rgb, layout.tile_has_output)
    n_tiles = layout.tile_starts.numel() - 1
    img = out[0:3].reshape(3, n_tiles, cc.PIXELS_PER_TILE).permute(1, 2, 0)
    return img, out[3].reshape(n_tiles, cc.PIXELS_PER_TILE)
