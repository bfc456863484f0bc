"""Dense compositing oracle with the reference semantics (counterpart of
``gaussian_splatting_tpu/ops/reference_impl.py``).

A literal sequential re-statement of the reference rasterizer loop that
runs in any float dtype (float64 in the tests).  It is
O(n_tiles * max_splats_per_tile * 256) and meant for tests and small
scenes only.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.structs import TILE_PX


def _composite(feat, valid, x_tiles: int, colour):
    """The reference loop over dense per-tile lists; ``colour(f)`` gives the
    colour of the slot rows f (n_tiles, rows) at every pixel, broadcastable
    to (n_tiles, 256, 3)."""
    n_tiles, n_slots, _ = feat.shape
    dtype, dev = feat.dtype, feat.device
    tiles = torch.arange(n_tiles, device=dev)
    tx = (tiles % x_tiles).to(dtype)
    ty = (tiles // x_tiles).to(dtype)
    p = torch.arange(cc.PIXELS_PER_TILE, device=dev)
    upix = tx[:, None] * TILE_PX + (p % TILE_PX)[None, :].to(dtype)
    vpix = ty[:, None] * TILE_PX + (p // TILE_PX)[None, :].to(dtype)

    T = torch.ones(n_tiles, cc.PIXELS_PER_TILE, dtype=dtype, device=dev)
    img = torch.zeros(n_tiles, cc.PIXELS_PER_TILE, 3, dtype=dtype, device=dev)
    for j in range(n_slots):
        f = feat[:, j]
        ok = valid[:, j].to(dtype)
        u = f[:, cc.FEAT_U, None]
        v = f[:, cc.FEAT_V, None]
        op = f[:, cc.FEAT_OPACITY, None]
        a = f[:, cc.FEAT_A, None]
        b = f[:, cc.FEAT_B, None]
        c = f[:, cc.FEAT_C, None]
        du = upix - u
        dv = vpix - v
        det = a * c - b * b
        mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) / det
        prob = torch.where(mh > 0.0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
        alpha = op * prob
        at = torch.where(alpha >= cc.ALPHA_SKIP, alpha,
                         torch.zeros_like(alpha)) * ok[:, None]
        active = T >= cc.T_EPS
        w = torch.where(active, at * T, torch.zeros_like(T))
        img = img + w[..., None] * colour(f)
        T = torch.where(active, T * (1.0 - at), T)
    return img, T


def composite_dense(feat, valid, x_tiles: int):
    """Front-to-back alpha compositing over dense per-tile splat lists.

    feat: (n_tiles, L, 9) per-slot features (rows per ops/common.py);
    valid: (n_tiles, L) bool.  Returns (premultiplied image (n_tiles, 256, 3),
    final transmittance (n_tiles, 256)); the background is not applied.
    """
    return _composite(feat, valid, x_tiles,
                      lambda f: f[:, None, cc.FEAT_R:cc.FEAT_B_COL + 1])


def composite_dense_sh(feat, valid, basis, x_tiles: int):
    """Per-pixel-SH front-to-back compositing over dense per-tile lists.

    feat: (n_tiles, L, 6 + 3*n_sh) per-slot rows u, v, opacity, a, b, c and
    the coefficients in the order c*n_sh + k; valid: (n_tiles, L) bool;
    basis: (n_tiles, 256, n_sh) SH basis at each pixel's view ray.  A
    splat's colour at a pixel is sum_k basis[p, k] * coeff[c, k]; the rest
    is ``composite_dense``.
    """
    n_tiles, _, width = feat.shape
    n_sh = (width - 6) // 3
    return _composite(
        feat, valid, x_tiles,
        lambda f: torch.einsum("npk,nck->npc", basis, f[:, 6:].reshape(n_tiles, 3, n_sh)),
    )


def apply_background(img_premul, T_final, background_rgb):
    """Blend the background where T > BG_T_EPS.  Shapes broadcast over
    pixels."""
    w = torch.where(T_final > cc.BG_T_EPS, T_final, torch.zeros_like(T_final))
    return img_premul + w[..., None] * background_rgb


def tiles_to_image(per_tile_pixels, grid):
    """(n_tiles, 256, C) tile-major pixels -> (H, W, C) cropped image."""
    c = per_tile_pixels.shape[-1]
    img = per_tile_pixels.reshape(grid.y_tiles, grid.x_tiles, TILE_PX, TILE_PX, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        grid.image_height_padded, grid.image_width_padded, c
    )
    return img[: grid.image_height, : grid.image_width]


def image_to_tiles(image, grid):
    """(H, W, C) -> (n_tiles, 256, C), zero-padding to the tile grid."""
    c = image.shape[-1]
    pad_h = grid.image_height_padded - image.shape[0]
    pad_w = grid.image_width_padded - image.shape[1]
    img = torch.nn.functional.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    img = img.reshape(grid.y_tiles, TILE_PX, grid.x_tiles, TILE_PX, c)
    return img.permute(0, 2, 1, 3, 4).reshape(grid.tile_count, 256, c)
