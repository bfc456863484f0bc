"""Forward-only depth renderer: kernel B5 and its host side (counterpart of
``gaussian_splatting_tpu/ops/depth.py``).

Per pixel, walk the tile's depth-sorted splats front to back with the raw
alpha (no 1/255 skip, no saturation stop) and report the camera distance
of the first splat at which the accumulated alpha 1 - T crosses
``alpha_threshold``; -1 where none does.

``depth_fwd`` launches the hand-written kernel ``csrc/depth_fwd.cu``
(which replaces the Pallas kernel
``gaussian_splatting_tpu/ops/depth.py::_depth_kernel``) on a CUDA tensor
and runs ``depth_fwd_plain`` on a CPU tensor, with no fallback between
them.  The kernel's source note says what bounds it on the H100 and what
its design does about that.  On the card B5 reads the records of B1's pack
(``pack_fwd_rows_cuda``; the distance is the record's last float) and takes
the tiles heaviest first (``tile_order_cuda``).
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch import _build, telemetry
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops.render import (
    PLAIN_CHUNK,
    _alpha_chunk,
    _check_cuda_args,
    _check_layout_args,
    _tile_chunks,
    pack_fwd_rows_cuda,
    tile_order_cuda,
)

# feature row 6 holds the splat's camera-frame Euclidean distance
FEAT_DEPTH = 6
N_DEPTH_FEAT = 7


def depth_feature_rows(u, v, opacity_v, c0, c1, c2, dist):
    """Per-gaussian depth-render rows ((N,) each) -> (7, N)."""
    return torch.stack([u, v, opacity_v, c0 + 0.25, c1 * 0.5, c2 + 0.25, dist])


def depth_features(uv, opacity, conic, xyz_camera):
    """(N, C)-array wrapper over ``depth_feature_rows``: uv (N, 2), opacity
    (N, 1), conic (N, 3), camera-frame xyz (N, 3) -> (7, N), the depth row
    |xyz_camera|."""
    return depth_feature_rows(uv[:, 0], uv[:, 1], opacity[:, 0], conic[:, 0],
                              conic[:, 1], conic[:, 2],
                              torch.linalg.norm(xyz_camera, dim=1))


def depth_fwd_plain(feat, gaussian_idx, tile_starts, x_tiles: int,
                    alpha_threshold: float, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B5, same inputs and output.

    feat: (7, N) rows from ``depth_feature_rows``.  Returns the depth of
    every tile pixel, (n_tiles*256,), -1 where nothing crosses.
    """
    n_tiles = tile_starts.numel() - 1
    dt, dev = feat.dtype, feat.device
    T = torch.ones(n_tiles, cc.PIXELS_PER_TILE, dtype=dt, device=dev)
    depth = torch.full((n_tiles, cc.PIXELS_PER_TILE), -1.0, dtype=dt, device=dev)
    found = torch.zeros(n_tiles, cc.PIXELS_PER_TILE, dtype=torch.bool, device=dev)
    for tiles, gid, ok in _tile_chunks(gaussian_idx, tile_starts, chunk):
        alpha = _alpha_chunk(feat, gid, tiles, x_tiles)
        at = torch.where(ok[:, None, :], alpha, torch.zeros_like(alpha))
        # T after each splat, with the carried T leading the product
        prod = torch.cumprod(torch.cat([T[tiles, :, None], 1.0 - at], dim=2), dim=2)
        crossed = (1.0 - prod[..., 1:]) > alpha_threshold  # (A, 256, C)
        hit = crossed.any(dim=2)
        first = crossed.to(torch.uint8).argmax(dim=2, keepdim=True)
        dist = feat[FEAT_DEPTH][gid][:, None, :].expand_as(crossed)
        d_hit = dist.gather(2, first).squeeze(2)
        new = hit & ~found[tiles]
        depth[tiles] = torch.where(new, d_hit, depth[tiles])
        found[tiles] |= hit
        T[tiles] = prod[..., -1]
    return depth.reshape(-1)


def depth_fwd_cuda(feat, gaussian_idx, tile_starts, x_tiles: int,
                   alpha_threshold: float):
    """Launch kernel B5 on the current stream; same contract as
    ``depth_fwd_plain``.  B5 is three launches, as B1: the pack of ``feat``
    into gaussian-major records (u, v, op, a, b, c, rdet, distance), the
    tile order, then the walk."""
    _check_cuda_args("depth_fwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    out = torch.empty(n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                      device=feat.device)
    rec = pack_fwd_rows_cuda(feat)
    order = tile_order_cuda(tile_starts)
    err = _build.library().gs_depth_fwd(
        rec.data_ptr(), gaussian_idx.data_ptr(), tile_starts.data_ptr(),
        order.data_ptr(), n_tiles, x_tiles, float(alpha_threshold),
        out.data_ptr(), torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "gs_depth_fwd")
    telemetry.LAUNCHES["depth_fwd"] += 1
    return out


@torch.no_grad()
def depth_fwd(feat, gaussian_idx, tile_starts, x_tiles: int,
              alpha_threshold: float):
    """Kernel B5 on a CUDA tensor, its plain version on a CPU tensor.
    Forward only: the result carries no gradient on either device."""
    _check_layout_args("depth_fwd", feat, N_DEPTH_FEAT, gaussian_idx, tile_starts)
    if feat.is_cuda:
        return depth_fwd_cuda(feat, gaussian_idx, tile_starts, x_tiles,
                              alpha_threshold)
    if feat.device.type == "cpu":
        return depth_fwd_plain(feat, gaussian_idx, tile_starts, x_tiles,
                               alpha_threshold)
    raise ValueError(f"depth_fwd: no kernel for device {feat.device}")


def render_depth_tiles(feat, layout, alpha_threshold: float, x_tiles: int):
    """Depth per tile pixel, (n_tiles, 256); -1 where never crossed and on
    tiles without splats."""
    depth = depth_fwd(feat, layout.gaussian_idx, layout.tile_starts, x_tiles,
                      alpha_threshold)
    empty = (~layout.tile_has_output).repeat_interleave(cc.PIXELS_PER_TILE)
    depth = torch.where(empty, torch.full_like(depth, -1.0), depth)
    return depth.reshape(-1, cc.PIXELS_PER_TILE)
