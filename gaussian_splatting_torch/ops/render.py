"""DC rasterizer: kernels B1 (forward) and B2 (backward) and their host
side (counterpart of ``gaussian_splatting_tpu/ops/render.py``).

``render_fwd`` dispatches on the device of its input: on a CUDA tensor it
launches the hand-written kernel ``csrc/render_fwd.cu`` (which replaces the
Pallas kernel ``gaussian_splatting_tpu/ops/render.py::_fwd_kernel``), on a
CPU tensor it runs ``render_fwd_plain``, the plain PyTorch version of the
same function.  There is no fallback from one to the other.  The kernel's
source note says what bounds it on the H100 and what its design does
about that.  On the card B1 (and B3, ``ops/render_sh.py``, and B5,
``ops/depth.py``) first packs the feature rows into gaussian-major records
(``pack_fwd_rows_cuda``, plain version ``pack_fwd_rows_plain``) and orders
the tiles heaviest first (``tile_order_cuda``, plain version
``tile_order_plain``).

The backward, kernel B2 (``csrc/render_bwd.cu``, replacing the Pallas
``_bwd_kernel``), dispatches the same way through ``render_bwd``; its plain
version is ``render_bwd_plain``.  ``render_tiles`` runs the forward through
an autograd Function whose backward calls ``render_bwd``.
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


def _splat_chunk(feat, gid, tiles, x_tiles):
    """Per splat-pixel terms of the splats ``gid`` (A, C) at every pixel of
    their tiles: du, dv, mh and raw alpha (A, 256, C), and the splat rows
    op, a, b, c, rdet (A, 1, C).  The same float operations, in the same
    order, as the kernels' ``load_geom`` / ``splat_alpha``
    (csrc/common.cuh)."""
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
    return dict(du=du, dv=dv, mh=mh, alpha=op * prob, op=op, a=a, b=b, c=c,
                rdet=rdet)


def _alpha_chunk(feat, gid, tiles, x_tiles):
    """Raw alpha (A, 256, C) of the splats ``gid`` (A, C) in their tiles."""
    return _splat_chunk(feat, gid, tiles, x_tiles)["alpha"]


def _composite_chunk(T_tiles, alpha, ok, clamp=False):
    """Front-to-back compositing of one chunk: (at, prod, active, w).

    T_tiles (A, 256): T carried in; alpha (A, 256, C) raw; ok (A, C) real
    slots.  at is alpha where kept (>= ALPHA_SKIP), clamped at ALPHA_CLAMP
    when ``clamp`` (the backward's semantics); prod (A, 256, C+1) holds T
    before each splat and after the last; a pixel composites a splat only
    while T >= T_EPS before it (``active``), with weight w = at * T.
    """
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    keep = ok[:, None, :] & (alpha >= cc.ALPHA_SKIP)
    at = torch.where(keep, alpha.clamp_max(cc.ALPHA_CLAMP) if clamp else alpha, zero)
    # T before each splat, then after: the carried T leads the product
    prod = torch.cumprod(torch.cat([T_tiles[:, :, None], 1.0 - at], dim=2), dim=2)
    active = prod[..., :-1] >= cc.T_EPS
    w = torch.where(active, at * prod[..., :-1], zero)
    return at, prod, active, w


def _t_after(prod, active):
    """T after a chunk: active is a prefix of the chunk, so T stops after
    the last active splat."""
    return prod.gather(2, active.sum(dim=2, keepdim=True)).squeeze(2)


def _dc_colour(feat):
    """Colour of the DC rows: the splat's r, g, b at every pixel, one
    (A, 1, C) channel at a time."""
    def colour(gid, tiles):
        for ch in range(3):
            yield feat[cc.FEAT_R + ch][gid][:, None, :]
    return colour


def _dc_colour_grads(gch, w, tiles):
    """d/d(r, g, b) of the DC rows, summed over the tile's pixels: (3, A, C)."""
    return torch.stack([(gch[ch] * w).sum(dim=1) for ch in range(3)])


def fwd_walk(feat, gaussian_idx, tile_starts, x_tiles: int, colour,
             chunk: int = PLAIN_CHUNK):
    """Plain front-to-back compositing of every tile's splat list.

    ``colour(gid, tiles)`` yields the splats' colour at the tiles' pixels,
    one channel at a time, each broadcastable to (A, 256, C).  Returns
    (4, n_tiles*256): premultiplied r, g, b and the final T.
    """
    n_tiles = tile_starts.numel() - 1
    dt, dev = feat.dtype, feat.device
    T = torch.ones(n_tiles, cc.PIXELS_PER_TILE, dtype=dt, device=dev)
    rgb = torch.zeros(3, n_tiles, cc.PIXELS_PER_TILE, dtype=dt, device=dev)
    for tiles, gid, ok in _tile_chunks(gaussian_idx, tile_starts, chunk):
        alpha = _alpha_chunk(feat, gid, tiles, x_tiles)
        _, prod, active, w = _composite_chunk(T[tiles], alpha, ok)
        for ch, col in enumerate(colour(gid, tiles)):
            rgb[ch, tiles] += (w * col).sum(dim=2)
        T[tiles] = _t_after(prod, active)
    return torch.cat([rgb.reshape(3, -1), T.reshape(1, -1)])


def bwd_walk(feat, gaussian_idx, tile_starts, x_tiles: int, raw, grad_raw,
             colour, colour_grads, chunk: int = PLAIN_CHUNK):
    """Plain VJP of ``fwd_walk``'s raw output with the JAX backward's
    semantics; returns the gradient of every row of ``feat``.

    ``colour`` is as for ``fwd_walk``; ``colour_grads(gch, w, tiles)``
    gives the gradients of the colour rows summed over the tiles' pixels,
    (rows - 6, A, C), from the cotangent gch (4, A, 256, 1) and the
    clamped weights w (A, 256, C).

    Per pixel, E = sum_ch raw_ch * g_ch + g_T * T is what the loss sees
    behind the front of the pixel.  The walk goes front to back again with
    alpha clamped at ALPHA_CLAMP (in T, in the T_EPS mask, in the weights
    and in 1/(1 - alpha)); D = E - the inclusive prefix of A * w is what
    lies behind a splat, with A = sum_ch g_ch * colour_ch, and
    q = alpha * dL/dalpha = alpha * (A * T - D / (1 - alpha)).  Each
    splat-pixel pair then contributes the direct derivatives of
    alpha = op * exp(-mh / 2) (docs/MATH.md), summed over pixels and added
    onto the gaussian with ``index_add_``.  No autograd: the walk keeps
    one chunk of fields alive at a time.
    """
    n_tiles = tile_starts.numel() - 1
    dt, dev = feat.dtype, feat.device
    px = cc.PIXELS_PER_TILE
    r = raw.reshape(4, n_tiles, px)
    g = grad_raw.reshape(4, n_tiles, px)
    e = r[0] * g[0] + r[1] * g[1] + r[2] * g[2] + g[3] * r[3]
    T = torch.ones(n_tiles, px, dtype=dt, device=dev)
    pg = torch.zeros(n_tiles, px, dtype=dt, device=dev)
    grad = torch.zeros(feat.shape[0], feat.shape[1], dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for tiles, gid, ok in _tile_chunks(gaussian_idx, tile_starts, chunk):
        t = _splat_chunk(feat, gid, tiles, x_tiles)
        at, prod, active, w = _composite_chunk(T[tiles], t["alpha"], ok, clamp=True)
        t_before = prod[..., :-1]
        gch = g[:, tiles, :, None]  # (4, A, 256, 1)
        A = None
        for ch, col in enumerate(colour(gid, tiles)):
            A = gch[ch] * col if A is None else A + gch[ch] * col
        pg_incl = pg[tiles, :, None] + torch.cumsum(A * w, dim=2)
        d = e[tiles, :, None] - pg_incl
        roma = 1.0 / (1.0 - at)
        q = at * torch.where(active, A * t_before - d * roma, zero)
        rq = q * t["rdet"]
        du, dv, mh = t["du"], t["dv"], t["mh"]
        a, b, c = t["a"], t["b"], t["c"]
        rows = (
            lambda: rq * (c * du - b * dv),  # u
            lambda: rq * (a * dv - b * du),  # v
            lambda: q / t["op"].clamp_min(1e-30),  # opacity
            lambda: (-0.5 * rq) * (dv * dv - c * mh),  # a + 1/4
            lambda: rq * (du * dv - b * mh),  # b / 2
            lambda: (-0.5 * rq) * (du * du - a * mh),  # c + 1/4
        )
        # one (A, 256, C) field alive at a time; padding slots are dropped
        sums = torch.cat([torch.stack([row().sum(dim=1)[ok] for row in rows]),
                          colour_grads(gch, w, tiles)[:, ok]])
        grad.index_add_(1, gid[ok], sums)
        T[tiles] = _t_after(prod, active)
        pg[tiles] = pg_incl[..., -1]
    return grad


def render_fwd_plain(feat, gaussian_idx, tile_starts, x_tiles: int,
                     chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B1, same inputs and output.

    feat: (9, N) rows from ``splat_feature_rows`` (colour pre-scaled by
    SH_0); gaussian_idx (S,) and tile_starts (n_tiles+1,) from
    ``culling.build_layout``.  Returns (4, n_tiles*256): premultiplied
    r, g, b and the final transmittance T of every tile pixel.
    """
    return fwd_walk(feat, gaussian_idx, tile_starts, x_tiles, _dc_colour(feat), chunk)


def render_bwd_plain(feat, gaussian_idx, tile_starts, x_tiles: int, raw,
                     grad_raw, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of kernel B2: the VJP of ``render_fwd``'s raw
    output, with the JAX backward's semantics (``_bwd_kernel``; see
    ``bwd_walk``).

    raw: (4, n_tiles*256) output of ``render_fwd``; grad_raw: its cotangent.
    Returns grad_feat (9, N), the gradients of the feature rows of
    ``splat_feature_rows``.
    """
    return bwd_walk(feat, gaussian_idx, tile_starts, x_tiles, raw, grad_raw,
                    _dc_colour(feat), _dc_colour_grads, chunk)


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
    if not feat.is_cuda:
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {feat.device}")
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


def _check_raw_args(name, feat, n_tiles, raw, grad_raw):
    """A backward kernel takes the forward's raw output and its cotangent
    as contiguous float32 (4, n_tiles*256) tensors beside feat."""
    want = (4, n_tiles * cc.PIXELS_PER_TILE)
    for t, nm in ((raw, "raw"), (grad_raw, "grad_raw")):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} must be float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous on {feat.device}")


# rdet's place in a packed record, after u, v, op, a, b, c (csrc/common.cuh)
REC_RDET = 6


def packed_stride(rows: int) -> int:
    """Floats per gaussian in the forward kernels' packed records: the
    ``rows`` feature rows and rdet, zero-padded to a multiple of 4."""
    return (rows + 1 + 3) // 4 * 4


def pack_fwd_rows_plain(feat):
    """Plain PyTorch version of the pack that B1, B3 and B5 read
    (``gs_pack_fwd_rows`` in ``csrc/render_fwd.cu``): (rows, N) feature
    rows -> (N, packed_stride(rows)) gaussian-major records u, v, op, a, b,
    c, rdet, then rows 6.. (B1's colour, B3's coefficients, B5's distance),
    zero-padded.
    rdet = 1 / (a c - b^2) with the operations of ``_splat_chunk`` and the
    kernels' ``load_geom``, so the kernel's records agree bitwise."""
    rows, n = feat.shape
    a, b, c = feat[cc.FEAT_A], feat[cc.FEAT_B], feat[cc.FEAT_C]
    rec = torch.zeros(n, packed_stride(rows), dtype=feat.dtype, device=feat.device)
    rec[:, :REC_RDET] = feat[:REC_RDET].T
    rec[:, REC_RDET] = 1.0 / (a * c - b * b)
    rec[:, REC_RDET + 1:rows + 1] = feat[REC_RDET:].T
    return rec


def pack_fwd_rows_cuda(feat):
    """Launch the pack kernel on the current stream: the records of
    ``pack_fwd_rows_plain`` in a new (N, packed_stride(rows)) tensor."""
    if feat.dim() != 2 or feat.shape[0] <= REC_RDET:
        raise ValueError(f"pack_fwd_rows: feat must be (rows > 6, N), got {tuple(feat.shape)}")
    if not (feat.is_cuda and feat.dtype == torch.float32 and feat.is_contiguous()):
        raise ValueError("pack_fwd_rows: feat must be contiguous float32 on a CUDA "
                         f"device, got {feat.dtype} on {feat.device}")
    rows, n = feat.shape
    rec = torch.empty(n, packed_stride(rows), dtype=torch.float32, device=feat.device)
    err = _build.library().gs_pack_fwd_rows(
        feat.data_ptr(), n, rows, rec.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, "gs_pack_fwd_rows")
    return rec


# the tile order's buckets: tiles of ORDER_BUCKETS - 1 splats or more tie
ORDER_BUCKETS = 1024


def tile_order_plain(tile_starts):
    """Plain PyTorch version of the tile order that B1, B3 and B5 walk
    (``gs_tile_order`` in ``csrc/render_fwd.cu``): the tiles by splat count,
    largest first, counts of ORDER_BUCKETS - 1 and more tied, ties in tile
    order.  The kernel orders ties in any order, so its order agrees with
    this one in the counts along it, not tile by tile."""
    counts = (tile_starts[1:] - tile_starts[:-1]).clamp_max(ORDER_BUCKETS - 1)
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def tile_order_cuda(tile_starts):
    """Launch the tile-order kernel on the current stream: a new (n_tiles,)
    int32 permutation of the tiles, heaviest first."""
    if not (tile_starts.is_cuda and tile_starts.dtype == torch.int32
            and tile_starts.is_contiguous()):
        raise ValueError("tile_order: tile_starts must be contiguous int32 on a CUDA "
                         f"device, got {tile_starts.dtype} on {tile_starts.device}")
    n_tiles = tile_starts.numel() - 1
    order = torch.empty(n_tiles, dtype=torch.int32, device=tile_starts.device)
    err = _build.library().gs_tile_order(
        tile_starts.data_ptr(), n_tiles, order.data_ptr(),
        torch.cuda.current_stream(tile_starts.device).cuda_stream)
    _build.check(err, "gs_tile_order")
    return order


def render_fwd_cuda(feat, gaussian_idx, tile_starts, x_tiles: int):
    """Launch kernel B1 on the current stream; same contract as
    ``render_fwd_plain``.  B1 is three launches: the pack of ``feat`` into
    gaussian-major records, the tile order, then the walk."""
    _check_cuda_args("render_fwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    out = torch.empty(4, n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                      device=feat.device)
    rec = pack_fwd_rows_cuda(feat)
    order = tile_order_cuda(tile_starts)
    err = _build.library().gs_render_fwd(
        rec.data_ptr(), gaussian_idx.data_ptr(), tile_starts.data_ptr(),
        order.data_ptr(), n_tiles, x_tiles, out.data_ptr(),
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


def render_bwd_cuda(feat, gaussian_idx, tile_starts, x_tiles: int, raw,
                    grad_raw):
    """Launch kernel B2 on the current stream; same contract as
    ``render_bwd_plain``.  The kernel adds into a zero-filled grad_feat."""
    _check_cuda_args("render_bwd", feat, gaussian_idx, tile_starts)
    n_tiles = tile_starts.numel() - 1
    _check_raw_args("render_bwd", feat, n_tiles, raw, grad_raw)
    grad = torch.zeros(cc.N_FEAT, feat.shape[1], dtype=torch.float32,
                       device=feat.device)
    lib = _build.library()
    err = lib.gs_render_bwd(
        feat.data_ptr(), feat.shape[1], gaussian_idx.data_ptr(),
        tile_starts.data_ptr(), n_tiles, x_tiles, raw.data_ptr(),
        grad_raw.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    _build.check(err, "gs_render_bwd")
    _build.LAUNCHES["render_bwd"] += 1
    return grad


def render_bwd(feat, gaussian_idx, tile_starts, x_tiles: int, raw, grad_raw):
    """Kernel B2 on a CUDA tensor, its plain version on a CPU tensor."""
    _check_layout_args("render_bwd", feat, cc.N_FEAT, gaussian_idx, tile_starts)
    if feat.is_cuda:
        return render_bwd_cuda(feat, gaussian_idx, tile_starts, x_tiles, raw,
                               grad_raw)
    if feat.device.type == "cpu":
        return render_bwd_plain(feat, gaussian_idx, tile_starts, x_tiles, raw,
                                grad_raw)
    raise ValueError(f"render_bwd: no kernel for device {feat.device}")


class _RenderFwd(torch.autograd.Function):
    """Raw DC render through B1; its backward is B2 (``render_bwd``), which
    gives the features their gradient.  The layout gets none."""

    @staticmethod
    def forward(ctx, feat, gaussian_idx, tile_starts, x_tiles):
        raw = render_fwd(feat, gaussian_idx, tile_starts, x_tiles)
        ctx.save_for_backward(feat, gaussian_idx, tile_starts, raw)
        ctx.x_tiles = x_tiles
        return raw

    @staticmethod
    def backward(ctx, grad_raw):
        feat, gaussian_idx, tile_starts, raw = ctx.saved_tensors
        grad = render_bwd(feat, gaussian_idx, tile_starts, ctx.x_tiles, raw,
                          grad_raw.contiguous())
        return grad, None, None, None


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
