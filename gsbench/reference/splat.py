"""Plain PyTorch reference of one training step and one served view of 3D
gaussian splatting (Kerbl et al. 2023, arXiv:2308.04079) with the tile
rasterizer's semantics as the benchmarked program states them.

Per camera: project every gaussian (pinhole camera, EWA covariance with
+0.25 on the diagonal), cull it by the frustum, give it the 16 px tiles its
opacity-aware 3-sigma ellipse overlaps (an oriented box and a separating-
axis test, at most 4,096 window cells), sort each tile's gaussians by depth,
and composite them front to back per pixel: alpha = opacity *
exp(-mh / 2), skipped below 1/255, composited while the transmittance T
before it is at least 1e-4; the background is added with weight T where
T > 1e-3.  Colour is the SH expansion evaluated once per gaussian along
the camera-to-gaussian direction, or per pixel along the pixel's ray.  The
loss is 0.8 L1 + 0.2 (1 - SSIM), the optimiser Adam with per-leaf rates.

The float operations of geometry and alpha follow the order in which the
program states them, so that both round alike; the compositing is a walk
over chunks of each tile's list, and gradients come from autograd, tile
group by tile group, never from a hand-written backward.  Nothing here
imports the program; every input is a tensor the benchmark made.
"""

from __future__ import annotations

import dataclasses
import math

import torch

TILE = 16
PIXELS = TILE * TILE
ALPHA_SKIP = 0.00392156862
T_EPS = 1e-4
BG_T_EPS = 1e-3
MAX_WINDOW_CELLS = 4096
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SSIM_SIZE, SSIM_SIGMA = 11, 1.5

SH_0 = 0.28209479177387814
R_SH_0 = 3.544907701811032
SH_1 = (-0.4886025119029199, 0.4886025119029199, -0.4886025119029199)
SH_2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
        -1.0925484305920792, 0.5462742152960396)
SH_3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
        0.263875515352797, -0.4570457994644658, 1.445305721320277,
        -0.5900435899266435)
LEAVES = ("xyz", "rgb", "opacity", "scale", "quaternion", "sh")


@dataclasses.dataclass(frozen=True)
class View:
    """One camera and what the render needs of the configuration."""

    K: torch.Tensor  # (3, 3)
    pose: torch.Tensor  # (4, 4) camera_T_world
    width: int
    height: int
    n_sh: int  # SH coefficients per channel, 1, 4, 9 or 16
    per_pixel: bool  # SH evaluated per pixel ray, not per gaussian
    background: torch.Tensor  # (3,)
    near: float = 0.3
    far: float = 500.0
    padding: float = 100.0
    mh_dist: float = 3.0

    @property
    def x_tiles(self) -> int:
        return -(-self.width // TILE)

    @property
    def y_tiles(self) -> int:
        return -(-self.height // TILE)


def set_exact_float32():
    """No TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _safe_div(num, den, ok):
    den = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, num / den, torch.zeros_like(num))


def sh_basis(d, n_sh: int):
    """Real SH basis, bands 0..3, at unit directions (..., 3) -> (..., n_sh)."""
    out = [torch.full(d.shape[:-1], SH_0, dtype=d.dtype, device=d.device)]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if n_sh >= 4:
        out += [SH_1[0] * y, SH_1[1] * z, SH_1[2] * x]
    if n_sh >= 9:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_2[0] * x * y, SH_2[1] * y * z, SH_2[2] * (3 * zz - 1.0),
                SH_2[3] * x * z, SH_2[4] * (xx - yy)]
    if n_sh >= 16:
        out += [SH_3[0] * y * (3 * xx - yy), SH_3[1] * x * y * z,
                SH_3[2] * y * (5 * zz - 1.0), SH_3[3] * z * (5 * zz - 3.0),
                SH_3[4] * x * (5 * zz - 1.0), SH_3[5] * z * (xx - yy),
                SH_3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def gaussian_rows(params: dict, view: View, uv_offset=None) -> dict:
    """What compositing reads of every gaussian: u, v, z, opacity, the
    regularised 2D covariance a, b, c (conic [a, 2b, c] + 0.25 on the
    diagonal), and colour: (N, 3) when SH is evaluated per gaussian, the
    (N, 3, n_sh) coefficients when per pixel."""
    x, y, z = params["xyz"].T
    R, t, K = view.pose[:3, :3], view.pose[:3, 3], view.K
    xc = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    yc = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    zc = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    ok = zc.abs() > 1e-12
    inv_z = _safe_div(torch.ones_like(zc), zc, ok)
    u = K[0, 0] * xc * inv_z + K[0, 2]
    v = K[1, 1] * yc * inv_z + K[1, 2]

    q = params["quaternion"].T
    s = params["scale"].T
    sumsq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    qok = sumsq > 1e-24
    inv_n = _safe_div(torch.ones_like(sumsq),
                      torch.sqrt(torch.where(qok, sumsq, torch.ones_like(sumsq))), qok)
    qw = torch.where(qok, q[0] * inv_n, torch.ones_like(sumsq))
    qx, qy, qz = q[1] * inv_n, q[2] * inv_n, q[3] * inv_n
    r = ((1 - 2 * qy * qy - 2 * qz * qz, 2 * qx * qy - 2 * qz * qw, 2 * qz * qx + 2 * qw * qy),
         (2 * qx * qy + 2 * qz * qw, 1 - 2 * qx * qx - 2 * qz * qz, 2 * qy * qz - 2 * qw * qx),
         (2 * qz * qx - 2 * qw * qy, 2 * qy * qz + 2 * qw * qx, 1 - 2 * qx * qx - 2 * qy * qy))
    ss = [torch.exp(2.0 * s[k]) for k in range(3)]

    def sig(i, j):
        return r[i][0] * r[j][0] * ss[0] + r[i][1] * r[j][1] * ss[1] + r[i][2] * r[j][2] * ss[2]

    xx, xy, xz, yy, yz, zz = sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)
    W = view.pose[:3, :3]
    j00, j11 = K[0, 0] * inv_z, K[1, 1] * inv_z
    j02 = -K[0, 0] * xc * inv_z * inv_z
    j12 = -K[1, 1] * yc * inv_z * inv_z
    m0 = [j00 * W[0, k] + j02 * W[2, k] for k in range(3)]
    m1 = [j11 * W[1, k] + j12 * W[2, k] for k in range(3)]
    t0 = (m0[0] * xx + m0[1] * xy + m0[2] * xz, m0[0] * xy + m0[1] * yy + m0[2] * yz,
          m0[0] * xz + m0[1] * yz + m0[2] * zz)
    t1 = (m1[0] * xx + m1[1] * xy + m1[2] * xz, m1[0] * xy + m1[1] * yy + m1[2] * yz,
          m1[0] * xz + m1[1] * yz + m1[2] * zz)
    c0 = t0[0] * m0[0] + t0[1] * m0[1] + t0[2] * m0[2]
    c1 = (t0[0] * m1[0] + t0[1] * m1[1] + t0[2] * m1[2]) + (
        t1[0] * m0[0] + t1[1] * m0[1] + t1[2] * m0[2])
    c2 = t1[0] * m1[0] + t1[1] * m1[1] + t1[2] * m1[2]

    coeffs = params["rgb"][:, :, None]
    if view.n_sh > 1:
        coeffs = torch.cat([coeffs, params["sh"][:, :, : view.n_sh - 1]], dim=2)
    if view.per_pixel and view.n_sh > 1:
        colour = coeffs
    elif view.n_sh == 1:
        colour = params["rgb"] * SH_0
    else:
        centre = -(R.T * t[None, :]).sum(dim=1)
        d = params["xyz"] - centre
        dsq = (d * d).sum(dim=1, keepdim=True)
        dok = dsq > 1e-24
        d = _safe_div(d, torch.sqrt(torch.where(dok, dsq, torch.ones_like(dsq))), dok)
        colour = (coeffs * sh_basis(d, view.n_sh)[:, None, :]).sum(dim=2) * R_SH_0 * SH_0
    if uv_offset is not None:
        u = u + uv_offset[0]
        v = v + uv_offset[1]
    return dict(u=u, v=v, z=zc, op=torch.sigmoid(params["opacity"][:, 0]),
                a=c0 + 0.25, b=c1 * 0.5, c=c2 + 0.25, colour=colour)


def visible(rows: dict, alive, view: View):
    """Frustum test of every gaussian, and alive."""
    u, v, z = rows["u"], rows["v"], rows["z"]
    culled = (z < view.near) | (z > view.far)
    culled |= (u < -view.padding) | (u > view.width + view.padding)
    culled |= (v < -view.padding) | (v > view.height + view.padding)
    return ~culled & alive


@dataclasses.dataclass
class Layout:
    gid: torch.Tensor  # (S,) int64, grouped by tile, front to back
    tile_starts: torch.Tensor  # (n_tiles + 1,) int64
    truncated: int  # window cells past MAX_WINDOW_CELLS

    @property
    def counts(self):
        return self.tile_starts[1:] - self.tile_starts[:-1]

    @property
    def num_splats(self) -> int:
        return int(self.gid.numel())


def layout(rows: dict, vis, view: View) -> Layout:
    """The tiles each gaussian covers, and every tile's gaussians by depth."""
    with torch.no_grad():
        u, v, z, op = rows["u"], rows["v"], rows["z"], rows["op"]
        a, b, c = rows["a"], rows["b"], rows["c"]
        finite = torch.isfinite(u) & torch.isfinite(v) & torch.isfinite(z)
        finite &= torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
        u = torch.where(finite, u, torch.zeros_like(u))
        v = torch.where(finite, v, torch.zeros_like(v))
        a = torch.where(finite, a, torch.ones_like(a))
        b = torch.where(finite, b, torch.zeros_like(b))
        c = torch.where(finite, c, torch.ones_like(c))
        # the 3-sigma ellipse shrunk to where alpha can still reach 1/255
        q_max = 2.0 * torch.log(op.clamp_min(1e-12) * (1.0 / ALPHA_SKIP))
        mh = torch.sqrt(q_max.clamp_min(0.0)).clamp_max(view.mh_dist)
        vis = vis & finite & (op > ALPHA_SKIP)

        mean = (a + c) * 0.5
        half = torch.sqrt((a - c) * (a - c) * 0.25 + b * b)
        lam1, lam2 = mean + half, mean - half
        r_major = mh * torch.sqrt(lam1.clamp_min(0.0))
        r_minor = mh * torch.sqrt(lam2.clamp_min(0.0))
        theta = torch.where(b.abs() < 1e-16,
                            torch.where(a >= c, torch.zeros_like(a),
                                        torch.full_like(a, math.pi / 2)),
                            torch.atan2(lam1 - a, b))
        ct, st = torch.cos(theta), torch.sin(theta)
        # corners: top-left, top-right, bottom-left, bottom-right
        box = torch.stack([
            -r_major * ct + r_minor * st + u, -r_major * st - r_minor * ct + v,
            r_major * ct + r_minor * st + u, r_major * st - r_minor * ct + v,
            -r_major * ct - r_minor * st + u, -r_major * st + r_minor * ct + v,
            r_major * ct - r_minor * st + u, r_major * st + r_minor * ct + v,
        ], dim=-1)
        xs, ys = box[:, 0::2], box[:, 1::2]

        def span(vals, n):
            lo = torch.floor(vals.amin(1) / TILE).clamp(0, n)
            hi = (torch.floor(vals.amax(1) / TILE) + 1).clamp(0, n)
            return lo.to(torch.int64), hi.to(torch.int64)

        sx, ex = span(xs, view.x_tiles)
        sy, ey = span(ys, view.y_tiles)
        wx, wy = (ex - sx).clamp_min(0), (ey - sy).clamp_min(0)
        area = torch.where(vis, wx * wy, torch.zeros_like(wx))
        truncated = int((area - MAX_WINDOW_CELLS).clamp_min(0).sum())

        # every window cell, x outer and y inner, at most MAX_WINDOW_CELLS each
        g = torch.nonzero(area > 0).squeeze(1)
        cells = area[g].clamp_max(MAX_WINDOW_CELLS)
        gid = torch.repeat_interleave(g, cells)
        k = torch.arange(gid.numel(), device=gid.device) - torch.repeat_interleave(
            torch.cumsum(cells, 0) - cells, cells)
        tx = sx[gid] + k // wy[gid]
        ty = sy[gid] + k % wy[gid]
        hit = _overlaps(box[gid], tx, ty)
        gid, tx, ty = gid[hit], tx[hit], ty[hit]

        tile = ty * view.x_tiles + tx
        depth = z.to(torch.float32).clamp_min(1e-30).view(torch.int32).to(torch.int64)
        key, order = torch.sort((tile << 32) | depth[gid], stable=True)
        n_tiles = view.x_tiles * view.y_tiles
        starts = torch.searchsorted(
            key >> 32, torch.arange(n_tiles + 1, device=key.device, dtype=torch.int64))
        return Layout(gid=gid[order], tile_starts=starts, truncated=truncated)


def _overlaps(box, tx, ty):
    """Separating-axis test of boxes (M, 8) against tiles (M,)."""
    left = tx.to(box.dtype) * TILE
    right = left + TILE
    top = ty.to(box.dtype) * TILE
    bottom = top + TILE
    xs, ys = box[:, 0::2], box[:, 1::2]
    ok = ~((xs.amin(1) > right) | (xs.amax(1) < left))
    ok &= ~((ys.amin(1) > bottom) | (ys.amax(1) < top))

    def axis(ax, ay, p0x, p0y, p1x, p1y):
        corners = torch.stack([ax * left + ay * top, ax * right + ay * top,
                               ax * left + ay * bottom, ax * right + ay * bottom])
        o0, o1 = ax * p0x + ay * p0y, ax * p1x + ay * p1y
        return ~((corners.amin(0) > torch.maximum(o0, o1))
                 | (corners.amax(0) < torch.minimum(o0, o1)))

    ok &= axis(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1],
               box[:, 0], box[:, 1], box[:, 2], box[:, 3])
    ok &= axis(box[:, 2] - box[:, 6], box[:, 3] - box[:, 7],
               box[:, 2], box[:, 3], box[:, 6], box[:, 7])
    return ok


def pixel_basis(view: View, dtype=torch.float32):
    """(n_tiles, 256, n_sh): the SH basis along each pixel's world-frame ray."""
    K, dev = view.K, view.K.device
    W, H = view.x_tiles * TILE, view.y_tiles * TILE
    vv, uu = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev), indexing="ij")
    d = torch.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1],
                     torch.ones_like(uu)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ torch.linalg.inv(view.pose.to(torch.float32))[:3, :3].T.to(dtype)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return to_tiles(sh_basis(d, view.n_sh), view)


def to_tiles(img, view: View):
    """(H, W, C) -> (n_tiles, 256, C), zero-padded to whole tiles."""
    c = img.shape[-1]
    img = torch.nn.functional.pad(
        img, (0, 0, 0, view.x_tiles * TILE - img.shape[1], 0, view.y_tiles * TILE - img.shape[0]))
    img = img.reshape(view.y_tiles, TILE, view.x_tiles, TILE, c)
    return img.permute(0, 2, 1, 3, 4).reshape(-1, PIXELS, c)


def to_image(tiles, view: View):
    """(n_tiles, 256, C) -> (H, W, C)."""
    c = tiles.shape[-1]
    img = tiles.reshape(view.y_tiles, view.x_tiles, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(view.y_tiles * TILE, view.x_tiles * TILE, c)[: view.height, : view.width]


def _walk(rows, lay: Layout, view: View, tiles, chunk, visit):
    """Front-to-back walk over the listed tiles' splats, ``chunk`` at a time,
    the tiles ordered by splat count, largest first, so that the tiles
    still walking at each step lead.  ``visit(n, tile_ids, g, ok, alpha,
    T_in)`` gets each step's n walking tiles, their splats' ids and real
    slots (n, chunk), raw alpha (n, 256, chunk) and T before the step
    (n, 256), and returns T after it.  Returns (order, T): ``tiles[order]``
    is the walk's tile order, T the final transmittance in it."""
    counts = lay.counts[tiles]
    order = torch.argsort(counts, descending=True, stable=True)
    tiles, counts = tiles[order], counts[order]
    starts = lay.tile_starts[:-1][tiles]
    host_counts = counts.cpu()
    dt, dev = rows["u"].dtype, rows["u"].device
    p = torch.arange(PIXELS, device=dev)
    half = (TILE - 1) / 2
    up = (p % TILE).to(dt) - half
    vp = (p // TILE).to(dt) - half
    ox = ((tiles % view.x_tiles) * TILE).to(dt)[:, None]
    oy = ((tiles // view.x_tiles) * TILE).to(dt)[:, None]
    slot = torch.arange(chunk, device=dev)
    T = torch.ones(len(tiles), PIXELS, dtype=dt, device=dev)
    n_max = int(host_counts[0]) if len(tiles) else 0
    for j0 in range(0, n_max, chunk):
        n = int((host_counts > j0).sum())
        ok = (j0 + slot)[None, :] < counts[:n, None]
        idx = starts[:n, None] + j0 + slot[None, :]
        g = lay.gid[torch.where(ok, idx, torch.zeros_like(idx))]
        ul = ((rows["u"][g] - ox[:n]) - half)[:, None, :]
        vl = ((rows["v"][g] - oy[:n]) - half)[:, None, :]
        a, b, c = (rows[k][g][:, None, :] for k in "abc")
        rdet = 1.0 / (a * c - b * b)
        du = up[None, :, None] - ul
        dv = vp[None, :, None] - vl
        mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) * rdet
        prob = torch.where(mh > 0.0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
        alpha = rows["op"][g][:, None, :] * prob
        T_new = visit(n, tiles[:n], g, ok, alpha, T[:n])
        T = torch.cat([T_new, T[n:]]) if n < len(tiles) else T_new
    return order, T


def composite(rows, lay: Layout, view: View, tiles=None, basis=None, chunk=128):
    """Premultiplied colour (A, 256, 3) and final T (A, 256) of the tiles
    ``tiles`` (all when None), in that order, without the background.
    ``basis`` (n_tiles, 256, n_sh) selects per-pixel SH colour."""
    dev = rows["u"].device
    if tiles is None:
        tiles = torch.arange(view.x_tiles * view.y_tiles, device=dev)
    acc = [torch.zeros(len(tiles), PIXELS, 3, dtype=rows["u"].dtype, device=dev)]

    def visit(n, ids, g, ok, alpha, T_in):
        at = torch.where(ok[:, None, :] & (alpha >= ALPHA_SKIP), alpha, torch.zeros_like(alpha))
        prod = torch.cumprod(torch.cat([T_in[:, :, None], 1.0 - at], dim=2), dim=2)
        active = prod[..., :-1] >= T_EPS
        w = torch.where(active, at * prod[..., :-1], torch.zeros_like(at))
        if basis is None:
            rgb = torch.einsum("npc,ncd->npd", w, rows["colour"][g])
        else:
            # colour_d(p) = sum_k basis_k(p) coeff_dk, weighted by w
            m = torch.einsum("npc,ncdk->npdk", w, rows["colour"][g])
            rgb = (m * basis[ids][:, :, None, :]).sum(dim=3)
        rest = acc[0][n:]
        acc[0] = torch.cat([acc[0][:n] + rgb, rest]) if len(rest) else acc[0] + rgb
        return prod.gather(2, active.sum(dim=2, keepdim=True)).squeeze(2)

    order, T = _walk(rows, lay, view, tiles, chunk, visit)
    inv = torch.argsort(order)
    return acc[0][inv], T[inv]


def finish(rgb, T, view: View):
    """Image tiles with the background where T > BG_T_EPS."""
    w = torch.where(T > BG_T_EPS, T, torch.zeros_like(T))
    return rgb + w[..., None] * view.background.to(rgb.dtype)


def render(params: dict, alive, view: View, chunk=128):
    """One view: (image (H, W, 3), T (n_tiles, 256), layout), no gradient."""
    set_exact_float32()
    with torch.no_grad():
        rows = gaussian_rows(params, view)
        lay = layout(rows, visible(rows, alive, view), view)
        basis = pixel_basis(view, rows["u"].dtype) if rows["colour"].dim() == 3 else None
        rgb, T = composite(rows, lay, view, basis=basis, chunk=chunk)
        return to_image(finish(rgb, T, view), view), T, lay


# --- loss ---------------------------------------------------------------------


def _taps():
    x = torch.arange(SSIM_SIZE, dtype=torch.float64) - (SSIM_SIZE - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * SSIM_SIGMA ** 2))
    return [float(w) for w in (g / g.sum()).to(torch.float32)]


def _blur(img):
    """Separable 11-tap gaussian with reflect padding: rows, then columns."""
    taps = _taps()
    r = (SSIM_SIZE - 1) // 2
    for dim in (0, 1):
        n = img.shape[dim]
        idx = torch.arange(-r, n + r, device=img.device).abs()
        idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        p = img.index_select(dim, idx)
        out = None
        for t, w in enumerate(taps):
            s = p.narrow(dim, t, n) * w
            out = s if out is None else out + s
        img = out
    return img


def ssim(img, gt, c1=0.01 ** 2, c2=0.03 ** 2):
    mu_x, mu_y = _blur(img), _blur(gt)
    mxx, myy, mxy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sx = _blur(img * img) - mxx
    sy = _blur(gt * gt) - myy
    sxy = _blur(img * gt) - mxy
    return torch.mean(((2 * mxy + c1) * (2 * sxy + c2)) / ((mxx + myy + c1) * (sx + sy + c2)))


def train_loss(img, gt, ssim_frac=0.2):
    """(1 - f) L1 + f (1 - SSIM); |x| has derivative +1 at 0."""
    d = img - gt
    l1 = torch.mean(torch.where(d >= 0, d, -d))
    return (1.0 - ssim_frac) * l1 + ssim_frac * (1.0 - ssim(img, gt))


# --- one training step ------------------------------------------------------------


def _tile_groups(counts, pixels_per_group):
    """Tiles in groups whose splat-pixel pairs stay under a budget."""
    order = torch.argsort(counts, descending=True).cpu()
    c = counts.cpu()[order] * PIXELS
    groups, cur, total = [], [], 0
    for t, n in zip(order.tolist(), c.tolist()):
        if cur and total + n > pixels_per_group:
            groups.append(cur)
            cur, total = [], 0
        cur.append(t)
        total += n
    if cur:
        groups.append(cur)
    return groups


def grads(params: dict, alive, view: View, gt, ssim_frac=0.2, chunk=128,
          group_pairs=1 << 27):
    """Loss and gradients of one camera: (loss, {leaf: grad}, uv gradient
    (2, N), visible (N,), image).  ``gt`` is the (H, W, 3) target in the
    params' dtype.  The walk is differentiated one group of tiles at a time,
    each against the image's gradient, so the graph of one group is alive
    at a time."""
    set_exact_float32()
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    n = leaves["xyz"].shape[0]
    uv = torch.zeros(2, n, dtype=leaves["xyz"].dtype, device=alive.device, requires_grad=True)
    rows = gaussian_rows(leaves, view, uv)
    vis = visible({k: v.detach() for k, v in rows.items()}, alive, view)
    lay = layout(rows, vis, view)
    basis = pixel_basis(view, rows["u"].dtype) if rows["colour"].dim() == 3 else None
    keys = ("u", "v", "op", "a", "b", "c", "colour")
    flat = {k: rows[k].detach().requires_grad_(True) for k in keys}

    with torch.no_grad():
        rgb, T = composite(flat, lay, view, basis=basis, chunk=chunk)
        img = to_image(finish(rgb, T, view), view)
    img.requires_grad_(True)
    loss = train_loss(img, gt, ssim_frac)
    (g_img,) = torch.autograd.grad(loss, img)
    g_tiles = to_tiles(g_img, view)
    for group in _tile_groups(lay.counts, group_pairs):
        tiles = torch.tensor(group, device=alive.device)
        rgb_g, T_g = composite(flat, lay, view, tiles=tiles, basis=basis, chunk=chunk)
        out = finish(rgb_g, T_g, view)
        if out.requires_grad:
            torch.autograd.backward(out, g_tiles[tiles])
    torch.autograd.backward([rows[k] for k in keys if flat[k].grad is not None],
                            [flat[k].grad for k in keys if flat[k].grad is not None])
    g = {k: (leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k]))
         for k in LEAVES}
    g_uv = uv.grad if uv.grad is not None else torch.zeros_like(uv)
    return loss.detach(), g, g_uv, vis, img.detach()


def lr_multipliers(config: dict) -> dict:
    return dict(xyz=config["xyz_lr_multiplier"], quaternion=config["quat_lr_multiplier"],
                scale=config["scale_lr_multiplier"], opacity=config["opacity_lr_multiplier"],
                rgb=config["rgb_lr_multiplier"], sh=config["sh_lr_multiplier"])


def train_steps(params0: dict, alive, views, gts, config: dict, chunk=128):
    """Training steps from ``params0`` with zero Adam state, one per view
    (gts: uint8 (H, W, 3) each, over 255): Adam with a shared count, bias
    corrections formed in float64, eps after the square root, each leaf's
    rate ``base_lr * multiplier``; a step whose loss or any gradient is not
    finite changes nothing.  Beside it the densification signals: |uv
    gradient| * (fx, fy) and |xyz gradient| at the visible gaussians, and
    how many views saw each.  Returns a dict: losses (floats), first_grads
    (the first step's gradients), params (after the last step), and the
    accumulators."""
    dt = params0["xyz"].dtype
    p = {k: params0[k].detach().clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    n = alive.shape[0]
    acc_uv = torch.zeros(n, 2, dtype=dt, device=alive.device)
    acc_xyz = torch.zeros(n, 3, dtype=dt, device=alive.device)
    count = torch.zeros(n, dtype=torch.int32, device=alive.device)
    mult = lr_multipliers(config)
    losses, first, steps = [], None, 0
    for view, gt in zip(views, gts):
        target = gt.to(dt) * (1.0 / config["saturated_pixel_value"])
        loss, g, g_uv, vis, _ = grads(p, alive, view, target, config["ssim_frac"], chunk)
        losses.append(float(loss))
        if first is None:
            first = {k: v.clone() for k, v in g.items()}
        ok = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v.sum())) for v in g.values())
        if not ok:
            continue
        steps += 1
        bc1 = float(1.0 - ADAM_B1 ** steps)
        bc2 = float(1.0 - ADAM_B2 ** steps)
        bc1 = torch.tensor(bc1, dtype=torch.float32).to(dt).item()
        bc2 = torch.tensor(bc2, dtype=torch.float32).to(dt).item()
        with torch.no_grad():
            for k in LEAVES:
                mu[k] = (1 - ADAM_B1) * g[k] + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * (g[k] * g[k]) + ADAM_B2 * nu[k]
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
                p[k] = p[k] + (upd * mult[k]) * -config["base_lr"]
            fxfy = torch.stack([view.K[0, 0], view.K[1, 1]]).to(dt)
            acc_uv += (g_uv.abs() * fxfy[:, None] * vis[None, :]).T
            acc_xyz += g["xyz"].abs()
            count += vis.to(torch.int32)
    return dict(losses=losses, first_grads=first, params=p, uv_grad_accum=acc_uv,
                xyz_grad_accum=acc_xyz, grad_accum_count=count, steps=steps)
