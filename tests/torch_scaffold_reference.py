"""Plain PyTorch reference of a Scaffold-GS training step (Lu et al., CVPR
2024, arXiv:2312.00109; code github.com/city-super/Scaffold-GS) for
``tests/test_torch_scaffold.py``, at the tests' small sizes.

It decodes as the source's ``generate_neural_gaussians`` does, with boolean
masks, composites every tile densely against all of its gaussians, and
takes loss and gradients from autograd.  Nothing here imports JAX or either
package: every input is a tensor the test made.

Departures from the source, each as the port makes it:
- the anchors decoded are the alive ones whose centres lie in the view's
  frustum (camera z within [near, far], the projection within the image
  padded by ``padding`` px); the source prefilters with a rasterizer pass
  over the anchors' footprints;
- the rasterizer has the port's tile semantics, not the source's
  diff-gaussian-rasterization: EWA covariance with +0.25 on the diagonal;
  a gaussian reaches the 16 px tiles that its opacity-aware ellipse
  (mh_dist sigma, shrunk to where alpha can reach 1/255) overlaps, by an
  oriented box and a separating-axis test; each tile's gaussians in
  camera-z order; alpha = opacity * exp(-mh / 2), skipped below 1/255 and
  composited while T >= 1e-4; the background added where T > 1e-3; the
  neural gaussians culled by the same frustum test as the anchors;
- Adam with eps 1e-8 (the source's 1e-15), one step count for every leaf,
  bias corrections formed in float64; the source's initial learning rates
  with no schedule; the anchor positions held fixed (the source's rate 0);
- no anchor growing or pruning.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_OFFSETS = 10
TILE = 16
ALPHA_SKIP = 0.00392156862
T_EPS = 1e-4
BG_T_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HEADS = dict(mlp_opacity=N_OFFSETS, mlp_cov=7 * N_OFFSETS, mlp_color=3 * N_OFFSETS)
LEAVES = ("offset", "anchor_feat", "scaling", "mlp_opacity", "mlp_cov", "mlp_color")
RATES = dict(offset=0.01, anchor_feat=0.0075, scaling=0.007, mlp_opacity=0.002,
             mlp_cov=0.004, mlp_color=0.008)
VOLUME_WEIGHT = 0.01


def mlp(layers, x, act=None):
    """Linear, ReLU, Linear, then ``act``: layers = (w1, b1, w2, b2)."""
    w1, b1, w2, b2 = layers
    y = torch.relu(x @ w1.T + b1) @ w2.T + b2
    return y if act is None else act(y)


def camera_centre(pose):
    return -pose[:3, :3].T @ pose[:3, 3]


def project(xyz, pose, K):
    """Camera-frame points (N, 3) and pixel coordinates u, v."""
    pc = xyz @ pose[:3, :3].T + pose[:3, 3]
    return pc, K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2], K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]


def in_frustum(pc, u, v, width, height, near, far, padding):
    z = pc[:, 2]
    return ((z >= near) & (z <= far) & (u >= -padding) & (u <= width + padding)
            & (v >= -padding) & (v <= height + padding))


def decode(p, anchor, alive, pose, K, width, height, near, far, padding):
    """The source's neural gaussians of the anchors in view: dict xyz,
    scaling (linear), rot (normalised), opacity (N,), colour."""
    pc, u, v = project(anchor, pose, K)
    vis = in_frustum(pc, u, v, width, height, near, far, padding) & alive
    feat = p["anchor_feat"][vis]
    x = anchor[vis]
    offsets = p["offset"][vis].reshape(-1, 3)
    grid_scaling = torch.exp(p["scaling"][vis])
    ob_view = x - camera_centre(pose)
    ob_view = ob_view / ob_view.norm(dim=1, keepdim=True)
    inp = torch.cat([feat, ob_view], dim=1)
    neural_opacity = mlp(p["mlp_opacity"], inp, torch.tanh).reshape(-1, 1)
    mask = (neural_opacity > 0.0).view(-1)
    opacity = neural_opacity[mask]
    color = mlp(p["mlp_color"], inp, torch.sigmoid).reshape(-1, 3)
    scale_rot = mlp(p["mlp_cov"], inp).reshape(-1, 7)
    rep = torch.cat([grid_scaling, x], dim=-1).repeat_interleave(N_OFFSETS, dim=0)
    masked = torch.cat([rep, color, scale_rot, offsets], dim=-1)[mask]
    scaling_repeat, repeat_anchor, color, scale_rot, offsets = masked.split(
        [6, 3, 3, 7, 3], dim=-1)
    scaling = scaling_repeat[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = F.normalize(scale_rot[:, 3:7])
    xyz = repeat_anchor + offsets * scaling_repeat[:, :3]
    return dict(xyz=xyz, scaling=scaling, rot=rot, opacity=opacity[:, 0], colour=color)


def rotation(q):
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * z * x + 2 * w * y,
        2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x,
        2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y,
    ], dim=1).reshape(-1, 3, 3)


def splat_rows(g, pose, K):
    """u, v, z and the regularised 2D covariance a, b, c of each gaussian."""
    pc, u, v = project(g["xyz"], pose, K)
    R = rotation(g["rot"])
    sigma = R @ torch.diag_embed(g["scaling"] ** 2) @ R.transpose(1, 2)
    x, y, z = pc.unbind(1)
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([K[0, 0] / z, zero, -K[0, 0] * x / (z * z)], 1),
                     torch.stack([zero, K[1, 1] / z, -K[1, 1] * y / (z * z)], 1)], 1)
    M = J @ pose[:3, :3]
    cov = M @ sigma @ M.transpose(1, 2)
    return dict(pc=pc, u=u, v=v, a=cov[:, 0, 0] + 0.25, b=cov[:, 0, 1], c=cov[:, 1, 1] + 0.25)


def tile_membership(r, op, vis, width, height, mh_dist):
    """(N, n_tiles) bool: the tiles each visible gaussian's box overlaps."""
    with torch.no_grad():
        u, v, a, b, c = (r[k].detach() for k in ("u", "v", "a", "b", "c"))
        op = op.detach()
        mh = torch.sqrt((2.0 * torch.log(op.clamp_min(1e-12) / ALPHA_SKIP)).clamp_min(0.0))
        mh = mh.clamp_max(mh_dist)
        vis = vis & (op > ALPHA_SKIP)
        mean = (a + c) * 0.5
        half = torch.sqrt((a - c) * (a - c) * 0.25 + b * b)
        r1, r2 = mh * torch.sqrt(mean + half), mh * torch.sqrt((mean - half).clamp_min(0))
        theta = torch.where(b.abs() < 1e-16,
                            torch.where(a >= c, torch.zeros_like(a),
                                        torch.full_like(a, math.pi / 2)),
                            torch.atan2(mean + half - a, b))
        ct, st = torch.cos(theta), torch.sin(theta)
        box = torch.stack([-r1 * ct + r2 * st + u, -r1 * st - r2 * ct + v,
                           r1 * ct + r2 * st + u, r1 * st - r2 * ct + v,
                           -r1 * ct - r2 * st + u, -r1 * st + r2 * ct + v,
                           r1 * ct - r2 * st + u, r1 * st + r2 * ct + v], dim=1)
        xt, yt = -(-width // TILE), -(-height // TILE)
        xs, ys = box[:, 0::2], box[:, 1::2]
        sx = torch.floor(xs.amin(1) / TILE).clamp(0, xt)
        ex = (torch.floor(xs.amax(1) / TILE) + 1).clamp(0, xt)
        sy = torch.floor(ys.amin(1) / TILE).clamp(0, yt)
        ey = (torch.floor(ys.amax(1) / TILE) + 1).clamp(0, yt)
        ty, tx = torch.meshgrid(torch.arange(yt, device=u.device),
                                torch.arange(xt, device=u.device), indexing="ij")
        tx, ty = tx.reshape(1, -1).to(u.dtype), ty.reshape(1, -1).to(u.dtype)
        inside = ((tx >= sx[:, None]) & (tx < ex[:, None]) & (ty >= sy[:, None])
                  & (ty < ey[:, None]))
        left, top = tx * TILE, ty * TILE
        right, bottom = left + TILE, top + TILE
        ok = ~((xs.amin(1)[:, None] > right) | (xs.amax(1)[:, None] < left))
        ok &= ~((ys.amin(1)[:, None] > bottom) | (ys.amax(1)[:, None] < top))
        # the box's major axis (corner 0 to 1) and minor axis (corner 3 to 1),
        # each with the box's extent along it from a pair of its corners
        for (i, j), (p, q) in (((2, 0), (0, 2)), ((2, 6), (2, 6))):
            ax = (box[:, i] - box[:, j])[:, None]
            ay = (box[:, i + 1] - box[:, j + 1])[:, None]
            corners = torch.stack([ax * left + ay * top, ax * right + ay * top,
                                   ax * left + ay * bottom, ax * right + ay * bottom])
            o0 = ax * box[:, p, None] + ay * box[:, p + 1, None]
            o1 = ax * box[:, q, None] + ay * box[:, q + 1, None]
            ok &= ~((corners.amin(0) > torch.maximum(o0, o1))
                    | (corners.amax(0) < torch.minimum(o0, o1)))
        return inside & ok & vis[:, None]


def render(g, pose, K, width, height, background, *, near, far, padding, mh_dist):
    """(H, W, 3) image of the neural gaussians ``g``, differentiable."""
    r = splat_rows(g, pose, K)
    vis = in_frustum(r["pc"], r["u"], r["v"], width, height, near, far, padding)
    member = tile_membership(r, g["opacity"], vis, width, height, mh_dist)
    xt, yt = -(-width // TILE), -(-height // TILE)
    order = torch.argsort(r["pc"][:, 2].detach(), stable=True)
    dt = r["u"].dtype
    dev = r["u"].device
    py, px = torch.meshgrid(torch.arange(yt * TILE, dtype=dt, device=dev),
                            torch.arange(xt * TILE, dtype=dt, device=dev), indexing="ij")
    tile = (py.long() // TILE) * xt + px.long() // TILE  # (H', W')
    du = px[..., None] - r["u"][order]
    dv = py[..., None] - r["v"][order]
    a, b, c = r["a"][order], r["b"][order], r["c"][order]
    mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) / (a * c - b * b)
    alpha = g["opacity"][order] * torch.where(mh > 0, torch.exp(-0.5 * mh),
                                              torch.zeros_like(mh))
    keep = member[order].T[tile] & (alpha >= ALPHA_SKIP)
    at = torch.where(keep, alpha, torch.zeros_like(alpha))
    T_all = torch.cumprod(torch.cat([torch.ones_like(at[..., :1]), 1.0 - at], -1), -1)
    active = T_all[..., :-1] >= T_EPS
    w = torch.where(active, at * T_all[..., :-1], torch.zeros_like(at))
    rgb = w @ g["colour"][order]
    T = T_all.gather(-1, active.sum(-1, keepdim=True))
    img = rgb + torch.where(T > BG_T_EPS, T, torch.zeros_like(T)) * background
    return img[:height, :width]


def _blur(img):
    """Separable 11-tap gaussian (sigma 1.5), reflect padding."""
    x = torch.arange(11, dtype=torch.float64) - 5.0
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    taps = [float(w) for w in (g / g.sum()).to(torch.float32)]
    for dim in (0, 1):
        n = img.shape[dim]
        idx = torch.arange(-5, n + 5, device=img.device).abs()
        idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        p = img.index_select(dim, idx)
        img = sum(p.narrow(dim, t, n) * w for t, w in enumerate(taps))
    return img


def ssim(img, gt, c1=0.01 ** 2, c2=0.03 ** 2):
    mx, my = _blur(img), _blur(gt)
    sx = _blur(img * img) - mx * mx
    sy = _blur(gt * gt) - my * my
    sxy = _blur(img * gt) - mx * my
    return torch.mean(((2 * mx * my + c1) * (2 * sxy + c2))
                      / ((mx * mx + my * my + c1) * (sx + sy + c2)))


def loss_of(p, anchor, alive, pose, K, gt, background, cfg):
    """0.8 L1 + 0.2 (1 - SSIM) + 0.01 * mean product of scales, the image
    and the neural gaussians."""
    w, h = cfg["width"], cfg["height"]
    g = decode(p, anchor, alive, pose, K, w, h, cfg["near"], cfg["far"], cfg["padding"])
    img = render(g, pose, K, w, h, background, near=cfg["near"], far=cfg["far"],
                 padding=cfg["padding"], mh_dist=cfg["mh_dist"])
    d = img - gt
    l1 = torch.mean(torch.where(d >= 0, d, -d))
    loss = 0.8 * l1 + 0.2 * (1.0 - ssim(img, gt))
    return loss + VOLUME_WEIGHT * g["scaling"].prod(dim=1).mean(), img, g


def grads(p, anchor, alive, pose, K, gt, background, cfg):
    """(loss, gradient by leaf, image): each MLP's leaf is its four tensors."""
    leaves = {k: [t.detach().requires_grad_(True) for t in p[k]] if k in HEADS
              else p[k].detach().requires_grad_(True) for k in LEAVES}
    loss, img, _ = loss_of(leaves, anchor, alive, pose, K, gt, background, cfg)
    flat = [t for k in LEAVES for t in (leaves[k] if k in HEADS else [leaves[k]])]
    got = iter(torch.autograd.grad(loss, flat))
    out = {k: [next(got) for _ in leaves[k]] if k in HEADS else next(got) for k in LEAVES}
    return loss.detach(), out, img.detach()


def adam_step(p, g, mu, nu, count):
    """One Adam step of every leaf at its rate (tensors or MLP lists)."""
    bc1 = float(torch.tensor(1.0 - ADAM_B1 ** count, dtype=torch.float64).float())
    bc2 = float(torch.tensor(1.0 - ADAM_B2 ** count, dtype=torch.float64).float())

    def one(p, g, m, n, rate):
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        n = (1 - ADAM_B2) * (g * g) + ADAM_B2 * n
        return p - ((m / bc1) / (torch.sqrt(n / bc2) + ADAM_EPS)) * rate, m, n

    out = {}
    for k in LEAVES:
        if k in HEADS:
            out[k] = [one(*z, RATES[k]) for z in zip(p[k], g[k], mu[k], nu[k])]
        else:
            out[k] = one(p[k], g[k], mu[k], nu[k], RATES[k])

    def pick(i):
        return {k: [t[i] for t in v] if k in HEADS else v[i] for k, v in out.items()}

    return pick(0), pick(1), pick(2)
