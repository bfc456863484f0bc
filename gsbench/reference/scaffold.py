"""Plain PyTorch reference of a Scaffold-GS training step and view (Lu et
al., "Scaffold-GS: Structured 3D Gaussians for View-Adaptive Rendering",
CVPR 2024, arXiv:2312.00109; code github.com/city-super/Scaffold-GS).

Per camera it decodes the anchors as the source's
``generate_neural_gaussians`` does, with boolean masks: the MLPs read
[feature, unit view direction], each anchor gives 10 neural gaussians
(position anchor + offset * exp(scaling)[:3], scale exp(scaling)[3:] *
sigmoid(cov[:3]), rotation normalize(cov[3:7]), opacity from the tanh
head, colour from the sigmoid head), and those of opacity > 0 are
rendered.  It then composites them with ``splat.py``'s tile semantics and
differentiates with autograd, tile group by tile group (``splat.grads``'
blocks), never through a hand-written backward.  The loss is 0.8 L1 +
0.2 (1 - SSIM) + 0.01 * the mean over the rendered gaussians of the
product of their scales (the source's volume term).  Nothing here imports
the program or JAX.

Departures from the source, each as the benchmarked program makes it:
- the anchors decoded are the alive ones whose centres pass the frustum
  test of ``splat.visible`` (camera z within [near, far], the projection
  within the image padded by ``padding`` px); the source prefilters with a
  rasterizer pass over the anchors' footprints;
- the rasterizer is ``splat.py``'s (EWA covariance with +0.25 on the
  diagonal, opacity-aware 3-sigma tile boxes, 16 px tiles, depth order by
  camera z, alpha skipped below 1/255, T_EPS 1e-4, background where T >
  1e-3), not the source's diff-gaussian-rasterization; the neural
  gaussians pass the same frustum test as the anchors;
- Adam with eps 1e-8 (the source's 1e-15), one step count for every leaf,
  bias corrections formed in float64; the source's initial learning rates
  with no schedule; the anchor positions held fixed (the source trains
  them at rate 0); the offsets' rate not scaled by the scene's extent;
- no anchor growing or pruning.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gsbench.reference import splat

N_OFFSETS = 10
HEADS = dict(mlp_opacity=N_OFFSETS, mlp_cov=7 * N_OFFSETS, mlp_color=3 * N_OFFSETS)
ANCHOR_LEAVES = ("offset", "anchor_feat", "scaling")
LEAVES = ANCHOR_LEAVES + tuple(HEADS)


def mlp(layers, x, act=None):
    """Linear, ReLU, Linear, then ``act``: layers = (w1, b1, w2, b2)."""
    w1, b1, w2, b2 = layers
    y = torch.relu(x @ w1.T + b1) @ w2.T + b2
    return y if act is None else act(y)


def anchors_in_view(anchor, alive, view: splat.View):
    """Alive anchors whose centres pass the frustum test."""
    x, y, z = anchor.T
    R, t, K = view.pose[:3, :3], view.pose[:3, 3], view.K
    xc = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    yc = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    zc = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return splat.visible(dict(u=K[0, 0] * xc / zc + K[0, 2], v=K[1, 1] * yc / zc + K[1, 2],
                              z=zc), alive, view)


def decode(p: dict, anchor, alive, view: splat.View) -> dict:
    """The source's neural gaussians of the anchors in view: xyz, scaling
    (linear), rot (normalised), opacity (N,), colour, and ``anchors``, the
    number of anchors decoded.  ``p`` holds the anchor leaves and each
    MLP's (w1, b1, w2, b2)."""
    vis = anchors_in_view(anchor, alive, view)
    feat = p["anchor_feat"][vis]
    x = anchor[vis]
    offsets = p["offset"][vis].reshape(-1, 3)
    grid_scaling = torch.exp(p["scaling"][vis])
    centre = -view.pose[:3, :3].T @ view.pose[:3, 3]
    ob_view = x - centre
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
    return dict(xyz=xyz, scaling=scaling, rot=rot, opacity=opacity[:, 0], colour=color,
                anchors=int(vis.sum()))


def splat_params(g: dict) -> dict:
    """The neural gaussians as ``splat.py``'s parameters (log scale,
    pre-sigmoid opacity, no colour): what ``work.pair_counts`` takes."""
    n, dt, dev = g["xyz"].shape[0], g["xyz"].dtype, g["xyz"].device
    return dict(xyz=g["xyz"], quaternion=g["rot"], scale=torch.log(g["scaling"]),
                opacity=torch.logit(g["opacity"])[:, None],
                rgb=torch.zeros(n, 3, dtype=dt, device=dev),
                sh=torch.zeros(n, 3, 15, dtype=dt, device=dev))


def rows_of(g: dict, view: splat.View) -> dict:
    """What compositing reads of each neural gaussian (``splat.
    gaussian_rows``), with its decoded opacity and colour."""
    n, dt, dev = g["xyz"].shape[0], g["xyz"].dtype, g["xyz"].device
    zero = torch.zeros(n, 3, dtype=dt, device=dev)
    rows = splat.gaussian_rows(dict(xyz=g["xyz"], quaternion=g["rot"],
                                    scale=torch.log(g["scaling"]), rgb=zero,
                                    opacity=zero[:, :1]), view)
    return dict(rows, op=g["opacity"], colour=g["colour"])


def volume(g: dict):
    return g["scaling"].prod(dim=1).mean()


def render(p: dict, anchor, alive, view: splat.View, chunk=128):
    """One view: (image (H, W, 3), T (n_tiles, 256), neural gaussians), no
    gradient."""
    splat.set_exact_float32()
    with torch.no_grad():
        g = decode(p, anchor, alive, view)
        rows = rows_of(g, view)
        everyone = torch.ones(rows["u"].shape[0], dtype=torch.bool, device=anchor.device)
        lay = splat.layout(rows, splat.visible(rows, everyone, view), view)
        rgb, T = splat.composite(rows, lay, view, chunk=chunk)
        return splat.to_image(splat.finish(rgb, T, view), view), T, g


def _leaves(p: dict) -> dict:
    return {k: [t.detach().requires_grad_(True) for t in p[k]] if k in HEADS
            else p[k].detach().requires_grad_(True) for k in LEAVES}


def _tensors(leaves: dict) -> list:
    return [t for k in LEAVES for t in (leaves[k] if k in HEADS else [leaves[k]])]


def grads(p: dict, anchor, alive, view: splat.View, gt, ssim_frac=0.2, volume_weight=0.01,
          chunk=128, group_pairs=1 << 27):
    """Loss and gradients of one camera: (loss, {leaf: grad}; an MLP's is
    its list of four).  ``gt`` is the (H, W, 3) target in the params'
    dtype.  As ``splat.grads``: the walk is differentiated one group of
    tiles at a time against the image's gradient, then autograd carries
    the rows' gradients, with the volume term's, back through the decode."""
    splat.set_exact_float32()
    leaves = _leaves(p)
    g = decode(leaves, anchor, alive, view)
    rows = rows_of(g, view)
    everyone = torch.ones(rows["u"].shape[0], dtype=torch.bool, device=anchor.device)
    vis = splat.visible({k: v.detach() for k, v in rows.items()}, everyone, view)
    lay = splat.layout(rows, vis, view)
    keys = ("u", "v", "op", "a", "b", "c", "colour")
    flat = {k: rows[k].detach().requires_grad_(True) for k in keys}
    with torch.no_grad():
        rgb, T = splat.composite(flat, lay, view, chunk=chunk)
        img = splat.to_image(splat.finish(rgb, T, view), view)
    img.requires_grad_(True)
    image_loss = splat.train_loss(img, gt, ssim_frac)
    (g_img,) = torch.autograd.grad(image_loss, img)
    g_tiles = splat.to_tiles(g_img, view)
    for group in splat._tile_groups(lay.counts, group_pairs):
        tiles = torch.tensor(group, device=anchor.device)
        rgb_g, T_g = splat.composite(flat, lay, view, tiles=tiles, chunk=chunk)
        out = splat.finish(rgb_g, T_g, view)
        if out.requires_grad:
            torch.autograd.backward(out, g_tiles[tiles])
    vol = volume_weight * volume(g)
    got = [k for k in keys if flat[k].grad is not None]
    torch.autograd.backward([rows[k] for k in got] + [vol],
                            [flat[k].grad for k in got] + [torch.ones_like(vol)])
    out = {}
    for k in LEAVES:
        ts = leaves[k] if k in HEADS else [leaves[k]]
        gs = [t.grad if t.grad is not None else torch.zeros_like(t) for t in ts]
        out[k] = gs if k in HEADS else gs[0]
    return (image_loss + vol).detach(), out


def _map(fn, *trees):
    return {k: [fn(*z) for z in zip(*(t[k] for t in trees))] if k in HEADS
            else fn(*(t[k] for t in trees)) for k in LEAVES}


def train_steps(p0: dict, anchor, alive, views, gts, splat_config: dict, rates: dict,
                volume_weight=0.01, chunk=128):
    """Training steps from ``p0`` with zero Adam state, one per view
    (gts: uint8 (H, W, 3) each, over 255): Adam with a shared count, bias
    corrections formed in float64, eps after the square root, each leaf at
    its rate; a step whose loss or any gradient is not finite changes
    nothing.  Returns a dict: losses (floats), first_grads (the first
    step's gradients), params (after the last step)."""
    p = _map(lambda t: t.detach().clone(), p0)
    mu = _map(torch.zeros_like, p)
    nu = _map(torch.zeros_like, p)
    losses, first, steps = [], None, 0
    for view, gt in zip(views, gts):
        target = gt.to(anchor.dtype) * (1.0 / splat_config["saturated_pixel_value"])
        loss, g = grads(p, anchor, alive, view, target, splat_config["ssim_frac"],
                        volume_weight, chunk)
        losses.append(float(loss))
        if first is None:
            first = _map(torch.clone, g)
        ok = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t.sum()))
                                                for t in _tensors(g))
        if not ok:
            continue
        steps += 1
        bc1 = torch.tensor(float(1.0 - splat.ADAM_B1 ** steps), dtype=torch.float32)
        bc2 = torch.tensor(float(1.0 - splat.ADAM_B2 ** steps), dtype=torch.float32)
        bc1, bc2 = bc1.to(anchor.dtype).item(), bc2.to(anchor.dtype).item()
        with torch.no_grad():
            mu = _map(lambda m, d: (1 - splat.ADAM_B1) * d + splat.ADAM_B1 * m, mu, g)
            nu = _map(lambda n, d: (1 - splat.ADAM_B2) * (d * d) + splat.ADAM_B2 * n, nu, g)
            for k in LEAVES:
                def step(t, m, n, rate=rates[k]):
                    return t - ((m / bc1) / (torch.sqrt(n / bc2) + splat.ADAM_EPS)) * rate
                p[k] = ([step(*z) for z in zip(p[k], mu[k], nu[k])] if k in HEADS
                        else step(p[k], mu[k], nu[k]))
    return dict(losses=losses, first_grads=first, params=p, steps=steps)
