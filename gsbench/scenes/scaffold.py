"""The scene maker ``scaffold``: a garden-scale Scaffold-GS scene of anchors
bootstrapped from the committed sample of a trained scene, on the device,
from the seed.

The law, under the configuration's ``scaffold``: n anchors resampled from
the sample with replacement, their positions jittered by ``jitter_nn``
times the sample point's nearest-neighbour distance times a standard
normal (``bootstrap.py``'s law); ``scaling`` the log of each anchor's
distance to its neighbours, the square root of the mean of the squared
distances to its ``knn`` nearest anchors (the source's initialisation,
simple-knn's ``distCUDA2``), floored at 1e-7 squared, repeated 6 times;
offsets uniform in [-offset_range, offset_range) and features normal with
std ``feat_std`` (the source starts both at zero; a trained scene's are
not); each MLP's weights and biases uniform in +-1/sqrt(fan_in), PyTorch's
default ``Linear`` initialisation, drawn from ``mlp_seed`` and not from the
run's seed: as a trained model's weights, they are the same in every run.
A handful of weights sets how many neural gaussians reach opacity > 0 and
how large they are, so weights drawn anew each run would change the
cell's work, and its memory, from run to run.  Dead slots are zero.  The cameras look
at the centroid from ``distance_r95`` times the 95th percentile of the
anchors' distances to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import scene
from gsbench.spec import HERE

KNN_BLOCK = 1024  # points a step of the neighbour search takes at a time
KNN_CHUNK = 1 << 16  # candidates it compares them with at a time


def _spread(x):
    """The 10 low bits of x, two zero bits after each (a Morton code's axis)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def neighbour_scale(xyz, k: int):
    """sqrt(mean squared distance to the k nearest other points), exact.

    The points are sorted along a Morton curve and cut into blocks of
    ``KNN_BLOCK``.  A block's k-th-nearest distances among itself and its
    two neighbours along the curve bound its points' true ones from above;
    every point within that bound lies in a block whose bounding box comes
    that close to the block's, and only those blocks are searched."""
    n = xyz.shape[0]
    lo, hi = xyz.min(0).values, xyz.max(0).values
    q = ((xyz - lo) / (hi - lo).clamp_min(1e-12) * 1023).long().clamp(0, 1023)
    order = torch.argsort(_spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2),
                          stable=True)
    pts = xyz[order]
    blocks = pts.split(KNN_BLOCK)
    box_lo = torch.stack([b.min(0).values for b in blocks])
    box_hi = torch.stack([b.max(0).values for b in blocks])

    def nearest(a, b):
        """Squared distances of a's points to their k + 1 nearest in b,
        ``KNN_CHUNK`` of b at a time."""
        best = None
        for c in b.split(KNN_CHUNK):
            d = ((a[:, None, :] - c[None, :, :]) ** 2).sum(-1)
            d = d if best is None else torch.cat([best, d], dim=1)
            best = d.topk(min(k + 1, d.shape[1]), largest=False).values
        return best

    bound = torch.stack([nearest(b, pts[max(0, (i - 1) * KNN_BLOCK):(i + 2) * KNN_BLOCK])
                         [:, -1].max() for i, b in enumerate(blocks)])
    gap = ((box_lo[None] - box_hi[:, None]).clamp_min(0)
           + (box_lo[:, None] - box_hi[None]).clamp_min(0))
    reach = ((gap * gap).sum(-1) <= bound[:, None]).cpu()  # query block -> blocks in reach
    out = torch.empty(n, dtype=xyz.dtype, device=xyz.device)
    for i, b in enumerate(blocks):
        cand = torch.cat([blocks[j] for j in torch.nonzero(reach[i]).squeeze(1).tolist()])
        out[i * KNN_BLOCK:i * KNN_BLOCK + b.shape[0]] = nearest(b, cand)[:, 1:].mean(1)
    scale = torch.empty_like(out)
    scale[order] = torch.sqrt(out.clamp_min(1e-7))
    return scale


def make(config: dict, alive_count: int, seed: int, device) -> dict:
    """The scene's anchor slots on ``device``: a dict of ``params``
    (anchor, offset, anchor_feat, scaling, capacity rows; each MLP's
    (w1, b1, w2, b2) by name), ``alive``, and the centroid and framing
    distance."""
    law = config["scaffold"]
    sample = np.load(HERE / law["sample"])
    cap, n = config["capacity"], alive_count
    k_off, feat_dim, hidden = config["n_offsets"], config["feat_dim"], config["hidden_dim"]
    gen = scene.generator(seed, device)
    src = {k: torch.from_numpy(np.ascontiguousarray(sample[k])).to(device) for k in ("xyz", "nn")}
    pick = torch.randint(0, src["xyz"].shape[0], (n,), generator=gen, device=device)
    jitter = torch.randn(n, 3, generator=gen, device=device)
    xyz = src["xyz"][pick] + law["jitter_nn"] * src["nn"][pick][:, None] * jitter
    r = law["offset_range"]
    offset = torch.rand(n, k_off, 3, generator=gen, device=device) * (2 * r) - r
    feat = law["feat_std"] * torch.randn(n, feat_dim, generator=gen, device=device)

    def slots(rows):
        out = torch.zeros((cap,) + tuple(rows.shape[1:]), dtype=torch.float32, device=device)
        out[:n] = rows
        return out

    params = dict(anchor=slots(xyz), offset=slots(offset), anchor_feat=slots(feat),
                  scaling=slots(torch.log(neighbour_scale(xyz, law["knn"]))[:, None]
                                .repeat(1, 6)))
    fan_in = feat_dim + 3
    gen = scene.generator(law["mlp_seed"], device)  # the same weights in every run
    for name, width in config["mlp_outputs"].items():
        layers = []
        for shape, fan in (((hidden, fan_in), fan_in), ((hidden,), fan_in),
                           ((width, hidden), hidden), ((width,), hidden)):
            bound = 1.0 / math.sqrt(fan)
            layers.append((torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound)
        params[name] = tuple(layers)
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    centroid = xyz.mean(0)
    r95 = torch.quantile(torch.linalg.norm(xyz - centroid, dim=1), 0.95)
    return dict(params=params, alive=alive, centroid=centroid,
                distance=float(r95) * law["distance_r95"])
