"""The scene maker ``bootstrap``: a garden-scale scene bootstrapped from
the committed sample of a trained scene (``bench.py``'s ``build_workload``,
rewritten in torch), on the device, from the seed.

The law, under the configuration's ``bootstrap``: n gaussians resampled
from the sample with replacement, positions jittered by half the sample
point's nearest-neighbour distance times a standard normal, log-scales
shrunk by ln(1.6) * log2(n / the sample's source count) (each ADC split
divides a scale by 1.6, so a scene densified by a factor b went through
log2(b) rounds of splits), opacity and rotation as sampled, DC colour
uniform in [0, 1) over 0.2821, higher SH bands zero.  The cameras look at
the centroid from 2.2 times the 95th percentile of the distances to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import scene
from gsbench.spec import HERE


def make(config: dict, alive_count: int, seed: int, device) -> dict:
    """The scene's slots on ``device``: a dict of the parameter tensors
    (capacity rows; dead slots zero with an identity rotation), ``alive``,
    and the centroid and framing distance."""
    law = config["bootstrap"]
    sample = np.load(HERE / law["sample"])
    cap = config["capacity"]
    n = alive_count
    gen = scene.generator(seed, device)
    src = {k: torch.from_numpy(np.ascontiguousarray(sample[k])).to(device)
           for k in ("xyz", "scale", "opacity", "quat", "nn")}
    pick = torch.randint(0, src["xyz"].shape[0], (n,), generator=gen, device=device)
    jitter = torch.randn(n, 3, generator=gen, device=device)
    xyz = src["xyz"][pick] + law["jitter_nn"] * src["nn"][pick][:, None] * jitter
    boost = n / float(int(sample["n_alive"]))
    shrink = math.log(law["split_scale_factor"]) * math.log2(max(boost, 1.0))
    rgb = torch.rand(n, 3, generator=gen, device=device) / law["rgb_over"]

    def slots(rows, width, fill=0.0):
        out = torch.full((cap, width), fill, dtype=torch.float32, device=device)
        out[:n] = rows
        return out

    quat = slots(src["quat"][pick], 4)
    quat[n:, 0] = 1.0
    params = dict(
        xyz=slots(xyz, 3), rgb=slots(rgb, 3), opacity=slots(src["opacity"][pick], 1),
        scale=slots(src["scale"][pick] - shrink, 3), quaternion=quat,
        sh=torch.zeros(cap, 3, scene.SH_REST, dtype=torch.float32, device=device),
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    centroid = xyz.mean(0)
    r95 = torch.quantile(torch.linalg.norm(xyz - centroid, dim=1), 0.95)
    return dict(params=params, alive=alive, centroid=centroid,
                distance=float(r95) * law["distance_r95"])
