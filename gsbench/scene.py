"""The benchmark's inputs, made from ``--seed`` on the device: the scene
(by the configuration's scene maker, ``scenes/<scene_maker>.py``), the
cameras, the perturbation a training run starts from, and the ground truth
the plain reference renders.  The cameras look at the scene's centroid
from the distance its maker gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import spec
from gsbench.reference import splat as ref

SH_REST = 15  # SH coefficients per channel beyond the DC term, bands 1..3


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds derived from the run's seed."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def load(config: dict, alive_count: int, seed: int, device) -> dict:
    """The scene's slots on ``device``, made by ``scenes/<scene_maker>.py``
    from the configuration and the seed: a dict of the parameter tensors
    (capacity rows), ``alive``, and the centroid and framing distance the
    cameras look from."""
    return spec.load_module("scenes", config["scene_maker"]).make(
        config, alive_count, seed, device)


def perturb(params: dict, alive_count: int, traffic: dict, seed: int) -> dict:
    """The scene a training run starts from: a seeded normal offset of the
    DC colour and of the pre-sigmoid opacity of the alive slots."""
    gen = generator(seed, params["xyz"].device)
    out = dict(params)
    n, dev = alive_count, params["xyz"].device
    for leaf, std in (("rgb", traffic["rgb_noise"]), ("opacity", traffic["opacity_noise"])):
        p = params[leaf].clone()
        p[:n] += std * torch.randn(n, p.shape[1], generator=gen, device=dev)
        out[leaf] = p
    return out


def intrinsics(config: dict, device) -> torch.Tensor:
    f, w, h = config["focal"], config["width"], config["height"]
    return torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=torch.float32,
                        device=device)


def pose(centroid, distance: float, azimuth: float, elevation: float) -> torch.Tensor:
    """camera_T_world of a camera at ``distance`` from ``centroid``, turned
    by ``azimuth`` about the y axis and ``elevation`` about the x axis,
    looking at the centroid along its +z."""
    ca, sa = math.cos(azimuth), math.sin(azimuth)
    ce, se = math.cos(elevation), math.sin(elevation)
    ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    rx = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])
    world_R_cam = ry @ rx
    c = centroid.detach().cpu().double().numpy()
    centre = c + world_R_cam @ np.array([0.0, 0.0, -distance])
    T = np.eye(4)
    T[:3, :3] = world_R_cam.T
    T[:3, 3] = -world_R_cam.T @ centre
    return torch.tensor(T, dtype=torch.float32, device=centroid.device)


def ring_poses(scene: dict, n: int) -> list:
    """``n`` cameras on a level ring around the centroid, 360/n degrees apart."""
    return [pose(scene["centroid"], scene["distance"], 2 * math.pi * k / n, 0.0)
            for k in range(n)]


def orbit_poses(scene: dict, count: int, max_elevation_deg: float, seed: int) -> list:
    """``count`` cameras on the orbit sphere: azimuth uniform, elevation
    uniform within +-max_elevation_deg, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * math.pi, count)
    el = np.radians(rng.uniform(-max_elevation_deg, max_elevation_deg, count))
    return [pose(scene["centroid"], scene["distance"], float(a), float(e))
            for a, e in zip(az, el)]


def view(config: dict, K, camera_T_world, background, dtype=torch.float32) -> ref.View:
    """The reference's view of one camera under ``config``."""
    s = config["splat"]
    return ref.View(
        K=K.to(dtype), pose=camera_T_world.to(dtype), width=config["width"],
        height=config["height"], n_sh=(config["n_sh_band"] + 1) ** 2,
        per_pixel=not s["use_sh_precompute"], background=background.to(dtype),
        near=s["near_thresh"], far=s["far_thresh"], padding=float(s["cull_mask_padding"]),
        mh_dist=s["mh_dist"])


def ground_truth(params: dict, alive, views: list) -> list:
    """Each view rendered by the plain reference, clipped, as uint8."""
    out = []
    for v in views:
        img, _, _ = ref.render(params, alive, v)
        out.append((img.clamp(0, 1) * 255).round().to(torch.uint8))
    return out
