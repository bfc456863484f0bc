"""Carry scene weights between the JAX package and the port.

The JAX package keeps a scene as a dict of parameter arrays plus an
``alive`` mask (``GaussianScene.params()`` there); ``np.asarray`` of each
gives the numpy form both functions here speak.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch.structs import PARAM_NAMES, GaussianScene


def scene_from_numpy(params: dict, alive, device) -> GaussianScene:
    """numpy parameter dict (xyz, rgb, opacity, scale, quaternion, sh) and
    (N,) alive mask -> the port's ``GaussianScene`` on ``device``, slot for
    slot."""
    missing = [k for k in PARAM_NAMES if k not in params]
    if missing:
        raise ValueError(f"params missing {missing}")

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return GaussianScene(
        **{k: tensor(params[k], torch.float32) for k in PARAM_NAMES},
        alive=tensor(alive, torch.bool),
    )


def scene_to_numpy(scene: GaussianScene):
    """The inverse: (numpy parameter dict, numpy (N,) bool alive mask)."""
    params = {k: v.detach().cpu().numpy() for k, v in scene.params().items()}
    return params, scene.alive.cpu().numpy()
