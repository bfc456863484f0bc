"""Carry scene weights and training state between the JAX package and the
port.

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


def train_state_from_numpy(state, device):
    """A training state in numpy form -> the port's ``trainer.TrainState``
    on ``device``.

    ``state`` has the JAX ``TrainState``'s fields with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, jax_state)``, or the output of
    ``train_state_to_numpy``): params, alive, opt_state (whose first entry
    holds the Adam count, mu and nu; optax's chain adds empty states after
    it), uv_grad_accum, xyz_grad_accum, grad_accum_count.
    """
    from gaussian_splatting_torch import optim, trainer

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    adam = state.opt_state[0]
    return trainer.TrainState(
        params={k: t(v, torch.float32) for k, v in state.params.items()},
        alive=t(state.alive, torch.bool),
        opt_state=optim.AdamState(
            count=t(adam.count, torch.int32),
            mu={k: t(v, torch.float32) for k, v in adam.mu.items()},
            nu={k: t(v, torch.float32) for k, v in adam.nu.items()},
        ),
        uv_grad_accum=t(state.uv_grad_accum, torch.float32),
        xyz_grad_accum=t(state.xyz_grad_accum, torch.float32),
        grad_accum_count=t(state.grad_accum_count, torch.int32),
    )


def train_state_to_numpy(state):
    """The port's ``TrainState`` with every leaf as a numpy array, in the
    JAX ``TrainState``'s layout (``opt_state`` is a 1-tuple holding the
    Adam count, mu and nu)."""
    def n(x):
        if isinstance(x, dict):
            return {k: n(v) for k, v in x.items()}
        return x.detach().cpu().numpy()

    adam = state.opt_state
    return state._replace(
        params=n(state.params), alive=n(state.alive),
        opt_state=(adam._replace(count=n(adam.count), mu=n(adam.mu), nu=n(adam.nu)),),
        uv_grad_accum=n(state.uv_grad_accum),
        xyz_grad_accum=n(state.xyz_grad_accum),
        grad_accum_count=n(state.grad_accum_count),
    )
