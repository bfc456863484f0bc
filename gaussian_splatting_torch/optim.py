"""Adam with per-leaf learning-rate multipliers (counterpart of
``gaussian_splatting_tpu/optim.py``).

The JAX package runs ``optax.chain(scale_by_adam(0.9, 0.999, 1e-8),
scale_by_leaf, scale(-base_lr))``.  This is the same update written out:
one step ``count`` shared by every leaf, bias correction, eps added after
the square root, then the leaf's multiplier and -base_lr.  The state is a
plain ``AdamState`` of per-leaf tensors, so densification can edit the
moments slot by slot (``mask_moments``); ``torch.optim.Adam`` keeps a step
count per parameter and a state layout that does not allow that.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, steps taken
    mu: dict  # first moments by leaf name
    nu: dict  # second moments by leaf name


def lr_multipliers(config) -> dict:
    """Per-leaf multipliers of ``config.base_lr``."""
    return dict(
        xyz=config.xyz_lr_multiplier,
        quaternion=config.quat_lr_multiplier,
        scale=config.scale_lr_multiplier,
        opacity=config.opacity_lr_multiplier,
        rgb=config.rgb_lr_multiplier,
        sh=config.sh_lr_multiplier,
    )


def init(params: dict) -> AdamState:
    """Zero moments and count for a dict of parameter tensors."""
    dev = next(iter(params.values())).device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def update(grads: dict, state: AdamState, config):
    """One Adam step: (updates to add to the params, new state).  Nothing
    is written in place."""
    count = state.count + 1
    # bias corrections 1 - b**count formed in float64 and used in float32,
    # as optax forms them under JAX's x64 mode (the JAX test suite's); in
    # float32 throughout, 1 - 0.999 would be off by 1.3e-5 relative
    step = count.to(torch.float64)
    bc1 = (1.0 - torch.pow(B1, step)).to(torch.float32)
    bc2 = (1.0 - torch.pow(B2, step)).to(torch.float32)
    mult = lr_multipliers(config)
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - B1) * g + B1 * state.mu[k]
        nu[k] = (1 - B2) * (g * g) + B2 * state.nu[k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        updates[k] = (u * mult[k]) * -config.base_lr
    return updates, AdamState(count=count, mu=mu, nu=nu)


def adam_moments(state: AdamState):
    """(mu, nu): the first and second moments by leaf name.  The JAX
    package's accessor digs them out of its optax chain's state; here they
    are fields of ``AdamState``."""
    return state.mu, state.nu


def replace_adam_moments(state: AdamState, mu: Optional[dict] = None,
                         nu: Optional[dict] = None) -> AdamState:
    """``state`` with the moments given replaced (None keeps them); the
    count is kept."""
    return state._replace(mu=state.mu if mu is None else mu,
                          nu=state.nu if nu is None else nu)


def mask_moments(state: AdamState, slot_mask: torch.Tensor,
                 leaves: Optional[tuple] = None) -> AdamState:
    """Zero first and second moments at slots where ``slot_mask`` (C,) is
    True, on the named leaves (all when None).  The count is kept."""

    def zero(moments):
        out = dict(moments)
        for k, v in moments.items():
            if leaves is not None and k not in leaves:
                continue
            m = slot_mask.reshape((-1,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, torch.zeros_like(v), v)
        return out

    return state._replace(mu=zero(state.mu), nu=zero(state.nu))
