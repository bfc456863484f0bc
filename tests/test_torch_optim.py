"""The port's Adam (``optim.update``) and moment surgery (``mask_moments``)
against the JAX package's optax chain, over three updates with per-leaf
learning rates, on seeded float32 gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gaussian_splatting_tpu import optim as jo
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_torch import optim as to
from gaussian_splatting_torch.config import SplatConfig

SHAPES = dict(xyz=(7, 3), quaternion=(7, 4), scale=(7, 3), opacity=(7, 1),
              rgb=(7, 3), sh=(7, 3, 15))
# the same float32 operations in the same order; what differs is XLA's
# pow / sqrt / divide rounding against PyTorch's (measured 0 or 1 ulp)
RTOL, ATOL = 1e-6, 1e-12


def _grads(rng):
    g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-8, 1, size=s)).astype(np.float32)
         for k, s in SHAPES.items()}
    g["sh"][:] = 0.0  # a leaf with no gradient (SH bands not yet active)
    return g


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_adam_matches_optax_over_three_updates():
    cfg = SplatConfig()
    opt = jo.make_optimizer(JConfig())
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jstate = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = to.init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(3):
        g = _grads(rng)
        ju, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tu, tstate = to.update({k: torch.tensor(v) for k, v in g.items()}, tstate, cfg)
        for k in SHAPES:
            _close(tu[k], ju[k])
            _close(tstate.mu[k], jstate[0].mu[k])
            _close(tstate.nu[k], jstate[0].nu[k])
        assert int(tstate.count) == int(jstate[0].count)
    assert int(tstate.count) == 3
    # the per-leaf multipliers reach the update: a leaf's step is bounded by
    # base_lr * multiplier * |mu_hat| / (sqrt(nu_hat) + eps) <~ lr * mult
    mult = to.lr_multipliers(cfg)
    assert mult == jo.lr_multipliers(JConfig())
    for k in ("xyz", "opacity"):
        assert float(tu[k].abs().max()) <= 1.01 * cfg.base_lr * mult[k] * 3


def test_mask_moments_matches_jax():
    rng = np.random.default_rng(1)
    mu = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    nu = {k: rng.uniform(size=s).astype(np.float32) for k, s in SHAPES.items()}
    mask = rng.uniform(size=7) < 0.4
    opt = jo.make_optimizer(JConfig())
    jstate = opt.init({k: jnp.asarray(v) for k, v in mu.items()})
    jstate = jo.replace_adam_moments(
        jstate, mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()})
    tstate = to.AdamState(count=torch.tensor(5, dtype=torch.int32),
                          mu={k: torch.tensor(v) for k, v in mu.items()},
                          nu={k: torch.tensor(v) for k, v in nu.items()})
    for leaves in (None, ("opacity",), ("sh", "xyz")):
        j = jo.mask_moments(jstate, jnp.asarray(mask), leaves=leaves)[0]
        t = to.mask_moments(tstate, torch.tensor(mask), leaves=leaves)
        for k in SHAPES:
            np.testing.assert_array_equal(t.mu[k].numpy(), np.asarray(j.mu[k]))
            np.testing.assert_array_equal(t.nu[k].numpy(), np.asarray(j.nu[k]))
        assert int(t.count) == 5
    # the original state is left as it was
    np.testing.assert_array_equal(tstate.mu["xyz"].numpy(), mu["xyz"])
