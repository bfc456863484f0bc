"""Adam with per-leaf learning-rate multipliers (counterpart of
``gaussian_splatting_tpu/optim.py``).

The JAX package runs ``optax.chain(scale_by_adam(0.9, 0.999, 1e-8),
scale_by_leaf, scale(-base_lr))``.  This is the same update written out:
one step ``count`` shared by every leaf, bias correction, eps added after
the square root, then the leaf's multiplier and -base_lr.  The state is a
plain ``AdamState`` of per-leaf tensors, so densification can edit the
moments slot by slot (``mask_moments``); ``torch.optim.Adam`` keeps a step
count per parameter and a state layout that does not allow that.

A training step's Adam, skipped where its ``ok`` flag is false, is
``adam_step_plain`` (``update`` and three selects) or, on a CUDA state,
``adam_step_cuda``, which launches the hand-written kernel
``csrc/adam.cu`` once over all the leaves.  The two agree bit for bit;
there is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_torch import _build, telemetry

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


def bias_corrections(count: torch.Tensor):
    """(count + 1, and the bias corrections 1 - B1**(count + 1) and
    1 - B2**(count + 1)), 0-d tensors on the count's device.  The
    corrections are formed in float64 and used in float32, as optax forms
    them under JAX's x64 mode (the JAX test suite's); in float32
    throughout, 1 - 0.999 would be off by 1.3e-5 relative."""
    count = count + 1
    step = count.to(torch.float64)
    bc1 = (1.0 - torch.pow(B1, step)).to(torch.float32)
    bc2 = (1.0 - torch.pow(B2, step)).to(torch.float32)
    return count, bc1, bc2


def leaf_rates(config, rates: Optional[dict] = None):
    """(multiplier by leaf name, base rate): ``config``'s multipliers of
    ``config.base_lr``, or, where ``rates`` is given, each leaf's own
    learning rate over a base of 1 (``config`` is then not read)."""
    if rates is None:
        return lr_multipliers(config), config.base_lr
    return rates, 1.0


def update(grads: dict, state: AdamState, config, rates: Optional[dict] = None):
    """One Adam step: (updates to add to the params, new state).  Nothing
    is written in place.  The rates are ``leaf_rates(config, rates)``."""
    count, bc1, bc2 = bias_corrections(state.count)
    mult, base_lr = leaf_rates(config, rates)
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - B1) * g + B1 * state.mu[k]
        nu[k] = (1 - B2) * (g * g) + B2 * state.nu[k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        updates[k] = (u * mult[k]) * -base_lr
    return updates, AdamState(count=count, mu=mu, nu=nu)


def adam_step_plain(params: dict, grads: dict, state: AdamState, ok, config,
                    rates: Optional[dict] = None):
    """A training step's Adam where ``ok`` (a 0-d bool) holds, and params
    and state unchanged where it does not: (new params, new state).  The
    plain PyTorch version of ``adam_step_cuda``; nothing is written in
    place."""
    updates, new = update(grads, state, config, rates)
    return (
        {k: torch.where(ok, params[k] + updates[k], params[k]) for k in params},
        AdamState(
            count=torch.where(ok, new.count, state.count),
            mu={k: torch.where(ok, new.mu[k], state.mu[k]) for k in params},
            nu={k: torch.where(ok, new.nu[k], state.nu[k]) for k in params},
        ),
    )


# csrc/adam.cu's shape: floats a block takes (kChunk), leaves a launch
# takes (kMaxLeaves), and the flags of a leaf in its table (kVec: p, mu, nu
# and the outputs 16-byte aligned; kGVec: the gradient too, and contiguous)
ADAM_CHUNK = 2048
ADAM_MAX_LEAVES = 8
ADAM_VEC, ADAM_G_VEC = 1, 2


class AdamLeaf(NamedTuple):
    """One leaf as the kernel sees it: its shape (slots first), its
    gradient's strides in floats, the seven data pointers (p, g, mu, nu,
    p_out, mu_out, nu_out) and its learning-rate multiplier."""

    shape: tuple
    g_strides: tuple
    ptrs: tuple
    mult: float


def adam_table(leaves):
    """The kernel's leaf table from ``AdamLeaf``s: (ptrs (L, 7) int64, dims
    (L, 8) int64, mult (L,) float32, number of chunks).  A leaf of no float
    is left out.  dims holds each leaf's floats n, its first chunk (leaf
    after leaf, ceil(n / ADAM_CHUNK) chunks each), its gradient's strides
    over (slots, a, b), a, b and its flags.  A pure function of its
    arguments: the pointers are only tested for 16-byte alignment."""
    ptrs, dims, mult = [], [], []
    first = 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape, dtype=np.int64))
        if n == 0:
            continue
        pad = 3 - len(leaf.shape)  # as (slots, a, b)
        slots, a, b = tuple(leaf.shape) + (1,) * pad
        gs = tuple(leaf.g_strides) + (0,) * pad
        g_contiguous = all(s == want for s, want, size in zip(gs, (a * b, b, 1), (slots, a, b))
                           if size > 1)
        vec = all(p % 16 == 0 for i, p in enumerate(leaf.ptrs) if i != 1)
        flags = (ADAM_VEC if vec else 0) | (
            ADAM_G_VEC if vec and g_contiguous and leaf.ptrs[1] % 16 == 0 else 0)
        ptrs.append(leaf.ptrs)
        dims.append((n, first, *gs, a, b, flags))
        mult.append(leaf.mult)
        first += -(-n // ADAM_CHUNK)
    return (np.array(ptrs, dtype=np.int64).reshape(-1, 7),
            np.array(dims, dtype=np.int64).reshape(-1, 8),
            np.array(mult, dtype=np.float32), first)


def check_adam_args(params: dict, grads: dict, state: AdamState, ok) -> None:
    """What ``adam_step_cuda`` takes, on any device: float32 leaves of 1 to
    3 dims and under 2**31 floats, no more than ADAM_MAX_LEAVES of them,
    with the same names and shape in params, grads and both moments, all on
    one device; params and moments contiguous (a gradient may be any
    strided view, as autograd returns slices and transposes); a 0-d int32
    count and a 0-d bool ``ok``.  Raises ValueError."""
    names = list(params)
    if len(names) > ADAM_MAX_LEAVES:
        raise ValueError(f"adam_step: at most {ADAM_MAX_LEAVES} leaves, got {len(names)}")
    for what, d in (("grads", grads), ("mu", state.mu), ("nu", state.nu)):
        if set(d) != set(names):
            raise ValueError(f"adam_step: {what} has leaves {sorted(d)}, params {sorted(names)}")
    dev = state.count.device
    if state.count.shape != () or state.count.dtype != torch.int32:
        raise ValueError("adam_step: count must be a 0-d int32 tensor")
    if not torch.is_tensor(ok) or ok.shape != () or ok.dtype != torch.bool:
        raise ValueError("adam_step: ok must be a 0-d bool tensor")
    for k in names:
        leaf = dict(params=params[k], grads=grads[k], mu=state.mu[k], nu=state.nu[k])
        for what, t in leaf.items():
            if t.dtype != torch.float32:
                raise ValueError(f"adam_step: {what}['{k}'] must be float32, got {t.dtype}")
            if t.shape != params[k].shape:
                raise ValueError(f"adam_step: {what}['{k}'] has shape {tuple(t.shape)}, "
                                 f"params {tuple(params[k].shape)}")
            if t.device != dev:
                raise ValueError(f"adam_step: {what}['{k}'] on {t.device}, count on {dev}")
            if what != "grads" and not t.is_contiguous():
                raise ValueError(f"adam_step: {what}['{k}'] must be contiguous")
        if not 1 <= params[k].dim() <= 3 or params[k].numel() >= 2**31:
            raise ValueError(f"adam_step: leaf '{k}' must have 1 to 3 dims and under "
                             f"2**31 floats, got {tuple(params[k].shape)}")
        if any(s < 0 for s in grads[k].stride()):
            raise ValueError(f"adam_step: grads['{k}'] has a negative stride")
    if ok.device != dev:
        raise ValueError(f"adam_step: ok on {ok.device}, count on {dev}")


def adam_step_cuda(params: dict, grads: dict, state: AdamState, ok, config,
                   rates: Optional[dict] = None):
    """``adam_step_plain`` in one launch of ``csrc/adam.cu`` on the current
    stream: (new params, new state), new tensors, bit for bit the plain
    version's.  Reads ``ok`` and the bias corrections on the device; no
    host read."""
    if not state.count.is_cuda:
        raise ValueError(f"adam_step_cuda: the kernel needs CUDA tensors, got "
                         f"{state.count.device}")
    check_adam_args(params, grads, state, ok)
    _, bc1, bc2 = bias_corrections(state.count)
    mult, base_lr = leaf_rates(config, rates)
    out = {k: [torch.empty(v.shape, dtype=torch.float32, device=v.device) for _ in range(3)]
           for k, v in params.items()}
    count = torch.empty_like(state.count)
    ptrs, dims, mults, n_chunks = adam_table([
        AdamLeaf(tuple(p.shape), grads[k].stride(),
                 (p.data_ptr(), grads[k].data_ptr(), state.mu[k].data_ptr(),
                  state.nu[k].data_ptr(), *(t.data_ptr() for t in out[k])), mult[k])
        for k, p in params.items()])
    hyper = np.array([1 - B1, B1, 1 - B2, B2, EPS, -base_lr], dtype=np.float32)
    err = _build.library().gs_adam_step(
        ptrs.ctypes.data, dims.ctypes.data, mults.ctypes.data, len(mults), n_chunks,
        hyper.ctypes.data, bc1.data_ptr(), bc2.data_ptr(), ok.data_ptr(),
        state.count.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(state.count.device).cuda_stream)
    _build.check(err, "gs_adam_step")
    telemetry.LAUNCHES["adam_step"] += 1
    return ({k: o[0] for k, o in out.items()},
            AdamState(count=count, mu={k: o[1] for k, o in out.items()},
                      nu={k: o[2] for k, o in out.items()}))


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
