"""One training step, the test-view evaluation and the training schedule's
two events, opacity reset and adaptive density control (counterpart of
``gaussian_splatting_tpu/trainer.py``'s ``train_step``, ``eval_step``,
``reset_opacity`` and ``adaptive_density_control``).

A step is render -> L1 + SSIM loss -> backward -> Adam with per-leaf
learning rates -> densification accumulators.  ``config.use_sh_precompute``
picks the colour path: True (the default) renders through kernels B1/B2
with SH evaluated once per gaussian, False through the per-pixel SH kernels
B3/B4 (at SH band 1 or more).  The state is a ``TrainState`` of plain
tensors, and ``train_step`` returns a new one; it writes nothing in place.
uv-space gradients come from a zero ``uv_offset`` argument of
``rasterize``, as in the JAX package.  ``sh_band_for_iteration`` gives the
band a step of the schedule renders at.

The events keep the fixed-capacity slot layout: delete clears ``alive``,
clone and split write into free slots and zero the Adam moments there, so
a state agrees with the JAX package's slot by slot.  Each is one
vectorised pass on the device, with no host read: the k-th candidate in
slot order takes the k-th free slot, which is the pairing the JAX
package's batched drains (``lax.while_loop`` over batches of ``max_new``)
produce.

Not ported here: ``train_steps_scan`` (the JAX package's multi-step
dispatch for the TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from gaussian_splatting_torch import optim
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.geometry import inverse_sigmoid, quaternion_to_rotation
from gaussian_splatting_torch.losses import eval_psnr_ssim, train_loss
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera, GaussianScene


class TrainState(NamedTuple):
    params: dict  # parameter tensors by name, as GaussianScene.params()
    alive: torch.Tensor  # (C,) bool
    opt_state: optim.AdamState
    uv_grad_accum: torch.Tensor  # (C, 2)
    xyz_grad_accum: torch.Tensor  # (C, 3)
    grad_accum_count: torch.Tensor  # (C,) int32


def init_train_state(scene: GaussianScene, config: SplatConfig) -> TrainState:
    """A fresh state: the scene's parameters, zero Adam moments and zero
    accumulators."""
    del config  # the optimizer's hyper-parameters are read at each step
    params = {k: v.detach().clone() for k, v in scene.params().items()}
    cap, dev = scene.capacity, scene.xyz.device
    return TrainState(
        params=params,
        alive=scene.alive.clone(),
        opt_state=optim.init(params),
        uv_grad_accum=torch.zeros(cap, 2, dtype=torch.float32, device=dev),
        xyz_grad_accum=torch.zeros(cap, 3, dtype=torch.float32, device=dev),
        grad_accum_count=torch.zeros(cap, dtype=torch.int32, device=dev),
    )


def _float_image(gt_image: torch.Tensor, config: SplatConfig) -> torch.Tensor:
    """A uint8 ground truth is normalised by saturated_pixel_value."""
    if gt_image.dtype == torch.uint8:
        return gt_image.to(torch.float32) * (1.0 / config.saturated_pixel_value)
    return gt_image


def _render(params, state, camera_K, camera_T_world, config, camera_hw,
            n_sh_band, background_rgb, uv_offset=None):
    h, w = camera_hw
    return rasterize(
        params, state.alive, camera_T_world, Camera(K=camera_K, width=w, height=h),
        near_thresh=config.near_thresh, far_thresh=config.far_thresh,
        cull_mask_padding=config.cull_mask_padding, mh_dist=config.mh_dist,
        background_rgb=background_rgb, n_sh_band=n_sh_band,
        use_sh_precompute=config.use_sh_precompute, uv_offset=uv_offset,
    )


def train_step(
    state: TrainState,
    gt_image: torch.Tensor,  # (H, W, 3) float32 in [0, 1], or uint8
    camera_K: torch.Tensor,
    camera_T_world: torch.Tensor,
    background_rgb: torch.Tensor,
    *,
    config: SplatConfig,
    camera_hw: tuple,
    n_sh_band: int,
):
    """One optimisation step on one camera.  Returns (new state, info).

    A step whose loss or any parameter gradient is not finite is skipped:
    params, Adam state and accumulators come back unchanged.  The choice
    is a select on the device, so the step never waits on the host for it.
    The port has no splat capacities, so unlike the JAX package no step is
    skipped for a capacity overflow.

    info holds loss, psnr (0-d tensors), num_splats, num_visible,
    truncated (ints) and n_alive (0-d tensor).
    """
    gt = _float_image(gt_image, config)
    names = list(state.params)
    params = {k: state.params[k].detach().requires_grad_(True) for k in names}
    uv_zero = torch.zeros(2, state.alive.shape[0], dtype=torch.float32,
                          device=state.alive.device, requires_grad=True)
    with record_function("gs::render"):
        res = _render(params, state, camera_K, camera_T_world, config,
                      camera_hw, n_sh_band, background_rgb, uv_offset=uv_zero)
    with record_function("gs::loss"):
        loss, psnr = train_loss(res.image, gt, config.ssim_frac)
    with record_function("gs::backward"):
        grads = torch.autograd.grad(
            loss, [params[k] for k in names] + [uv_zero], allow_unused=True)
    g_uv = grads[-1]  # uv_offset reaches every gaussian's features
    # a leaf the render does not read (sh at band 0) has zero gradient
    gparams = {k: g if g is not None else torch.zeros_like(params[k])
               for k, g in zip(names, grads[:-1])}

    with record_function("gs::adam"):  # with the step skip and accumulators
        return _apply(state, gparams, g_uv, loss, psnr, res, camera_K, config)


def _apply(state, gparams, g_uv, loss, psnr, res, camera_K, config):
    """Adam, the skip of a non-finite step and the accumulators."""
    names = list(state.params)
    updates, opt_new = optim.update(gparams, state.opt_state, config)
    ok = torch.isfinite(loss.detach())
    for g in gparams.values():
        ok = ok & torch.isfinite(g.sum())
    new_params = {k: torch.where(ok, state.params[k] + updates[k], state.params[k])
                  for k in names}
    old = state.opt_state
    opt_state = optim.AdamState(
        count=torch.where(ok, opt_new.count, old.count),
        mu={k: torch.where(ok, opt_new.mu[k], old.mu[k]) for k in names},
        nu={k: torch.where(ok, opt_new.nu[k], old.nu[k]) for k in names},
    )

    # densification statistics: uv gradients scaled to world-consistent
    # units by fx, fy and abs-accumulated over the views that see a gaussian
    fxfy = torch.stack([camera_K[0, 0], camera_K[1, 1]])
    uv_grad = (g_uv.abs() * fxfy[:, None] * res.visible[None, :]).T
    zero = torch.zeros((), dtype=torch.float32, device=uv_grad.device)
    new_state = TrainState(
        params=new_params,
        alive=state.alive,
        opt_state=opt_state,
        uv_grad_accum=state.uv_grad_accum + torch.where(ok, uv_grad, zero),
        xyz_grad_accum=state.xyz_grad_accum
        + torch.where(ok, gparams["xyz"].abs(), zero),
        grad_accum_count=state.grad_accum_count
        + res.visible.to(torch.int32) * ok.to(torch.int32),
    )
    info = dict(
        loss=loss.detach(), psnr=psnr.detach(), num_splats=res.num_splats,
        num_visible=res.num_visible, truncated=res.truncated,
        n_alive=state.alive.sum(),
    )
    return new_state, info


@torch.no_grad()
def eval_step(
    state: TrainState,
    gt_image: torch.Tensor,
    camera_K: torch.Tensor,
    camera_T_world: torch.Tensor,
    *,
    config: SplatConfig,
    camera_hw: tuple,
    n_sh_band: int,
):
    """Render one test view on a black background and score it: (image,
    psnr, ssim).  The port has no capacities, so there is no overflow flag
    to return."""
    gt = _float_image(gt_image, config)
    bg = torch.zeros(3, dtype=torch.float32, device=gt.device)
    res = _render(state.params, state, camera_K, camera_T_world, config,
                  camera_hw, n_sh_band, bg)
    psnr, ssim_val = eval_psnr_ssim(res.image, gt)
    return res.image, psnr, ssim_val


# ---------------------------------------------------------------------------
# scheduled events: opacity reset, adaptive density control
# ---------------------------------------------------------------------------


def _zero_accumulators(state: TrainState) -> dict:
    return dict(
        uv_grad_accum=torch.zeros_like(state.uv_grad_accum),
        xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
        grad_accum_count=torch.zeros_like(state.grad_accum_count),
    )


@torch.no_grad()
def reset_opacity(state: TrainState, *, config: SplatConfig) -> TrainState:
    """Opacity <- inverse_sigmoid(reset_opacity_value) in every slot, dead
    ones included; zero the opacity leaf's Adam moments (the count is kept)
    and the three densification accumulators.  Returns a new state."""
    cap = state.alive.shape[0]
    params = dict(state.params)
    params["opacity"] = torch.full(
        (cap, 1), inverse_sigmoid(config.reset_opacity_value), dtype=torch.float32,
        device=state.alive.device)
    opt_state = optim.mask_moments(
        state.opt_state, torch.ones_like(state.alive), leaves=("opacity",))
    return state._replace(params=params, opt_state=opt_state, **_zero_accumulators(state))


def _row_norm(x):
    """Euclidean norm of each row: the square root of the sum of squares."""
    return torch.sqrt((x * x).sum(dim=1))


def _nanquantile(x, q):
    """``jnp.nanquantile(x, q)`` of a 1-D float32 x (NaN = missing) at a 0-d
    float32 q: its linear interpolation in its operations' order, NaN when
    nothing is left.  On the device, with no host read; unlike
    ``torch.quantile`` it takes an empty set and more than 2**24 values."""
    a = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(a)).sum(dtype=torch.float32)
    pos = q * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    zero = torch.zeros_like(pos)

    def value(i):
        i = torch.maximum(zero, torch.minimum(i, counts - 1))
        return a.index_select(0, i.long().reshape(1)).reshape(())

    return value(low) * low_weight + value(high) * high_weight


def _scale_factor(config: SplatConfig, iteration, device):
    """The adaptive fraction's factor (end - iteration) / (end - start) * 2,
    in float32; 1 without adaptive fractional densification."""
    if not config.use_adaptive_fractional_densification:
        return torch.ones((), dtype=torch.float32, device=device)
    it = torch.tensor(float(iteration), dtype=torch.float32, device=device)
    return ((config.adaptive_control_end - it)
            / (config.adaptive_control_end - config.adaptive_control_start) * 2.0)


def _pair_free_slots(src, free):
    """Pair the k-th slot of ``src`` with the k-th slot of ``free``, both in
    ascending slot order, for k < min(#src, #free).  Returns (written: the
    free slots that receive a copy, from: the slot each written slot copies,
    taken: the sources that found a free slot), each (C,)."""
    cap = src.shape[0]
    src_slots = torch.argsort((~src).to(torch.uint8), stable=True)  # sources first
    free_slots = torch.argsort((~free).to(torch.uint8), stable=True)
    k = torch.arange(cap, device=src.device)
    ok = (k < src.sum()) & (k < free.sum())
    # free_slots is a permutation of the slots, so every slot gets one entry
    written = torch.zeros_like(free).scatter(0, free_slots, ok)
    from_slot = torch.empty_like(k).scatter(0, free_slots, src_slots)
    taken = torch.zeros_like(src).scatter(0, src_slots, ok)
    return written, from_slot, taken


def _copy_slots(params, written, from_slot, overrides):
    """Every leaf with slot ``from_slot[i]``'s row copied into each written
    slot i; ``overrides`` maps a leaf to (C, ...) rows taken in its place,
    also read at ``from_slot``."""
    out = {}
    for k, v in params.items():
        m = written.reshape((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, overrides.get(k, v)[from_slot], v)
    return out


@torch.no_grad()
def adaptive_density_control(state: TrainState, generator: torch.Generator,
                             iteration, *, config: SplatConfig):
    """Delete, clone and split on the fixed-capacity slots: (new state,
    stats), stats a dict of 0-d tensors n_deleted, n_clone, n_split,
    n_alive, uv_split_val, skip_densify, cap_hit, clone_deferred,
    split_deferred, as the JAX package reports them.

    In order:
    - delete: keep a gaussian whose pre-sigmoid opacity exceeds
      inverse_sigmoid(delete_opacity_threshold) and that was seen (count >
      0) with a nonzero uv gradient; the second test is dropped when no
      slot was seen since the last event (every step skipped).  n_deleted
      is counted even with use_delete off; freed slots get zero moments.
    - signals: accumulators over max(count, 1); with fractional
      densification the uv threshold is the quantile, over the slots alive
      after the delete, at 1 - (1 - uv_grad_percentile) * factor.
      skip_densify (n_alive > max_gaussians) densifies nothing.
    - clone (small gaussians): the k-th candidate in slot order goes to the
      k-th free slot, moved by -0.01 times its mean xyz gradient, with zero
      moments; the copy inherits the densify flag and largest scale.
      clone_deferred counts the candidates left when the free slots ran
      out.
    - split (large gaussians, and those above the scale quantile over the
      slots alive after the clone): two samples xyz + R(q / |q|) (r *
      exp(scale)), r ~ U[0, 1)^3, drawn in the original ellipsoid; sample 1
      overwrites the source, sample 2 goes to the k-th free slot left after
      the clone; both take scale log(exp(scale) / split_scale_factor) and
      zero moments.  split_deferred counts sources whose second sample
      found no slot.  The uniforms come from ``generator`` (on the state's
      device): one (C, 3) draw for every sample 1, then one for every
      sample 2, row s for the source in slot s.
    - the accumulators are zeroed; the Adam count is kept.

    ``iteration`` is the training iteration (an int).  The stats stay on
    the device; the caller reads them once.
    """
    cap = state.alive.shape[0]
    dev = state.alive.device
    params, alive, adam = dict(state.params), state.alive, state.opt_state
    count = state.grad_accum_count
    i32 = torch.int32

    # delete
    keep = params["opacity"][:, 0] > inverse_sigmoid(config.delete_opacity_threshold)
    had_signal = (count > 0).any()
    keep = keep & (((count > 0) & (_row_norm(state.uv_grad_accum) > 0.0)) | ~had_signal)
    freed = alive & ~keep
    n_deleted = freed.sum(dtype=i32)
    if config.use_delete:
        alive = alive & keep
        adam = optim.mask_moments(adam, freed)
    skip_densify = alive.sum(dtype=i32) > config.max_gaussians

    # densification signals
    cnt = count.clamp_min(1).to(torch.float32)[:, None]
    uv_avg_norm = _row_norm(state.uv_grad_accum / cnt)
    xyz_grad_avg = state.xyz_grad_accum / cnt
    factor = _scale_factor(config, iteration, dev)
    nan = torch.full_like(uv_avg_norm, float("nan"))
    if config.use_fractional_densification:
        uv_pct = 1.0 - (1.0 - config.uv_grad_percentile) * factor
        uv_split_val = _nanquantile(torch.where(alive, uv_avg_norm, nan),
                                    uv_pct.clamp(0.0, 1.0))
    else:
        uv_split_val = torch.tensor(config.uv_grad_threshold, dtype=torch.float32,
                                    device=dev)
    densify = alive & (uv_avg_norm > uv_split_val) & ~skip_densify
    scale_max = torch.exp(params["scale"]).amax(dim=1)
    clone_mask = densify & (scale_max <= config.clone_scale_threshold)
    n_clone = clone_mask.sum(dtype=i32)

    # clone
    clone_deferred = torch.zeros((), dtype=i32, device=dev)
    if config.use_clone:
        written, from_slot, taken = _pair_free_slots(clone_mask, ~alive)
        params = _copy_slots(params, written, from_slot,
                             dict(xyz=params["xyz"] - xyz_grad_avg * 0.01))
        alive = alive | written
        adam = optim.mask_moments(adam, written)
        densify = torch.where(written, densify[from_slot], densify)
        scale_max = torch.where(written, scale_max[from_slot], scale_max)
        clone_deferred = (clone_mask & ~taken).sum(dtype=i32)

    # split
    scale_pct = 1.0 - (1.0 - config.scale_norm_percentile) * factor
    scale_split = _nanquantile(torch.where(alive, scale_max, nan), scale_pct.clamp(0.0, 1.0))
    split_mask = densify & (scale_max > config.clone_scale_threshold)
    split_mask = (split_mask | (alive & (scale_max > scale_split) & ~skip_densify)) & alive
    n_split = split_mask.sum(dtype=i32)

    split_deferred = torch.zeros((), dtype=i32, device=dev)
    if config.use_split:
        if config.num_split_samples != 2:
            raise ValueError("the fixed-capacity split draws 2 samples, got "
                             f"num_split_samples={config.num_split_samples}")
        xyz, scale, quat = params["xyz"], params["scale"], params["quaternion"]
        r1 = torch.rand(cap, 3, generator=generator, device=dev)
        r2 = torch.rand(cap, 3, generator=generator, device=dev)
        scales = torch.exp(scale)
        rot = quaternion_to_rotation(quat / _row_norm(quat)[:, None])
        # both samples in the original ellipsoid, before any write
        sample1 = xyz + torch.einsum("nij,nj->ni", rot, r1 * scales)
        sample2 = xyz + torch.einsum("nij,nj->ni", rot, r2 * scales)
        new_scale = torch.log(scales / config.split_scale_factor)
        in_place = split_mask[:, None]
        params = {**params, "xyz": torch.where(in_place, sample1, xyz),
                  "scale": torch.where(in_place, new_scale, scale)}
        written, from_slot, taken = _pair_free_slots(split_mask, ~alive)
        params = _copy_slots(params, written, from_slot,
                             dict(xyz=sample2, scale=new_scale))
        alive = alive | written
        adam = optim.mask_moments(adam, split_mask | written)
        split_deferred = (split_mask & ~taken).sum(dtype=i32)

    new_state = state._replace(params=params, alive=alive, opt_state=adam,
                               **_zero_accumulators(state))
    stats = dict(
        n_deleted=n_deleted,
        n_clone=n_clone,
        n_split=n_split,
        n_alive=alive.sum(dtype=i32),
        uv_split_val=uv_split_val,
        skip_densify=skip_densify,
        cap_hit=(clone_deferred > 0) | (split_deferred > 0),
        clone_deferred=clone_deferred,
        split_deferred=split_deferred,
    )
    return new_state, stats


def sh_band_for_iteration(config: SplatConfig, iteration: int) -> int:
    """The active SH band at an iteration: a band is added every
    ``add_sh_band_interval`` iterations, up to ``max_sh_band``."""
    if config.max_sh_band == 0:
        return 0
    return min(iteration // config.add_sh_band_interval, config.max_sh_band)
