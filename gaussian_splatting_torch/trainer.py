"""One training step and the test-view evaluation (counterpart of
``gaussian_splatting_tpu/trainer.py``'s ``train_step`` and ``eval_step``).

A step is render -> L1 + SSIM loss -> backward -> Adam with per-leaf
learning rates -> densification accumulators.  ``config.use_sh_precompute``
picks the colour path: True (the default) renders through kernels B1/B2
with SH evaluated once per gaussian, False through the per-pixel SH kernels
B3/B4 (at SH band 1 or more).  The state is a ``TrainState`` of plain
tensors, and ``train_step`` returns a new one; it writes nothing in place.
uv-space gradients come from a zero ``uv_offset`` argument of
``rasterize``, as in the JAX package.  ``sh_band_for_iteration`` gives the
band a step of the schedule renders at.

Not ported here: ``train_steps_scan`` (the JAX package's multi-step
dispatch for the TPU), and opacity reset and adaptive density control,
which are the next slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from gaussian_splatting_torch import optim
from gaussian_splatting_torch.config import SplatConfig
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


def sh_band_for_iteration(config: SplatConfig, iteration: int) -> int:
    """The active SH band at an iteration: a band is added every
    ``add_sh_band_interval`` iterations, up to ``max_sh_band``."""
    if config.max_sh_band == 0:
        return 0
    return min(iteration // config.add_sh_band_interval, config.max_sh_band)
