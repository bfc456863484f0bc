"""Gaussian-sharded (model-parallel) rendering and training (counterpart
of ``gaussian_splatting_tpu/parallel/gsharded.py``).

The scene is sharded over the ranks of the model group: each of the mp
ranks owns capacity / mp consecutive slots, with their parameters, alive
mask, Adam moments and densification accumulators (``shard_state``).  Per
render, on every rank:

1. per-shard geometry: camera rows, visibility and the feature rows of its
   own slots, O(N / mp);
2. one gather over the model group of the (n_feat + 2, n_loc) bundle of
   feature rows, camera depth and visibility; its backward is the
   reduce-scatter that sums every band's feature gradients onto the
   owning shard (``comm.AllGather``);
3. the layout and the rasterizer kernels of the rank's own horizontal band
   of tile rows: ``TileGrid(band_rows * 16, W)`` with ``v`` shifted to the
   band's origin, so the kernels render a band grid exactly as they render
   a full one;
4. a gather of the bands into the full image (its backward a
   reduce-scatter of the image's cotangent).

Every rank then holds the whole image and computes the same full-image
loss; the step differentiates loss / mp because the band gather's
backward sums the mp identical cotangents.  Adam, the step skip and the
accumulators run on the local shard.  The skip is decided over every rank.
With dp > 1 the model groups of the data replicas render different cameras
and the gradients are averaged over the data group as in ``mesh.py``.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch import trainer as T
from gaussian_splatting_torch.culling import feature_layout
from gaussian_splatting_torch.losses import eval_psnr_ssim, train_loss
from gaussian_splatting_torch.ops.geometry import splat_rows
from gaussian_splatting_torch.ops.render_sh import build_pixel_basis
from gaussian_splatting_torch.parallel import comm
from gaussian_splatting_torch.parallel.mesh import reduce_counts, reduce_over_data
from gaussian_splatting_torch.rasterize import raster
from gaussian_splatting_torch.structs import TILE_PX, Camera, TileGrid


def band_rows(y_tiles: int, n_bands: int) -> int:
    """Tile rows a band (ceil); the last bands may be padding."""
    return -(-y_tiles // n_bands)


def shard_state(state: T.TrainState, rank: int, world: int) -> T.TrainState:
    """Shard ``rank`` of ``world``: slots [rank * C / world, (rank + 1) * C /
    world) of every capacity-sized tensor; the 0-d Adam count is kept."""
    cap = state.alive.shape[0]
    if cap % world:
        raise ValueError(f"gaussian capacity {cap} must divide model_parallel={world}")
    n = cap // world

    def take(x):
        return x[rank * n:(rank + 1) * n].clone() if x.dim() >= 1 else x

    return T.map_state(take, state)


def gather_state(state: T.TrainState, mesh: comm.Mesh) -> T.TrainState:
    """The inverse of ``shard_state`` over the model group: every slot on
    every rank of the group (a collective)."""
    return T.map_state(
        lambda x: comm.gather(x, 0, mesh.model_group) if x.dim() >= 1 else x, state)


def _band_image(params, alive, uv_offset, camera_K, camera_T_world, background_rgb, *,
                config, camera_hw, n_sh_band, mesh: comm.Mesh):
    """This rank's band of tile rows: (band image (band_rows * 16, W, 3),
    visible (n_loc,) of the local slots, [num_splats, num_visible,
    truncated] of the band's layout)."""
    h, w = camera_hw
    rows = band_rows(TileGrid(h, w).y_tiles, mesh.mp)

    # per-shard geometry and features
    feat, zc, visible, per_pixel_sh = splat_rows(
        params, alive, camera_T_world, Camera(K=camera_K, width=w, height=h),
        near_thresh=config.near_thresh, far_thresh=config.far_thresh,
        cull_mask_padding=config.cull_mask_padding, n_sh_band=n_sh_band,
        use_sh_precompute=config.use_sh_precompute, uv_offset=uv_offset)
    n_feat = feat.shape[0]

    # one gather of the splat bundle; its backward is the reduce-scatter
    bundle = torch.cat([feat, zc[None], visible.to(feat.dtype)[None]])
    full = comm.all_gather(bundle, 1, mesh.model_group)
    feat_full, zc_full, vis_full = full[:n_feat], full[n_feat], full[n_feat + 1] > 0.5

    # the band: rows 0..5 are u, v, op, a + 1/4, b / 2, c + 1/4.  The
    # kernels read v from the features, so v becomes band-local here (a
    # differentiable shift); the layout reads the band's feature rows, as
    # rasterize's reads the view's
    v_origin = float(mesh.model_rank * rows * TILE_PX)
    band_grid = TileGrid(rows * TILE_PX, w)
    v_band = feat_full[1] - v_origin
    feat_band = torch.cat([feat_full[:1], v_band[None], feat_full[2:]])
    with torch.no_grad():
        layout = feature_layout(feat_band, zc_full, vis_full, band_grid, config.mh_dist)
        basis = None
        if per_pixel_sh:
            # the band-local pixel ray through (x, y_local) is the global ray
            # through (x, y_local + v_origin) when cy moves by -v_origin
            shift = torch.zeros_like(camera_K)
            shift[1, 2] = v_origin
            basis = build_pixel_basis(camera_K - shift, camera_T_world,
                                      (n_sh_band + 1) ** 2, band_grid)
    band_img, _ = raster(feat_band, basis, layout, band_grid, background_rgb)
    return band_img, visible, [layout.num_splats, layout.num_visible, layout.truncated]


def mp_render(
    params: dict,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera_K: torch.Tensor,
    *,
    config,
    camera_hw: tuple,
    n_sh_band: int,
    background_rgb: torch.Tensor,
    mesh: comm.Mesh,
    uv_offset=None,
):
    """The full image with the scene sharded over the model group.

    params, alive (and uv_offset (2, n_loc), if given) are this rank's
    shard.  Returns (image (H, W, 3), the same on every rank of the group;
    visible (n_loc,) of the local slots; info: num_splats and truncated
    summed over the bands, num_visible the largest band's, n_alive the
    group's alive count, all 0-d int64 tensors on the device)."""
    h, _ = camera_hw
    band_img, visible, counts = _band_image(
        params, alive, uv_offset, camera_K, camera_T_world, background_rgb,
        config=config, camera_hw=camera_hw, n_sh_band=n_sh_band, mesh=mesh)
    # the bands cover band_rows * mp * 16 >= H pixel rows: crop the overhang
    image = comm.all_gather(band_img, 0, mesh.model_group)[:h]
    num_splats, num_visible, truncated, n_alive = reduce_counts(
        counts + [alive.sum()], "smss", mesh.model_group, mesh)
    info = dict(num_splats=num_splats, num_visible=num_visible, truncated=truncated,
                n_alive=n_alive)
    return image, visible, info


def dp_mp_train_step(
    state: T.TrainState,
    gt_image: torch.Tensor,  # this rank's camera: (H, W, 3) float32 or uint8
    camera_K: torch.Tensor,
    camera_T_world: torch.Tensor,
    background_rgb: torch.Tensor,
    *,
    config,
    camera_hw: tuple,
    n_sh_band: int,
    mesh: comm.Mesh,
):
    """One step on a (dp, mp) mesh: each data replica's model group renders
    its camera in bands; the gradients are averaged over the data group.
    ``state`` is this rank's shard (``shard_state`` by model rank), the
    same on the ranks of its data group.

    Returns (new shard, info) as ``trainer.train_step``: loss and psnr the
    means over the cameras, num_splats (summed over bands) and num_visible
    the maxima over cameras, truncated the sum, n_alive the scene's alive
    count.  The step is skipped on every rank when any rank's loss or
    gradient is not finite (JAX skips per model shard here; see ROADMAP)."""
    gt = T.float_image(gt_image, config)

    def loss_fn(params, uv_offset):
        image, visible, info = mp_render(
            params, state.alive, camera_T_world, camera_K, config=config,
            camera_hw=camera_hw, n_sh_band=n_sh_band, background_rgb=background_rgb,
            mesh=mesh, uv_offset=uv_offset)
        loss, psnr = train_loss(image, gt, config.ssim_frac)
        # every model rank holds the same full-image loss, and the band
        # gather's backward sums the mp identical cotangents
        return loss / mesh.mp, (loss, psnr, visible, info)

    _, (loss, psnr, visible, info), gparams, g_uv = T.value_and_grad(
        state.params, loss_fn, T.zero_uv(state.alive))
    uv_grad = T.uv_grad_rows(g_uv, camera_K, visible)
    seen = visible.to(torch.int32)
    stats = [info["num_splats"], info["num_visible"], info["truncated"]]
    loss, psnr = loss.detach(), psnr.detach()
    if mesh.dp > 1:
        gparams, loss, psnr, uv_grad, seen = reduce_over_data(
            gparams, loss, psnr, uv_grad, seen, mesh)
        stats = reduce_counts(stats, "mms", mesh.data_group, mesh)
    ok = comm.all_ok(T.step_ok(loss, gparams))
    new_state = T.adam_step(state, gparams, ok, config)
    new_state = T.accumulate(new_state, uv_grad, gparams["xyz"].abs(), seen, ok)
    return new_state, dict(loss=loss, psnr=psnr, num_splats=stats[0], num_visible=stats[1],
                           truncated=stats[2], n_alive=info["n_alive"])


def mp_train_step(state, gt_image, camera_K, camera_T_world, background_rgb, *, config,
                  camera_hw, n_sh_band, mesh: comm.Mesh):
    """One step with the scene sharded over a model mesh (dp = 1): the
    semantics of ``trainer.train_step`` on one camera."""
    if mesh.dp != 1:
        raise ValueError(f"mp_train_step takes a model mesh; this one has dp={mesh.dp} "
                         "(use dp_mp_train_step)")
    return dp_mp_train_step(state, gt_image, camera_K, camera_T_world, background_rgb,
                            config=config, camera_hw=camera_hw, n_sh_band=n_sh_band,
                            mesh=mesh)


@torch.no_grad()
def mp_eval_step(state, gt_image, camera_K, camera_T_world, *, config, camera_hw,
                 n_sh_band, mesh: comm.Mesh):
    """``trainer.eval_step`` with the scene sharded: (image, psnr, ssim) of
    one test view on black, the same on every rank of the model group."""
    gt = T.float_image(gt_image, config)
    image, _, _ = mp_render(
        state.params, state.alive, camera_T_world, camera_K, config=config,
        camera_hw=camera_hw, n_sh_band=n_sh_band,
        background_rgb=torch.zeros(3, dtype=torch.float32, device=gt.device), mesh=mesh)
    psnr, ssim_val = eval_psnr_ssim(image, gt)
    return image, psnr, ssim_val
