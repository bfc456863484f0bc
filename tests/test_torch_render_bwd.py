"""Kernel B2's plain PyTorch version (the DC backward rasterizer) against
the JAX backward run in Pallas interpret mode at f32, against float64
autograd of the port's compositing oracle, and ``rasterize``'s gradients
against ``jax.grad`` of the JAX ``rasterize``.

Tolerances are relative to each gradient row's largest magnitude: a
gradient sums per-pixel terms q = alpha * (A * T - D / (1 - alpha)), and
D = E - (colour prefix) cancels in near-saturated pixels, so an absolute
bound would say nothing across rows whose scales differ by 1e4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import culling as jcu
from gaussian_splatting_tpu.ops import render as jrender
from gaussian_splatting_tpu.rasterize import rasterize as jrasterize
from gaussian_splatting_tpu.structs import Camera as JCamera
from gaussian_splatting_tpu.structs import TileGrid as JGrid
from gaussian_splatting_torch import convert
from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import reference_impl as ref
from gaussian_splatting_torch.ops import render as trender
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera
from tests import fixtures as fx
from tests.test_torch_render import _fixture_rows, _seeded_rows
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# f32 against the JAX kernel, per feature row (u, v, op, a, b, c, r, g, b).
# Both sum ~1e3 per-pixel terms per gaussian in other orders, and JAX forms
# T as exp(sum log1p(-alpha)) where the port multiplies: below 4e-6 of each
# row's max on these inputs.  The conic rows a, b, c are looser on JAX's
# side: it forms them from raw pixel moments about the tile centre
# (muu = suu - ul * (2 su - ul m1)), which cancel for splats centred far
# from the tile; against the port in float64 JAX is off by up to 4.2e-5
# there and the port's float32 by under 1e-6.
JAX_REL_TOL = np.array([2e-5, 2e-5, 2e-5, 2e-4, 2e-4, 2e-4, 2e-5, 2e-5, 2e-5])
# f32 plain version against float64 autograd (alpha < 0.9999, where the
# clamp never acts): float32 rounding only, measured below 1e-6
ORACLE_REL_TOL = 1e-5
# rasterize end to end: the geometry chain's float32 rounding is amplified
# by its Jacobians (xyz, quaternion); measured below 1e-5 of each leaf's max
RASTER_REL_TOL = 1e-4
BACKGROUND = np.array([0.2, 0.3, 0.4], np.float32)


def _rel_err(got, want):
    """max |got - want| per row over max |want| per row: (rows,)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    axes = tuple(range(1, want.ndim))
    return np.abs(got - want).max(axis=axes) / np.maximum(np.abs(want).max(axis=axes), 1e-30)


def _cotangent(n_tiles, seed):
    rng = np.random.default_rng(seed)
    g_img = rng.normal(size=(n_tiles, cc.PIXELS_PER_TILE, 3)).astype(np.float32)
    g_t = rng.normal(size=(n_tiles, cc.PIXELS_PER_TILE)).astype(np.float32)
    return g_img, g_t


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_feat_grad(uv, conic, z, feat_g, grid, cap, bg, g_img, g_t):
    """VJP of the JAX layout + Pallas render (interpret mode, f32) with
    respect to the per-gaussian features (9, N)."""

    def render(feat_g):
        layout, feat = jcu.layout_with_features(
            uv, conic, z, jnp.ones_like(z, bool), feat_g, grid, 3.0, cap, 256
        )
        meta = jrender.build_step_meta(layout, grid.tile_count, 256)
        return jrender.render_tiles(
            jrender.pad_feature_rows(feat), meta, bg, layout.tile_has_output,
            n_tiles=grid.tile_count, x_tiles=grid.x_tiles, chunk=256,
            interpret=True, precision="f32",
        )

    _, vjp = jax.vjp(render, feat_g)
    return vjp((g_img, g_t))[0]


def _port_feat_grad(rows, grid, g_img, g_t, bg=BACKGROUND, dtype=torch.float32):
    """The port's layout, plain B1 and (through autograd) plain B2."""
    u, v, op, c0, c1, c2, r, g, b, z = [torch.tensor(x) for x in rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    feat = trender.splat_feature_rows(u, v, op, c0, c1, c2, r, g, b).to(dtype)
    feat.requires_grad_(True)
    img, T = trender.render_tiles(feat, layout, torch.tensor(bg, dtype=dtype),
                                  grid.x_tiles)
    (img * torch.tensor(g_img, dtype=dtype)).sum().add_(
        (T * torch.tensor(g_t, dtype=dtype)).sum()).backward()
    return feat.grad.numpy(), layout, feat.detach()


@pytest.mark.parametrize("case", ["fixture", "seeded"])
def test_plain_b2_matches_jax_backward(case):
    """Gradients of all nine feature rows, through a nonzero background and
    a nonzero T cotangent.  The JAX forward keeps multiplying T below T_EPS
    where the port stops; that enters E only as g_T * T < 1e-4 * |g_T|."""
    rows, grid = _fixture_rows() if case == "fixture" else _seeded_rows()
    g_img, g_t = _cotangent(grid.tile_count, seed=5)
    got, layout, _ = _port_feat_grad(rows, grid, g_img, g_t)
    u, v, op, c0, c1, c2, r, g, b, z = [jnp.asarray(x) for x in rows]
    feat_g = jnp.stack([u, v, op, c0 + 0.25, c1 * 0.5, c2 + 0.25, r, g, b])
    want = _jax_feat_grad(
        (u, v), (c0, c1, c2), z, feat_g, JGrid(grid.image_height, grid.image_width),
        1 << 13, jnp.asarray(BACKGROUND), jnp.asarray(g_img), jnp.asarray(g_t),
    )
    want = np.asarray(want)
    assert layout.num_splats > 0 and np.abs(want).max(axis=1).min() > 0
    err = _rel_err(got, want)
    assert (err < JAX_REL_TOL).all(), err


def test_plain_b2_matches_f64_autograd_of_oracle():
    """Where alpha < 0.9999 the clamp never acts and B2 is the exact VJP of
    the forward: float64 autograd of composite_dense on the port's own
    layout gives it."""
    rows, grid = _seeded_rows(seed=3)
    cap = np.float32(0.99)
    rows[2] = np.minimum(rows[2], cap)  # opacity caps alpha
    g_img, g_t = _cotangent(grid.tile_count, seed=6)
    got, layout, feat = _port_feat_grad(rows, grid, g_img, g_t)

    counts = layout.tile_counts.long()
    slot = torch.arange(int(counts.max()))
    valid = slot[None, :] < counts[:, None]
    idx = (layout.tile_starts[:-1, None].long() + slot).clamp_max(layout.num_splats - 1)
    gid = layout.gaussian_idx[idx].long()
    feat64 = feat.double().requires_grad_(True)
    img, T = ref.composite_dense(feat64.T[gid], valid, grid.x_tiles)
    img = ref.apply_background(img, T, torch.tensor(BACKGROUND, dtype=torch.float64))
    loss = (img * torch.tensor(g_img, dtype=torch.float64)).sum() + (
        T * torch.tensor(g_t, dtype=torch.float64)).sum()
    loss.backward()
    want = feat64.grad.numpy()
    assert float(feat[cc.FEAT_OPACITY].max()) <= cap < cc.ALPHA_CLAMP
    err = _rel_err(got, want)
    assert (err < ORACLE_REL_TOL).all(), err


def test_render_bwd_dispatch():
    """render_bwd runs the plain version on the CPU and refuses any device
    without a kernel; the CUDA wrapper refuses CPU tensors."""
    rows, grid = _seeded_rows(n=40, width=48, height=32)
    g_img, g_t = _cotangent(grid.tile_count, seed=7)
    _, layout, feat = _port_feat_grad(rows, grid, g_img, g_t)
    raw = trender.render_fwd(feat, layout.gaussian_idx, layout.tile_starts, grid.x_tiles)
    cot = torch.tensor(np.concatenate([g_img.reshape(-1, 3).T, g_t.reshape(1, -1)]))
    args = (feat, layout.gaussian_idx, layout.tile_starts, grid.x_tiles, raw, cot)
    np.testing.assert_array_equal(trender.render_bwd(*args).numpy(),
                                  trender.render_bwd_plain(*args).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        trender.render_bwd_cuda(*args)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        trender.render_bwd(*meta)


RENDER = dict(near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0, mh_dist=3.0)


def _fixture_params(seed=9):
    """The 6-gaussian fixture with opacity 0.9 and seeded SH bands 1..3."""
    s = fx.test_scene(opacity_presigmoid=True)
    p = {k: np.asarray(v).copy() for k, v in s.params().items()}
    rng = np.random.default_rng(seed)
    p["opacity"][:] = np.log(0.9 / 0.1)
    p["sh"] = (0.3 * rng.normal(size=p["sh"].shape)).astype(np.float32)
    return p, np.asarray(s.alive)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_raster_grad(params, alive, pose, K, n_sh_band, weights, bg):
    def loss(params, uv_offset):
        res = jrasterize(
            params, alive, pose, JCamera(K=K, width=640, height=480),
            background_rgb=bg, n_sh_band=n_sh_band, splat_capacity=1 << 14,
            chunk=256, uv_offset=uv_offset, interpret=True,
            kernel_precision="f32", **RENDER,
        )
        return jnp.sum(res.image * weights)

    return jax.grad(loss, argnums=(0, 1))(params, jnp.zeros((2, alive.shape[0]), jnp.float32))


def test_rasterize_grads_match_jax():
    """d(sum(image * W)) / d(every param, uv_offset) on the fixture at SH
    band 3 with a nonzero background, against jax.grad of rasterize."""
    params, alive = _fixture_params()
    weights = np.random.default_rng(1).normal(size=(480, 640, 3)).astype(np.float32)
    pose, K = np.asarray(fx.test_camera_T_world()), np.asarray(fx.test_camera().K)
    jg, juv = _jax_raster_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jnp.asarray(pose), jnp.asarray(K), 3, jnp.asarray(weights), jnp.asarray(BACKGROUND),
    )
    scene = convert.scene_from_numpy(params, alive, "cpu")
    tp = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params().items()}
    uv = torch.zeros(2, alive.shape[0], requires_grad=True)
    res = rasterize(tp, scene.alive, torch.tensor(pose), Camera(torch.tensor(K), 640, 480),
                    background_rgb=torch.tensor(BACKGROUND), n_sh_band=3, uv_offset=uv,
                    **RENDER)
    (res.image * torch.tensor(weights)).sum().backward()
    leaves = {**{k: (tp[k].grad, jg[k]) for k in tp}, "uv_offset": (uv.grad, juv)}
    for k, (got, want) in leaves.items():
        want = np.asarray(want)
        assert np.abs(want).max() > 0, k
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < RASTER_REL_TOL, (k, err)
    # only the three visible gaussians get a gradient
    assert (uv.grad.numpy()[:, :3] == 0).all() and (np.abs(uv.grad.numpy()[:, 3:]) > 0).all()
