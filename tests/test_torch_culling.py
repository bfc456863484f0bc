"""Tile assignment and per-tile depth order of the port against the JAX
layout: the reference golden splat list on the fixture, per-tile lists on a
seeded scene, visible counts and window truncation."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import culling as jcu
from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_tpu.structs import TileGrid as JGrid
from gaussian_splatting_torch import culling as tcu
from gaussian_splatting_torch.structs import TileGrid
from tests import fixtures as fx
from tests.test_culling import EXPECTED_CULLED_IDX
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

CAP = 1 << 16
# jitted: eager dispatch of the JAX layout's tier ladder takes ~10x longer
_jax_layout = jax.jit(jcu.build_splat_layout, static_argnums=(4, 5, 6, 7))
_jax_layout_feat = jax.jit(jcu.layout_with_features, static_argnums=(5, 6, 7, 8))


def _jax_lists(u, v, conic, z, visible, grid, opacity=None):
    """JAX layout of the same rows: layout-only, or the render path's
    feature bundle (row 2 = opacity), which turns on the opacity cut."""
    args = ((jnp.asarray(u), jnp.asarray(v)), tuple(jnp.asarray(c) for c in conic),
            jnp.asarray(z), jnp.asarray(visible))
    jgrid = JGrid(grid.image_height, grid.image_width)
    if opacity is None:
        layout = _jax_layout(*args, jgrid, 3.0, CAP, 256)
    else:
        n = len(u)
        feat = np.zeros((9, n), np.float32)
        feat[2] = opacity
        layout, _ = _jax_layout_feat(
            *args, jnp.asarray(feat), jgrid, 3.0, CAP, 256
        )
    assert not bool(layout.overflow)
    gid, starts = jcu.sorted_splat_list(layout, jgrid)
    return gid, starts, layout


def _torch_lists(u, v, conic, z, visible, grid, opacity=None):
    t = torch.tensor
    layout = tcu.build_layout(
        t(u), t(v), tuple(t(c) for c in conic), t(z), t(visible), grid, 3.0,
        opacity=None if opacity is None else t(opacity),
    )
    gid, starts = tcu.sorted_splat_list(layout)
    return gid, starts, layout


def test_fixture_sorted_splat_list_is_golden():
    """The reference's 641-splat list (tests/test_culling.py), exactly, and
    the same list as the JAX layout's."""
    scene = fx.test_scene(opacity_presigmoid=False)
    cam, pose = fx.test_camera(), fx.test_camera_T_world()
    xc, yc, zc = jgeo.transform_rows(*scene.xyz.T, pose)
    u, v = jgeo.project_rows(xc, yc, zc, cam.K)
    sig = jgeo.sigma_world_rows(scene.quaternion, scene.scale)
    conic = [np.asarray(c) for c in jgeo.conic_rows(sig, xc, yc, zc, cam.K, pose)]
    u, v, zc = np.asarray(u), np.asarray(v), np.asarray(zc)
    visible = np.asarray(jcu.frustum_visible_rows(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(zc), (640, 480), 0.3,
        np.inf, 10.0))
    t_vis = tcu.frustum_visible_rows(
        torch.tensor(u), torch.tensor(v), torch.tensor(zc),
        (640, 480), 0.3, float("inf"), 10.0).numpy()
    np.testing.assert_array_equal(t_vis, visible)
    grid = TileGrid(480, 640)
    gid, starts, layout = _torch_lists(u, v, conic, zc, visible, grid)
    np.testing.assert_array_equal(gid, np.array(EXPECTED_CULLED_IDX) + 3)
    assert starts.shape == (1201,) and starts[-1] == len(EXPECTED_CULLED_IDX)
    jgid, jstarts, _ = _jax_lists(u, v, conic, zc, visible, grid)
    np.testing.assert_array_equal(gid, jgid)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(layout.tile_counts.numpy(), np.diff(starts))
    assert layout.num_splats == 641


def _seeded_rows(n, width, height, seed):
    """Random splats in and around the image; depths spaced 0.01 apart, far
    wider than the JAX key's depth quantisation (2^-17 relative at 48 tiles),
    so both orders are the exact depth order."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-12, width + 12, n).astype(np.float32)
    v = rng.uniform(-12, height + 12, n).astype(np.float32)
    sx, sy = rng.uniform(0.5, 9.0, n), rng.uniform(0.5, 9.0, n)
    rho = rng.uniform(-0.9, 0.9, n)
    conic = [(sx * sx).astype(np.float32), (2 * rho * sx * sy).astype(np.float32),
             (sy * sy).astype(np.float32)]
    z = (2.0 + 0.01 * rng.permutation(n)).astype(np.float32)
    opacity = rng.uniform(0.0, 1.0, n).astype(np.float32)
    opacity[:10] = 0.002  # below ALPHA_SKIP: invisible on the render path
    visible = rng.uniform(size=n) > 0.1
    u[10], conic[1][11] = np.nan, np.inf  # non-finite entries are invisible
    return u, v, conic, z, visible, opacity


@pytest.mark.parametrize("render_path", [False, True])
def test_seeded_per_tile_lists_match_jax(render_path):
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, opacity = _seeded_rows(300, 128, 96, seed=7)
    op = opacity if render_path else None
    gid, starts, layout = _torch_lists(u, v, conic, z, visible, grid, op)
    jgid, jstarts, jlayout = _jax_lists(u, v, conic, z, visible, grid, op)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert layout.num_visible == int(jlayout.num_visible)
    assert layout.num_splats == int(jlayout.num_splats) == starts[-1]
    assert layout.truncated == int(jlayout.truncated) == 0
    np.testing.assert_array_equal(layout.tile_has_output.numpy(),
                                  np.asarray(jlayout.tile_has_output))
    assert not np.isin([10, 11], gid).any()
    if render_path:
        assert not np.isin(np.arange(10), gid).any()
        # the opacity-aware window drops cells the pure window keeps
        assert layout.num_splats < _torch_lists(u, v, conic, z, visible, grid)[2].num_splats


def test_window_truncation_matches_jax():
    """A window of 80x65 = 5200 tiles renders its first 4096 cells (x outer,
    y inner) and reports the other 1104 as truncated, as the JAX layout
    does."""
    grid = TileGrid(1040, 1280)
    u = np.array([640.0, 100.0, 900.0], np.float32)
    v = np.array([520.0, 60.0, 700.0], np.float32)
    conic = [np.array([4e6, 100.0, 2.0], np.float32),
             np.array([0.0, 40.0, 0.0], np.float32),
             np.array([4e6, 50.0, 3.0], np.float32)]
    z = np.array([5.0, 2.0, 3.0], np.float32)
    visible = np.ones(3, bool)
    gid, starts, layout = _torch_lists(u, v, conic, z, visible, grid)
    jgid, jstarts, jlayout = _jax_lists(u, v, conic, z, visible, grid)
    assert layout.truncated == int(jlayout.truncated) == 80 * 65 - 4096
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert layout.num_visible == int(jlayout.num_visible) == 3
    # the 4096 kept cells are the first 63 tile columns plus one cell
    tiles_of_0 = np.repeat(np.arange(grid.tile_count), np.diff(starts))[gid == 0]
    tx, ty = tiles_of_0 % grid.x_tiles, tiles_of_0 // grid.x_tiles
    assert len(tiles_of_0) == 4096
    assert tx.max() == 63 and set(ty[tx == 63]) == {0}


def test_frustum_visible_matches_jax():
    """The (N, C) wrapper's mask equals JAX's exactly, points on every
    bound included, with and without a far cull."""
    rng = np.random.default_rng(31)
    n = 200
    xyz = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                    rng.uniform(-1, 120, n)], axis=1).astype(np.float32)
    uv = np.stack([rng.uniform(-30, 170, n), rng.uniform(-30, 130, n)],
                  axis=1).astype(np.float32)
    xyz[:8, 2] = [0.3, 100.0, 0.2999, 100.001, 5.0, 5.0, 5.0, 5.0]
    uv[:4] = [60.0, 50.0]
    uv[4:8] = [[-10.0, 50.0], [138.0, 50.0], [60.0, -10.0], [60.0, 106.0]]
    for far in (100.0, np.inf):
        args = ((128, 96), 0.3, far, 10.0)
        got = tcu.frustum_visible(torch.tensor(xyz), torch.tensor(uv), *args).numpy()
        want = np.asarray(jcu.frustum_visible(jnp.asarray(xyz), jnp.asarray(uv), *args))
        np.testing.assert_array_equal(got, want)
        assert got[:8].tolist() == [True, True, False, far == np.inf] + [True] * 4


def _layout_args(u, v, conic, z, visible, form, lib):
    """(uv, conic, z, visible) in one of the two argument forms: (N, C)
    arrays, or tuples of (N,) rows."""
    t = torch.tensor if lib == "torch" else jnp.asarray
    if form == "rows":
        return (t(u), t(v)), tuple(t(c) for c in conic), t(z), t(visible)
    return (t(np.stack([u, v], 1)), t(np.stack(conic, 1)), t(z), t(visible))


@pytest.mark.parametrize("form", ["arrays", "rows"])
def test_build_splat_layout_matches_jax(form):
    """The layout alone: per-tile depth-sorted lists equal JAX's
    ``build_splat_layout``, exactly, in both argument forms."""
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, _ = _seeded_rows(300, 128, 96, seed=7)
    jgrid = JGrid(grid.image_height, grid.image_width)
    layout = tcu.build_splat_layout(*_layout_args(u, v, conic, z, visible, form, "torch"),
                                    grid, 3.0)
    # the JAX side in the rows form: the port's form is what is under test
    jlayout = _jax_layout(*_layout_args(u, v, conic, z, visible, "rows", "jax"),
                          jgrid, 3.0, CAP, 256)
    assert not bool(jlayout.overflow)
    gid, starts = tcu.sorted_splat_list(layout)
    jgid, jstarts = jcu.sorted_splat_list(jlayout, jgrid)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert layout.num_visible == int(jlayout.num_visible)
    # the same lists as build_layout on the rows
    np.testing.assert_array_equal(gid, _torch_lists(u, v, conic, z, visible, grid)[0])


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_feat_vjp(uv, conic, z, visible, feat_g, cot, jgrid):
    """JAX's layout, per-splat features and their VJP onto feat_g for the
    per-splat cotangent ``cot`` (R, S), zero on JAX's padding past S, in one
    jit (its custom VJP keeps shape templates as residuals, which cannot
    leave a jit)."""
    def feat_of(f):
        layout, feat = jcu.layout_with_features(uv, conic, z, visible, f, jgrid, 3.0,
                                                CAP, 256)
        return feat, layout

    feat, vjp, layout = jax.vjp(feat_of, feat_g, has_aux=True)
    cot = jnp.pad(cot, ((0, 0), (0, feat.shape[1] - cot.shape[1])))
    return layout, feat, vjp(cot)[0]


# VJP onto feat_g: the port sums each gaussian's splat cotangents in splat
# order (index_add_), JAX by its two inverted sorts and dense tier sums
# (measured at most 1.7e-7 apart); held to 1e-6 of each row's largest
# gradient
LWF_GRAD_REL = 1e-6


@pytest.mark.parametrize("rows", [3, 9])
@pytest.mark.parametrize("form", ["arrays", "rows"])
def test_layout_with_features_matches_jax(form, rows):
    """A 9-row bundle, the rasterizer's (rows 0, 1, 3-5 from the layout's
    own geometry, row 2's opacity shrinking the window): the layout and the
    per-splat feature columns equal JAX's ``layout_with_features`` at
    precision="f32", tile by tile, exactly, and the VJP onto feat_g for a
    seeded per-splat cotangent matches JAX's permutation inversion within
    ``LWF_GRAD_REL``.  A 3-row bundle, carried as it is: the lists equal
    JAX's ``build_splat_layout``'s (a JAX compile of its own for each
    bundle costs ~8 s), the columns feat_g[:, gid] and the VJP the exact
    sum of each gaussian's splat cotangents, to which the 9-row case holds
    JAX's inversion too."""
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, opacity = _seeded_rows(300, 128, 96, seed=7)
    rng = np.random.default_rng(rows)
    feat_g = rng.normal(size=(rows, len(u))).astype(np.float32)
    if rows >= 6:
        feat_g[2] = opacity
    jgrid = JGrid(grid.image_height, grid.image_width)

    tfeat_g = torch.tensor(feat_g, requires_grad=True)
    layout, feat = tcu.layout_with_features(
        *_layout_args(u, v, conic, z, visible, form, "torch"), tfeat_g, grid, 3.0)
    s = layout.num_splats
    cot = rng.normal(size=(rows, s)).astype(np.float32)
    jargs = _layout_args(u, v, conic, z, visible, "rows", "jax")
    if rows >= 6:
        jlayout, jfeat, jgrad = _jax_feat_vjp(*jargs, jnp.asarray(feat_g),
                                              jnp.asarray(cot), jgrid)
        jfeat, jgrad = np.asarray(jfeat), np.asarray(jgrad)
    else:
        jlayout = _jax_layout(*jargs, jgrid, 3.0, CAP, 256)
    assert not bool(jlayout.overflow)
    gid, starts = tcu.sorted_splat_list(layout)
    jgid, jstarts = jcu.sorted_splat_list(jlayout, jgrid)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert feat.shape == (rows, s)
    # the sum of each gaussian's splat cotangents
    want = np.zeros_like(feat_g)
    np.add.at(want, (slice(None), gid), cot.astype(np.float64))
    if rows >= 6:
        for t in np.flatnonzero(np.diff(starts)):
            lo, hi = starts[t], starts[t + 1]
            np.testing.assert_array_equal(feat[:, lo:hi].detach().numpy(),
                                          jfeat[:, lo:hi])
        # the rasterizer's bundle: the opacity cut is on, u, v come from the layout
        assert s < _torch_lists(u, v, conic, z, visible, grid)[2].num_splats
        np.testing.assert_array_equal(feat[0].detach().numpy(), u[gid])
        np.testing.assert_allclose(jgrad, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(feat.detach().numpy(), feat_g[:, gid])
        jgrad = want

    (grad,) = torch.autograd.grad(feat, tfeat_g, torch.from_numpy(cot))
    scale = np.abs(jgrad).max(axis=1, keepdims=True)
    err = np.abs(grad.numpy() - jgrad) / scale
    assert err.max() <= LWF_GRAD_REL, err.max(axis=1)
    never = np.setdiff1d(np.arange(len(u)), gid)
    assert (grad.numpy()[:, never] == 0).all() and (jgrad[:, never] == 0).all()
