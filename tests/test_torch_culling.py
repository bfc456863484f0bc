"""Tile assignment and per-tile depth order of the port against the JAX
layout: the reference golden splat list on the fixture, per-tile lists on a
seeded scene, visible counts and window truncation."""

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
