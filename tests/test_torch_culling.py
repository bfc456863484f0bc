"""Tile assignment and per-tile depth order of the port against the JAX
layout: the reference golden splat list on the fixture, per-tile lists on a
seeded scene, visible counts and window truncation.  On the CPU the layout
is its plain version; marked ``card``, the layout kernels
(``csrc/layout.cu``) against that plain version on the card, bit for bit.

The JAX package is imported in a fixture, not at the top: the card tests
run on a machine without it, with ``python3 -m pytest --noconftest
tests/test_torch_culling.py -m card``."""

import functools
import types

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import culling as tcu
from gaussian_splatting_torch import telemetry
from gaussian_splatting_torch.structs import TileGrid
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

CAP = 1 << 16


@pytest.fixture(scope="module")
def jx():
    """The JAX package's layout (jitted: eager dispatch of its tier ladder
    takes ~10x longer), its geometry, TileGrid and fixture, jax.numpy and
    the reference's golden list."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import culling as jcu
    from gaussian_splatting_tpu import geometry as jgeo
    from gaussian_splatting_tpu.structs import TileGrid as JGrid
    from tests import fixtures as fx
    from tests.test_culling import EXPECTED_CULLED_IDX

    @functools.partial(jax.jit, static_argnums=(6,))
    def feat_vjp(uv, conic, z, visible, feat_g, cot, jgrid):
        """JAX's layout, per-splat features and their VJP onto feat_g for the
        per-splat cotangent ``cot`` (R, S), zero on JAX's padding past S, in
        one jit (its custom VJP keeps shape templates as residuals, which
        cannot leave a jit)."""
        def feat_of(f):
            layout, feat = jcu.layout_with_features(uv, conic, z, visible, f, jgrid, 3.0,
                                                    CAP, 256)
            return feat, layout

        feat, vjp, layout = jax.vjp(feat_of, feat_g, has_aux=True)
        cot = jnp.pad(cot, ((0, 0), (0, feat.shape[1] - cot.shape[1])))
        return layout, feat, vjp(cot)[0]

    return types.SimpleNamespace(
        jnp=jnp, jcu=jcu, jgeo=jgeo, JGrid=JGrid, fx=fx, golden=EXPECTED_CULLED_IDX,
        layout=jax.jit(jcu.build_splat_layout, static_argnums=(4, 5, 6, 7)),
        layout_feat=jax.jit(jcu.layout_with_features, static_argnums=(5, 6, 7, 8)),
        feat_vjp=feat_vjp)


def _jax_lists(jx, u, v, conic, z, visible, grid, opacity=None):
    """JAX layout of the same rows: layout-only, or the render path's
    feature bundle (row 2 = opacity), which turns on the opacity cut."""
    jnp = jx.jnp
    args = ((jnp.asarray(u), jnp.asarray(v)), tuple(jnp.asarray(c) for c in conic),
            jnp.asarray(z), jnp.asarray(visible))
    jgrid = jx.JGrid(grid.image_height, grid.image_width)
    if opacity is None:
        layout = jx.layout(*args, jgrid, 3.0, CAP, 256)
    else:
        n = len(u)
        feat = np.zeros((9, n), np.float32)
        feat[2] = opacity
        layout, _ = jx.layout_feat(
            *args, jnp.asarray(feat), jgrid, 3.0, CAP, 256
        )
    assert not bool(layout.overflow)
    gid, starts = jx.jcu.sorted_splat_list(layout, jgrid)
    return gid, starts, layout


def _torch_lists(u, v, conic, z, visible, grid, opacity=None):
    t = torch.tensor
    layout = tcu.build_layout(
        t(u), t(v), tuple(t(c) for c in conic), t(z), t(visible), grid, 3.0,
        opacity=None if opacity is None else t(opacity),
    )
    gid, starts = tcu.sorted_splat_list(layout)
    return gid, starts, layout


def test_fixture_sorted_splat_list_is_golden(jx):
    """The reference's 641-splat list (tests/test_culling.py), exactly, and
    the same list as the JAX layout's."""
    jcu, jgeo, jnp = jx.jcu, jx.jgeo, jx.jnp
    scene = jx.fx.test_scene(opacity_presigmoid=False)
    cam, pose = jx.fx.test_camera(), jx.fx.test_camera_T_world()
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
    np.testing.assert_array_equal(gid, np.array(jx.golden) + 3)
    assert starts.shape == (1201,) and starts[-1] == len(jx.golden)
    jgid, jstarts, _ = _jax_lists(jx, u, v, conic, zc, visible, grid)
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
def test_seeded_per_tile_lists_match_jax(jx, render_path):
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, opacity = _seeded_rows(300, 128, 96, seed=7)
    op = opacity if render_path else None
    gid, starts, layout = _torch_lists(u, v, conic, z, visible, grid, op)
    jgid, jstarts, jlayout = _jax_lists(jx, u, v, conic, z, visible, grid, op)
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


def test_window_truncation_matches_jax(jx):
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
    jgid, jstarts, jlayout = _jax_lists(jx, u, v, conic, z, visible, grid)
    assert layout.truncated == int(jlayout.truncated) == 80 * 65 - 4096
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert layout.num_visible == int(jlayout.num_visible) == 3
    # the 4096 kept cells are the first 63 tile columns plus one cell
    tiles_of_0 = np.repeat(np.arange(grid.tile_count), np.diff(starts))[gid == 0]
    tx, ty = tiles_of_0 % grid.x_tiles, tiles_of_0 // grid.x_tiles
    assert len(tiles_of_0) == 4096
    assert tx.max() == 63 and set(ty[tx == 63]) == {0}


def test_frustum_visible_matches_jax(jx):
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
        want = np.asarray(jx.jcu.frustum_visible(jx.jnp.asarray(xyz), jx.jnp.asarray(uv),
                                                 *args))
        np.testing.assert_array_equal(got, want)
        assert got[:8].tolist() == [True, True, False, far == np.inf] + [True] * 4


def _layout_args(u, v, conic, z, visible, form, t):
    """(uv, conic, z, visible) in one of the two argument forms: (N, C)
    arrays, or tuples of (N,) rows, made by ``t`` (torch.tensor or
    jnp.asarray)."""
    if form == "rows":
        return (t(u), t(v)), tuple(t(c) for c in conic), t(z), t(visible)
    return (t(np.stack([u, v], 1)), t(np.stack(conic, 1)), t(z), t(visible))


@pytest.mark.parametrize("form", ["arrays", "rows"])
def test_build_splat_layout_matches_jax(jx, form):
    """The layout alone: per-tile depth-sorted lists equal JAX's
    ``build_splat_layout``, exactly, in both argument forms."""
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, _ = _seeded_rows(300, 128, 96, seed=7)
    jgrid = jx.JGrid(grid.image_height, grid.image_width)
    layout = tcu.build_splat_layout(*_layout_args(u, v, conic, z, visible, form, torch.tensor),
                                    grid, 3.0)
    # the JAX side in the rows form: the port's form is what is under test
    jlayout = jx.layout(*_layout_args(u, v, conic, z, visible, "rows", jx.jnp.asarray),
                        jgrid, 3.0, CAP, 256)
    assert not bool(jlayout.overflow)
    gid, starts = tcu.sorted_splat_list(layout)
    jgid, jstarts = jx.jcu.sorted_splat_list(jlayout, jgrid)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(gid, jgid)
    assert layout.num_visible == int(jlayout.num_visible)
    # the same lists as build_layout on the rows
    np.testing.assert_array_equal(gid, _torch_lists(u, v, conic, z, visible, grid)[0])


# VJP onto feat_g: the port sums each gaussian's splat cotangents in splat
# order (index_add_), JAX by its two inverted sorts and dense tier sums
# (measured at most 1.7e-7 apart); held to 1e-6 of each row's largest
# gradient
LWF_GRAD_REL = 1e-6


@pytest.mark.parametrize("rows", [3, 9])
@pytest.mark.parametrize("form", ["arrays", "rows"])
def test_layout_with_features_matches_jax(jx, form, rows):
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
    jgrid = jx.JGrid(grid.image_height, grid.image_width)

    tfeat_g = torch.tensor(feat_g, requires_grad=True)
    layout, feat = tcu.layout_with_features(
        *_layout_args(u, v, conic, z, visible, form, torch.tensor), tfeat_g, grid, 3.0)
    s = layout.num_splats
    cot = rng.normal(size=(rows, s)).astype(np.float32)
    jnp = jx.jnp
    jargs = _layout_args(u, v, conic, z, visible, "rows", jnp.asarray)
    if rows >= 6:
        jlayout, jfeat, jgrad = jx.feat_vjp(*jargs, jnp.asarray(feat_g),
                                              jnp.asarray(cot), jgrid)
        jfeat, jgrad = np.asarray(jfeat), np.asarray(jgrad)
    else:
        jlayout = jx.layout(*jargs, jgrid, 3.0, CAP, 256)
    assert not bool(jlayout.overflow)
    gid, starts = tcu.sorted_splat_list(layout)
    jgid, jstarts = jx.jcu.sorted_splat_list(jlayout, jgrid)
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


def test_cpu_layout_takes_the_plain_path_and_launches_nothing(monkeypatch):
    """A layout of CPU rows is ``_layout_plain``'s, with or without the
    opacity, and launches no layout kernel."""
    def no_kernel(*args):
        raise AssertionError("the kernel path ran on CPU rows")

    monkeypatch.setattr(tcu, "_layout_cuda", no_kernel)
    telemetry.LAUNCHES.clear()
    grid = TileGrid(96, 128)
    u, v, conic, z, visible, opacity = _seeded_rows(300, 128, 96, seed=7)
    t = torch.tensor
    rows = (t(u), t(v), *tcu._regularised(tuple(t(c) for c in conic)), t(z), t(visible))
    for op in (None, t(opacity)):
        got = tcu.build_layout(t(u), t(v), tuple(t(c) for c in conic), t(z), t(visible),
                               grid, 3.0, opacity=op)
        want = tcu._layout_plain(*rows, grid, 3.0, op)
        _assert_same_layout(got, want)
    assert not any(k.startswith("layout_") for k in telemetry.LAUNCHES)


def test_layout_refuses_rows_it_has_no_kernel_for():
    """Rows on a device with neither kernel nor plain version raise, and the
    kernel path's argument check refuses a row of another type or length,
    and hands a strided row its stride."""
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tcu._layout(meta, meta, meta, meta, meta, meta, meta.bool(), TileGrid(16, 16), 3.0,
                    None)
    uv = torch.zeros(5, 2)
    rows = [uv[:, 0], uv[:, 1]] + [torch.zeros(5) for _ in range(4)] + [torch.ones(5, dtype=bool)]
    _, strides = tcu._row_args(rows + [None])
    assert list(strides) == [2, 2, 1, 1, 1, 1, 1, 0]
    with pytest.raises(ValueError, match="z must be torch.float32"):
        tcu._row_args(rows[:5] + [rows[5].double(), rows[6], None])
    with pytest.raises(ValueError, match="opacity must be"):
        tcu._row_args(rows + [torch.zeros(4)])


def _assert_same_layout(got, want):
    """Every field equal: tensors bit for bit, of one type and device."""
    for name, a, b in zip(tcu.SplatLayout._fields, got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device, name
            assert torch.equal(a, b), name
        else:
            assert a == b, (name, a, b)


# ---------------------------------------------------------------------------
# on the card: the layout kernels against the plain version, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def _card_layouts(rows, grid, opacity, mh_dist=3.0):
    """The kernel layout of (u, v, a, b, c, z, visible) on the card, held to
    ``_layout_plain``'s of the same rows; one count and one fill launch."""
    telemetry.LAUNCHES.clear()
    got = tcu._layout(*rows, grid, mh_dist, opacity)
    assert telemetry.LAUNCHES["layout_count"] == telemetry.LAUNCHES["layout_fill"] == 1
    want = tcu._layout_plain(*rows, grid, mh_dist, opacity)
    _assert_same_layout(got, want)
    assert int(got.tile_starts[-1]) == got.num_splats == got.gaussian_idx.numel()
    return got


def _card_rows(card, u, v, conic, z, visible, opacity=None):
    """numpy rows to the card: the layout's regularised rows and opacity."""
    t = functools.partial(torch.tensor, device=card)
    rows = (t(u), t(v), *tcu._regularised(tuple(t(c) for c in conic)), t(z), t(visible))
    return rows, None if opacity is None else t(opacity)


def _feature_rows(feat, z, visible):
    """The layout's rows of the rasterizer's feature rows, and the opacity."""
    from gaussian_splatting_torch.ops import common as cc

    rows = (feat[cc.FEAT_U], feat[cc.FEAT_V], feat[cc.FEAT_A], feat[cc.FEAT_B],
            feat[cc.FEAT_C], z, visible)
    return rows, feat[cc.FEAT_OPACITY]


def _spread_rows(n, width, height, seed, equal_depth=False):
    """``_seeded_rows`` over a wider range of sizes, from under a pixel to a
    few hundred (windows of 1 to ~1,000 tiles), and a third of the opacities
    near ALPHA_SKIP; with ``equal_depth`` every depth is 3.0, so tiles hold
    ties that only the stable order settles."""
    u, v, conic, z, visible, opacity = _seeded_rows(n, width, height, seed)
    rng = np.random.default_rng(seed + 100)
    sx = np.exp(rng.uniform(np.log(0.3), np.log(300.0), n))
    sy = sx * np.exp(rng.uniform(-2.0, 2.0, n))
    rho = rng.uniform(-0.99, 0.99, n)
    conic = [(sx * sx).astype(np.float32), (2 * rho * sx * sy).astype(np.float32),
             (sy * sy).astype(np.float32)]
    conic[1][11] = np.inf
    opacity[n // 3: 2 * n // 3] = rng.uniform(0.0039, 0.02, 2 * n // 3 - n // 3)
    if equal_depth:
        z = np.full(n, 3.0, np.float32)
    return u, v, conic, z, visible, opacity


@pytest.mark.card
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("render_path", [False, True])
def test_card_seeded_layout_is_the_plain_one(card, seed, render_path):
    """Seeded scenes at 640x480 with depths spaced 0.01 apart, with and
    without the opacity-aware window."""
    u, v, conic, z, visible, opacity = _spread_rows(20_000, 640, 480, seed)
    rows, op = _card_rows(card, u, v, conic, z, visible, opacity)
    got = _card_layouts(rows, TileGrid(480, 640), op if render_path else None)
    assert got.num_splats > 20_000


@pytest.mark.card
def test_card_equal_depths_keep_the_stable_order(card):
    """Every depth equal: a tile's splats in gaussian order, as the plain
    stable sort leaves them."""
    u, v, conic, z, visible, opacity = _spread_rows(20_000, 640, 480, 4, equal_depth=True)
    rows, op = _card_rows(card, u, v, conic, z, visible, opacity)
    got = _card_layouts(rows, TileGrid(480, 640), op)
    starts = got.tile_starts.cpu().numpy()
    gid = got.gaussian_idx.cpu().numpy()
    shared = [t for t in range(len(starts) - 1) if starts[t + 1] - starts[t] > 1]
    assert shared and all((np.diff(gid[starts[t]:starts[t + 1]]) > 0).all() for t in shared)


@pytest.mark.card
def test_card_window_truncation(card):
    """A window past MAX_WINDOW_CELLS: its first 4096 cells, the rest
    counted in ``truncated``."""
    u = np.array([640.0, 100.0, 900.0], np.float32)
    v = np.array([520.0, 60.0, 700.0], np.float32)
    conic = [np.array([4e6, 100.0, 2.0], np.float32),
             np.array([0.0, 40.0, 0.0], np.float32),
             np.array([4e6, 50.0, 3.0], np.float32)]
    z = np.array([5.0, 2.0, 3.0], np.float32)
    rows, _ = _card_rows(card, u, v, conic, z, np.ones(3, bool))
    got = _card_layouts(rows, TileGrid(1040, 1280), None)
    assert got.truncated == 80 * 65 - 4096 and got.num_visible == 3


@pytest.mark.card
@pytest.mark.parametrize("render_path", [False, True])
def test_card_non_finite_and_huge_rows(card, render_path):
    """NaN and inf in every row and the opacity, and finite entries so large
    that the box's corners overflow to inf and NaN."""
    u, v, conic, z, visible, opacity = _spread_rows(4_000, 640, 480, 5)
    rng = np.random.default_rng(5)
    for row in (u, v, z, conic[0], conic[1], conic[2], opacity):
        row[rng.choice(4_000, 40, replace=False)] = rng.choice([np.nan, np.inf, -np.inf], 40)
    for row in (conic[0], conic[1], conic[2]):
        row[rng.choice(4_000, 40, replace=False)] = rng.choice([3e38, -3e38, 1e30], 40)
    rows, op = _card_rows(card, u, v, conic, z, visible, opacity)
    _card_layouts(rows, TileGrid(480, 640), op if render_path else None)


@pytest.mark.card
def test_card_build_splat_layout_without_opacity(card):
    """The layout-only entry (no opacity) goes through the kernels and gives
    the plain layout."""
    u, v, conic, z, visible, _ = _spread_rows(20_000, 640, 480, 6)
    grid = TileGrid(480, 640)
    rows, _ = _card_rows(card, u, v, conic, z, visible)
    t = functools.partial(torch.tensor, device=card)
    telemetry.LAUNCHES.clear()
    got = tcu.build_splat_layout((t(u), t(v)), tuple(t(c) for c in conic), t(z),
                                 t(visible), grid, 3.0)
    assert telemetry.LAUNCHES["layout_count"] == telemetry.LAUNCHES["layout_fill"] == 1
    _assert_same_layout(got, tcu._layout_plain(*rows, grid, 3.0, None))


@pytest.mark.card
def test_card_nothing_visible(card):
    """No visible gaussian: no splat, every tile start 0."""
    u, v, conic, z, _, opacity = _spread_rows(1_000, 640, 480, 7)
    rows, op = _card_rows(card, u, v, conic, z, np.zeros(1_000, bool), opacity)
    got = _card_layouts(rows, TileGrid(480, 640), op)
    assert got.num_splats == got.num_visible == 0 and not bool(got.tile_starts.any())


@pytest.mark.card
@pytest.mark.parametrize("case", ["fixture", "garden"])
def test_card_scene_layout_is_the_plain_one(card, case):
    """The geometry kernel's feature rows of the 640x480 fixture and of
    garden view 0 at 1296x840 (the trained scene, whole), with and without
    the opacity-aware window."""
    import chip_smoke

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.ops.geometry import splat_rows

    if case == "fixture":
        scene, cam, pose = chip_smoke.fixture_scene(card)
        cull = dict(near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0)
    else:
        scene, cam, pose = chip_smoke.scene_view(card)
        cfg = SplatConfig()
        cull = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                    cull_mask_padding=cfg.cull_mask_padding)
    params = {k: v.detach() for k, v in scene.params().items()}
    with torch.no_grad():
        g = splat_rows(params, scene.alive, pose, cam, **cull)
    rows, op = _feature_rows(g.feat, g.z, g.visible)
    grid = TileGrid(cam.height, cam.width)
    for opacity in (op, None):
        got = _card_layouts(rows, grid, opacity)
        assert got.num_splats > 0
    if case == "garden":
        assert got.num_splats > 500_000
