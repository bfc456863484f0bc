"""The algebra of the two-phase backward kernels B2 and B4
(``csrc/render_bwd.cu``, ``csrc/render_sh_bwd.cu``), on the CPU.

A test-local plain torch model of the kernels' rounds: phase A walks each
tile's splats front to back per pixel and stages q = alpha * dL/dalpha and
the weight w (zero where a splat does not composite) for a round of R
splats; phase B rebuilds the round's gradient rows from what was staged,
the colour rows as products of the staged weights with the tile's pixels
(sum_p w g_c, or sum_p w g_c b_k for per-pixel SH) and the geometry rows
from sums of q times du, dv and mh recomputed from the splat's geometry,
i.e. q-weighted moments about the splat's own centre.

The model in float32 is held against the plain versions ``render_bwd_plain``
and ``render_sh_bwd_plain`` in float32 and in float64, per gradient row
relative to the row's largest magnitude (opacity capped at 0.99, so that
float32 can agree with float64), on the 6-gaussian fixture and on a seeded
scene with wide splats centred over 100 px from tiles they cover
(where moments about the tile centre cancel), at n_sh 4, 9 and 16, and with
tile lengths that are not multiples of R.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import render as trender
from gaussian_splatting_torch.ops import render_sh as trsh
from gaussian_splatting_torch.structs import TILE_PX
from tests.test_torch_render import _fixture_rows, _seeded_rows
from tests.test_torch_render_bwd import _rel_err
from tests.test_torch_render_sh import _port as _sh_port
from tests.test_torch_render_sh import _sh_rows

# the model and the plain versions sum the same terms in other orders
STAGED_REL_TOL = 1e-5
# opacity cap of the scenes: float32 agrees with float64 to 1e-5 only where
# 1 / (1 - alpha), which multiplies D = E - (colour prefix), stays small
OPACITY_CAP = 0.99
FAR_PX = 100.0  # a splat this far from a tile it covers is the cancellation case


def _geom_rows(s, a, b, c, op, rdet):
    """Rows u, v, opacity, a, b, c from the sums s[i] = sum_p q * (1, du,
    dv, du^2, dv^2, du dv, mh) (render_bwd.cu's phase B)."""
    return torch.stack([
        rdet * (c * s[1] - b * s[2]),
        rdet * (a * s[2] - b * s[1]),
        s[0] / op.clamp_min(1e-30),
        (-0.5 * rdet) * (s[4] - c * s[6]),
        rdet * (s[5] - b * s[6]),
        (-0.5 * rdet) * (s[3] - a * s[6]),
    ])


def staged_bwd(feat, gaussian_idx, tile_starts, x_tiles, raw, grad_raw, rnd,
               colour, colour_rows):
    """The two-phase backward, round by round: returns grad_feat like the
    plain versions.  ``colour(gid, t)`` gives the splats' colour at tile
    t's pixels, (3, 256, C); ``colour_rows(W, gch, t)`` the colour rows'
    sums from the staged weights W (C, 256) and the cotangent gch (3, 256),
    (C, rows - 6)."""
    dt = feat.dtype
    px = cc.PIXELS_PER_TILE
    n_tiles = tile_starts.numel() - 1
    p = torch.arange(px)
    half = (TILE_PX - 1) / 2
    up = (p % TILE_PX).to(dt) - half
    vp = (p // TILE_PX).to(dt) - half
    r = raw.reshape(4, n_tiles, px)
    g = grad_raw.reshape(4, n_tiles, px)
    grad = torch.zeros_like(feat)
    starts = tile_starts.tolist()
    for t in range(n_tiles):
        lo, hi = starts[t], starts[t + 1]
        if lo == hi:
            continue
        ox, oy = float((t % x_tiles) * TILE_PX), float((t // x_tiles) * TILE_PX)
        e = r[0, t] * g[0, t] + r[1, t] * g[1, t] + r[2, t] * g[2, t] + g[3, t] * r[3, t]
        T = torch.ones(px, dtype=dt)
        pg = torch.zeros(px, dtype=dt)
        done = torch.zeros(px, dtype=torch.bool)
        for r0 in range(lo, hi, rnd):
            gid = gaussian_idx[r0:min(r0 + rnd, hi)].long()
            ul = (feat[cc.FEAT_U, gid] - ox) - half
            vl = (feat[cc.FEAT_V, gid] - oy) - half
            op, a, b, c = (feat[k, gid] for k in (cc.FEAT_OPACITY, cc.FEAT_A,
                                                  cc.FEAT_B, cc.FEAT_C))
            rdet = 1.0 / (a * c - b * b)
            col = colour(gid, t)
            # A: per pixel, front to back; q and w staged, zero off the splat
            Q = torch.zeros(len(gid), px, dtype=dt)
            W = torch.zeros(len(gid), px, dtype=dt)
            for jj in range(len(gid)):
                done = done | (T < cc.T_EPS)
                du, dv = up - ul[jj], vp - vl[jj]
                mh = (c[jj] * du * du - 2.0 * b[jj] * du * dv + a[jj] * dv * dv) * rdet[jj]
                alpha = op[jj] * torch.where(mh > 0, torch.exp(-0.5 * mh), torch.zeros_like(mh))
                hit = ~done & (alpha >= cc.ALPHA_SKIP)
                at = alpha.clamp_max(cc.ALPHA_CLAMP)
                w = at * T
                A = g[0, t] * col[0, :, jj] + g[1, t] * col[1, :, jj] + g[2, t] * col[2, :, jj]
                pg = torch.where(hit, pg + A * w, pg)
                q = at * (A * T - (e - pg) / (1.0 - at))
                Q[jj] = torch.where(hit, q, torch.zeros_like(q))
                W[jj] = torch.where(hit, w, torch.zeros_like(w))
                T = torch.where(hit, T * (1.0 - at), T)
            # B: per splat, sums over the tile's pixels
            du = up[None, :] - ul[:, None]
            dv = vp[None, :] - vl[:, None]
            mh = (c[:, None] * du * du - 2.0 * b[:, None] * du * dv
                  + a[:, None] * dv * dv) * rdet[:, None]
            sums = [Q.sum(1), (Q * du).sum(1), (Q * dv).sum(1), (Q * du * du).sum(1),
                    (Q * dv * dv).sum(1), (Q * du * dv).sum(1), (Q * mh).sum(1)]
            rows = torch.cat([_geom_rows(sums, a, b, c, op, rdet),
                              colour_rows(W, g[0:3, t], t).T])
            grad.index_add_(1, gid, rows)
    return grad


def dc_model(feat):
    def colour(gid, t):
        return feat[cc.FEAT_R:cc.FEAT_R + 3, gid][:, None, :].expand(3, cc.PIXELS_PER_TILE, -1)

    def colour_rows(W, gch, t):
        return W @ gch.T  # sum_p w * g_c
    return colour, colour_rows


def sh_model(feat, basis):
    n_sh = basis.shape[0]
    bt = basis.reshape(n_sh, -1, cc.PIXELS_PER_TILE)

    def colour(gid, t):
        coeff = feat[trsh.SH_BASE_ROWS:, gid].reshape(3, n_sh, -1)
        return torch.einsum("ckj,kp->cpj", coeff, bt[:, t])

    def colour_rows(W, gch, t):
        G = (gch[:, None, :] * bt[None, :, t]).reshape(3 * n_sh, -1)  # g_c * b_k
        return W @ G.T
    return colour, colour_rows


def _far_rows():
    """The seeded DC scene plus wide splats centred 100+ px from tiles they
    cover, round ones and thin ones, at depths of their own."""
    rows, grid = _seeded_rows(n=120, width=192, height=128, seed=4)
    # u, v, opacity, sx, sy, rho
    wide = [(-70.0, 60.0, 0.6, 60.0, 55.0, 0.1), (260.0, -40.0, 0.5, 70.0, 40.0, -0.3),
            (96.0, 230.0, 0.7, 80.0, 6.0, 0.97), (-50.0, -50.0, 0.4, 75.0, 5.0, -0.95)]
    extra = [[] for _ in rows]
    for k, (u, v, op, sx, sy, rho) in enumerate(wide):
        vals = [u, v, op, sx * sx, 2 * rho * sx * sy, sy * sy, 0.9, 0.3 - 0.1 * k, 0.5,
                1.0 + 0.003 * k]
        for lst, x in zip(extra, vals):
            lst.append(x)
    rows = [np.concatenate([r, np.asarray(x, np.float32)]) for r, x in zip(rows, extra)]
    return rows, grid


def _dc_inputs(case):
    rows, grid = _fixture_rows() if case == "fixture" else _far_rows()
    rows[2] = np.minimum(rows[2], np.float32(OPACITY_CAP))
    u, v, op, c0, c1, c2, r, g, b, z = [torch.tensor(x) for x in rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    feat = trender.splat_feature_rows(u, v, op, c0, c1, c2, r, g, b)
    return feat, layout, grid


def _sh_inputs(case, n_sh):
    if case == "fixture":
        rows, coeffs, K, pose, grid = _sh_rows(n_sh, opacity_cap=OPACITY_CAP)
        _, _, layout, feat, basis, _ = _sh_port(rows, coeffs, K, pose, grid, np.zeros(3))
        return feat.detach(), basis, layout, grid
    dc_rows, grid = _far_rows()
    dc_rows[2] = np.minimum(dc_rows[2], np.float32(OPACITY_CAP))
    u, v, op, c0, c1, c2, _, _, _, z = [torch.tensor(x) for x in dc_rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    rng = np.random.default_rng(n_sh)
    coeffs = torch.tensor(rng.normal(size=(len(z), 3, n_sh)) * 0.4, dtype=torch.float32)
    feat = trsh.sh_splat_feature_rows(u, v, op, (c0, c1, c2), coeffs)
    basis = torch.tensor(rng.normal(size=(n_sh, grid.tile_count * cc.PIXELS_PER_TILE))
                         * 0.3, dtype=torch.float32)
    return feat, basis, layout, grid


def _cotangent(n_tiles, seed):
    cot = np.random.default_rng(seed).normal(size=(4, n_tiles * cc.PIXELS_PER_TILE))
    return torch.tensor(cot, dtype=torch.float32)


def _check_case(layout, grid, feat, rnd):
    """The inputs reach what the case is for: tiles whose length is not a
    multiple of the round, and (besides the fixture) splats centred FAR_PX
    or more from a tile they cover."""
    counts = layout.tile_counts[layout.tile_counts > 0]
    assert bool((counts % rnd != 0).any()), counts
    tile = torch.repeat_interleave(torch.arange(grid.tile_count), layout.tile_counts.long())
    gid = layout.gaussian_idx.long()
    cx = (tile % grid.x_tiles).double() * TILE_PX + (TILE_PX - 1) / 2
    cy = (tile // grid.x_tiles).double() * TILE_PX + (TILE_PX - 1) / 2
    dist = torch.hypot(feat[cc.FEAT_U, gid].double() - cx, feat[cc.FEAT_V, gid].double() - cy)
    return float(dist.max())


def _assert_staged(fwd, bwd, model, feat, lead, cot):
    """The float32 model against the plain backward ``bwd`` in float32 and
    in float64, each on the raw output of the plain forward ``fwd`` in its
    own precision; ``lead`` are the arguments between feat and raw."""
    raw = fwd(feat, *lead)
    got = model(feat, *lead, raw, cot)
    want32 = bwd(feat, *lead, raw, cot)
    lead64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
              for a in lead]
    feat64 = feat.double()
    want64 = bwd(feat64, *lead64, fwd(feat64, *lead64), cot.double())
    assert np.abs(want64.numpy()).max(axis=1).min() > 0
    err32, err64 = _rel_err(got, want32), _rel_err(got, want64)
    assert (err32 < STAGED_REL_TOL).all(), err32
    assert (err64 < STAGED_REL_TOL).all(), err64


@pytest.mark.parametrize("rnd", [32, 7])
@pytest.mark.parametrize("case", ["fixture", "far"])
def test_staged_b2_matches_plain(case, rnd):
    """B2's rounds: DC colour rows sum_p w g_c, geometry rows from the
    q-weighted moments about each splat's centre."""
    feat, layout, grid = _dc_inputs(case)
    far = _check_case(layout, grid, feat, rnd)
    assert case == "fixture" or far >= FAR_PX, far

    def model(f, gidx, starts, x_tiles, raw, cot):
        return staged_bwd(f, gidx, starts, x_tiles, raw, cot, rnd, *dc_model(f))

    _assert_staged(trender.render_fwd_plain, trender.render_bwd_plain, model, feat,
                   (layout.gaussian_idx, layout.tile_starts, grid.x_tiles),
                   _cotangent(grid.tile_count, seed=rnd))


@pytest.mark.parametrize("n_sh", [4, 9, 16])
@pytest.mark.parametrize("case", ["fixture", "far"])
def test_staged_b4_matches_plain(case, n_sh):
    """B4's rounds: coefficient rows sum_p w g_c b_k as one product per
    round, geometry rows as for B2."""
    feat, basis, layout, grid = _sh_inputs(case, n_sh)
    far = _check_case(layout, grid, feat, 32)
    assert case == "fixture" or far >= FAR_PX, far

    def model(f, b, gidx, starts, x_tiles, raw, cot):
        return staged_bwd(f, gidx, starts, x_tiles, raw, cot, 32, *sh_model(f, b))

    _assert_staged(trsh.render_sh_fwd_plain, trsh.render_sh_bwd_plain, model, feat,
                   (basis, layout.gaussian_idx, layout.tile_starts, grid.x_tiles),
                   _cotangent(grid.tile_count, seed=n_sh))
