"""Scaffold-GS on the port (``gaussian_splatting_torch.scaffold``) against
the plain reference ``tests/torch_scaffold_reference.py``, on the CPU at a
small size: 64 alive anchors in 80 slots, feature width 32, 10 offsets,
64x48 pixels, seeded weights.  The port decodes, renders through the
layout and the plain versions of B1/B2, and trains through
``trainer.train_step``; the reference decodes with the source's boolean
masks, composites every tile densely and differentiates with autograd.

Both run in float32.  They differ by rounding: the port forms the conic
from written-out products and a log-space scale, the reference from 3x3
matrices; the port composites in chunks and differentiates through B2's
hand-written backward, the reference through a dense cumulative product.
Each tolerance below is ~10-50x what these inputs measure.
"""

import ast
import math
from pathlib import Path

import pytest
import torch

from gaussian_splatting_torch import optim, rasterize, scaffold, telemetry, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.structs import Camera, GaussianScene
from tests import torch_scaffold_reference as ref
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

W, H, FOCAL = 64, 48, 60.0
ALIVE, SLOTS = 64, 80
CFG = SplatConfig()
RCFG = dict(width=W, height=H, near=CFG.near_thresh, far=CFG.far_thresh,
            padding=float(CFG.cull_mask_padding), mh_dist=CFG.mh_dist)
BG = torch.tensor([0.1, 0.2, 0.3])

# decoded rows, relative to each field's largest entry: the decode is the
# same arithmetic but for the log-space scale and the quaternion's
# normalisation at use (measured 2.0e-7; all measures over seeds 0-2)
ROW_REL_TOL = 2e-6
# the image, absolute, colour in [0, 1] (measured 4.2e-7)
IMAGE_ATOL = 5e-6
# each leaf's gradient relative to its largest entry: B2's closed form
# against autograd's chain through the cumulative product (measured 4.3e-6)
GRAD_REL_TOL = 1e-4
# a leaf after one Adam step, in units of its rate, beyond what the
# gradients' own gap explains: the first step moves an entry by its rate
# times u = g / (|g| + eps), whose gap is at most |dg| / (|g| + eps), so an
# entry whose gradient is near eps moves by a gradient's rounding over eps
# (up to 2e-3 of the rate here) and is held to that (measured 1.2e-5)
STEP_TOL = 2e-4


def _scene(seed=0):
    """(ScaffoldScene, camera_T_world, K): anchors in front of a camera at
    the origin looking down +z, 8 of them outside its frustum."""
    g = torch.Generator().manual_seed(seed)
    anchor = torch.zeros(SLOTS, 3)
    anchor[:ALIVE, :2] = torch.rand(ALIVE, 2, generator=g) * 2.4 - 1.2
    anchor[:ALIVE, 2] = 3.0 + 2.0 * torch.rand(ALIVE, generator=g)
    anchor[:8, 0] += 40.0  # out of view
    offset = torch.zeros(SLOTS, scaffold.N_OFFSETS, 3)
    offset[:ALIVE] = torch.rand(ALIVE, scaffold.N_OFFSETS, 3, generator=g) * 2 - 1
    feat = torch.zeros(SLOTS, scaffold.FEAT_DIM)
    feat[:ALIVE] = torch.randn(ALIVE, scaffold.FEAT_DIM, generator=g)
    scaling = torch.zeros(SLOTS, 6)
    scaling[:ALIVE] = math.log(0.12) + 0.3 * torch.randn(ALIVE, 6, generator=g)
    alive = torch.zeros(SLOTS, dtype=torch.bool)
    alive[:ALIVE] = True
    mlps = {}
    for name, out in scaffold.HEADS.items():
        b1, b2 = 1 / math.sqrt(scaffold.IN_DIM), 1 / math.sqrt(scaffold.HIDDEN)
        mlps[name] = tuple(
            (torch.rand(*shape, generator=g) * 2 - 1) * b
            for shape, b in (((scaffold.HIDDEN, scaffold.IN_DIM), b1), ((scaffold.HIDDEN,), b1),
                             ((out, scaffold.HIDDEN), b2), ((out,), b2)))
    sc = scaffold.ScaffoldScene(anchor, offset, feat, scaling, alive, mlps=mlps)
    K = torch.tensor([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]])
    pose = torch.eye(4)
    pose[:3, :3] = torch.tensor([[0.995, 0.0, -0.0998], [0.0, 1.0, 0.0], [0.0998, 0.0, 0.995]])
    return sc, pose, K


def _ref_params(sc):
    p = {k: getattr(sc, k).detach().clone() for k in scaffold.ANCHOR_LEAVES}
    for name in scaffold.HEADS:
        m = getattr(sc, name)
        p[name] = [t.detach().clone() for t in (m[0].weight, m[0].bias, m[2].weight, m[2].bias)]
    return p


def _flat(x):
    """A reference leaf as the port packs it."""
    return scaffold.pack_mlp(*x) if isinstance(x, list) else x


def _gt(seed=1):
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(1, 3, 6, 8, generator=g)
    return torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                           align_corners=False)[0].permute(1, 2, 0)


def _kw():
    return dict(near_thresh=CFG.near_thresh, far_thresh=CFG.far_thresh,
                cull_mask_padding=CFG.cull_mask_padding)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_decoded_rows_match_reference():
    sc, pose, K = _scene()
    with torch.no_grad():
        rows = scaffold.decode(sc.params(), sc.anchor, sc.alive, pose, Camera(K, W, H), **_kw())
        want = ref.decode(_ref_params(sc), sc.anchor, sc.alive, pose, K, W, H, RCFG["near"],
                          RCFG["far"], RCFG["padding"])
    # every candidate of the anchors in view is a row; the reference keeps
    # those of opacity > 0, in the same order
    assert rows["opacity"].shape == ((ALIVE - 8) * scaffold.N_OFFSETS,)
    shown = rows["opacity"] > 0
    n = want["opacity"].shape[0]
    assert 0 < n < shown.numel() and int(shown.sum()) == n
    rows = {k: v[shown] for k, v in rows.items()}
    q = rows["quaternion"] / rows["quaternion"].norm(dim=1, keepdim=True)
    pairs = dict(xyz=(rows["xyz"], want["xyz"]), scale=(torch.exp(rows["scale"]), want["scaling"]),
                 rotation=(q, want["rot"]), opacity=(rows["opacity"], want["opacity"]),
                 colour=(rows["rgb"], want["colour"]))
    for name, (got, exp) in pairs.items():
        assert _rel(got, exp) < ROW_REL_TOL, name


def test_image_matches_reference():
    sc, pose, K = _scene()
    with torch.no_grad():
        res, _ = scaffold.render(sc.params(), sc.anchor, sc.alive, pose, Camera(K, W, H),
                                 mh_dist=CFG.mh_dist, background_rgb=BG, **_kw())
        g = ref.decode(_ref_params(sc), sc.anchor, sc.alive, pose, K, W, H, RCFG["near"],
                       RCFG["far"], RCFG["padding"])
        want = ref.render(g, pose, K, W, H, BG, near=RCFG["near"], far=RCFG["far"],
                          padding=RCFG["padding"], mh_dist=RCFG["mh_dist"])
    assert res.num_splats > 0
    assert float((res.image - BG).abs().max()) > 0.1  # the gaussians show
    assert float((res.image - want).abs().max()) < IMAGE_ATOL


def _port_grads(sc, pose, K, gt):
    state = trainer.init_train_state(sc, CFG)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    res, rows = scaffold.render(params, state.anchor, state.alive, pose, Camera(K, W, H),
                                mh_dist=CFG.mh_dist, background_rgb=BG, **_kw())
    loss, _ = trainer.train_loss(res.image, gt, CFG.ssim_frac)
    loss = loss + scaffold.VOLUME_WEIGHT * scaffold.volume(rows)
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def test_every_gradient_matches_reference():
    sc, pose, K = _scene()
    gt = _gt()
    loss, got = _port_grads(sc, pose, K, gt)
    want_loss, want, _ = ref.grads(_ref_params(sc), sc.anchor, sc.alive, pose, K, gt, BG, RCFG)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert set(got) == set(scaffold.LEAVES)
    for k in scaffold.LEAVES:
        w = _flat(want[k])
        assert float(w.abs().max()) > 0, k
        assert _rel(got[k], w) < GRAD_REL_TOL, k
    # anchors out of view and dead slots take no gradient
    for k in scaffold.ANCHOR_LEAVES:
        assert not bool(got[k][:8].any()) and not bool(got[k][ALIVE:].any()), k


def test_one_train_step_matches_reference():
    sc, pose, K = _scene()
    gt = _gt()
    state = trainer.init_train_state(sc, CFG)
    new, info = trainer.train_step(state, gt, K, pose, BG, config=CFG, camera_hw=(H, W),
                                   n_sh_band=0)
    p = _ref_params(sc)
    want_loss, g, _ = ref.grads(p, sc.anchor, sc.alive, pose, K, gt, BG, RCFG)
    zeros = {k: [torch.zeros_like(t) for t in v] if isinstance(v, list) else torch.zeros_like(v)
             for k, v in p.items()}
    want, _, _ = ref.adam_step(p, g, zeros, zeros, 1)
    assert float(info["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    assert int(new.opt_state.count) == 1
    assert torch.equal(new.anchor, state.anchor)
    for k in scaffold.LEAVES:
        _assert_step(new.params[k], _flat(want[k]), new.opt_state.mu[k], _flat(g[k]), k)
        moved = (new.params[k] - state.params[k]).abs().max()
        assert float(moved) == pytest.approx(scaffold.LEARNING_RATES[k], rel=1e-3), k


def _assert_step(p, want, mu, g_want, k):
    """One Adam step's leaf against the reference's, within STEP_TOL of
    the rate beyond the gap its gradient (mu after one step over 1 - B1)
    explains."""
    g = mu / (1 - optim.B1)
    explained = 2 * (g - g_want).abs() / (g_want.abs() + optim.EPS)
    gap = (p - want).abs() / scaffold.LEARNING_RATES[k] - explained
    assert float(gap.max()) < STEP_TOL, k


def test_a_step_with_a_nan_gradient_is_skipped():
    sc, pose, K = _scene()
    state = trainer.init_train_state(sc, CFG)
    gt = _gt().clone()
    gt[0, 0, 0] = float("nan")
    new, _ = trainer.train_step(state, gt, K, pose, BG, config=CFG, camera_hw=(H, W),
                                n_sh_band=0)
    assert int(new.opt_state.count) == 0
    for k in scaffold.LEAVES:
        assert torch.equal(new.params[k], state.params[k]), k


def test_decode_counts_its_anchors_rows_and_read():
    sc, pose, K = _scene()
    with torch.no_grad(), telemetry.recording():
        rows = scaffold.decode(sc.params(), sc.anchor, sc.alive, pose, Camera(K, W, H), **_kw())
    c = telemetry.window()["counters"]
    assert c["anchors"] == ALIVE - 8
    assert c["neural"] == rows["opacity"].shape[0] == (ALIVE - 8) * scaffold.N_OFFSETS
    assert {k: v for k, v in c.items() if k.startswith("sync.decode")} == \
        {"sync.decode.anchors": 1}
    assert "decode_us" not in c  # device time is a card's


def test_scaffold_leaves_take_their_rates_in_one_adam_call(monkeypatch):
    sc, pose, K = _scene()
    state = trainer.init_train_state(sc, CFG)
    monkeypatch.setitem(scaffold.LEARNING_RATES, "offset", 0.5)
    calls = []
    plain = optim.adam_step_plain

    def counted(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(optim, "adam_step_plain", counted)
    new, _ = trainer.train_step(state, _gt(), K, pose, BG, config=CFG, camera_hw=(H, W),
                                n_sh_band=0)
    assert len(calls) == 1 and len(calls[0][0]) == len(scaffold.LEAVES) <= optim.ADAM_MAX_LEAVES
    moved = (new.params["offset"] - state.params["offset"]).abs().max()
    assert float(moved) == pytest.approx(0.5, rel=1e-3)
    with pytest.raises(ValueError, match="n_sh_band"):
        trainer.train_step(state, _gt(), K, pose, BG, config=CFG, camera_hw=(H, W), n_sh_band=1)


def _vanilla_before(params, alive, pose, cam, bg, n_sh_band):
    """``rasterize.rasterize`` as it was written before the decoded rows'
    entry shared its geometry and raster steps: the same public steps, in
    the same order, inlined."""
    from gaussian_splatting_torch import geometry as geo
    from gaussian_splatting_torch.culling import build_layout, frustum_visible_rows
    from gaussian_splatting_torch.ops import geometry as og
    from gaussian_splatting_torch.ops.reference_impl import tiles_to_image
    from gaussian_splatting_torch.ops.render import render_tiles
    from gaussian_splatting_torch.structs import TileGrid

    grid = TileGrid(cam.height, cam.width)
    xyzT = params["xyz"].T
    xc, yc, zc = geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], pose)
    u, v = geo.project_rows(xc, yc, zc, cam.K)
    sig6 = geo.sigma_world_rows(params["quaternion"], params["scale"])
    conic3 = geo.conic_rows(sig6, xc, yc, zc, cam.K, pose)
    opacity_v = torch.sigmoid(params["opacity"][:, 0])
    visible = frustum_visible_rows(u, v, zc, (cam.width, cam.height), CFG.near_thresh,
                                   CFG.far_thresh, CFG.cull_mask_padding) & alive
    with torch.no_grad():
        layout = build_layout(u, v, conic3, zc, visible, grid, CFG.mh_dist, opacity=opacity_v)
    feat, _ = og.splat_features(params, u, v, conic3, opacity_v, pose, n_sh_band, True)
    img_tiles, T = render_tiles(feat, layout, bg, grid.x_tiles)
    return tiles_to_image(img_tiles, grid), T, visible, torch.stack([u, v], dim=1)


@pytest.mark.parametrize("n_sh_band", [0, 3])
def test_vanilla_rasterize_is_bit_identical_to_before(n_sh_band):
    g = torch.Generator().manual_seed(3)
    n = 300
    xyz = torch.rand(n, 3, generator=g) * 2.4 - 1.2
    xyz[:, 2] += 4.0
    gs = GaussianScene.create(
        xyz, torch.rand(n, 3, generator=g), torch.randn(n, 1, generator=g),
        math.log(0.08) + 0.3 * torch.randn(n, 3, generator=g), torch.randn(n, 4, generator=g),
        0.1 * torch.randn(n, 3, 15, generator=g), capacity=320, device="cpu")
    params = {k: v.detach().requires_grad_(True) for k, v in gs.params().items()}
    _, pose, K = _scene()
    cam = Camera(K, W, H)
    res = rasterize.rasterize(params, gs.alive, pose, cam, near_thresh=CFG.near_thresh,
                              far_thresh=CFG.far_thresh, cull_mask_padding=CFG.cull_mask_padding,
                              mh_dist=CFG.mh_dist, background_rgb=BG, n_sh_band=n_sh_band)
    img, T, visible, uv = _vanilla_before(params, gs.alive, pose, cam, BG, n_sh_band)
    assert torch.equal(res.image, img) and torch.equal(res.transmittance, T)
    assert torch.equal(res.visible, visible) and torch.equal(res.uv, uv)
    got = torch.autograd.grad(res.image.square().sum(), list(params.values()), allow_unused=True)
    want = torch.autograd.grad(img.square().sum(), list(params.values()), allow_unused=True)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_rows_entry_checks_its_rows():
    rows = dict(xyz=torch.zeros(4, 3), scale=torch.zeros(4, 3), quaternion=torch.zeros(4, 4),
                rgb=torch.zeros(4, 3), opacity=torch.zeros(4, 1))
    _, pose, K = _scene()
    with pytest.raises(ValueError, match="opacity"):
        rasterize.kernel_inputs(rows, None, pose, Camera(K, W, H), mh_dist=CFG.mh_dist,
                                **_kw())


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_neither_package_nor_jax():
    found = set(_imports(ref.__file__))
    assert found, "no import read"
    bad = {m for m in found
           if m.split(".")[0] in ("jax", "jaxlib", "gaussian_splatting_tpu",
                                  "gaussian_splatting_torch")}
    assert not bad, bad


# on the card: one step through the kernels against the same step on the CPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.card
def test_card_step_runs_the_kernels_once_and_matches_the_cpu(card):
    from gaussian_splatting_torch import _build

    sc, pose, K = _scene()
    gt = _gt()
    cpu_new, _ = trainer.train_step(trainer.init_train_state(sc, CFG), gt, K, pose, BG,
                                    config=CFG, camera_hw=(H, W), n_sh_band=0)
    state = trainer.init_train_state(sc.to(card), CFG)
    telemetry.LAUNCHES.clear()
    new, _ = trainer.train_step(state, gt.to(card), K.to(card), pose.to(card), BG.to(card),
                                config=CFG, camera_hw=(H, W), n_sh_band=0)
    torch.cuda.synchronize(card)
    launches = dict(telemetry.LAUNCHES)
    assert launches == {"geometry_fwd": 1, "layout_count": 1, "layout_fill": 1,
                        "render_fwd": 1, "render_bwd": 1, "geometry_bwd": 1,
                        "adam_step": 1}, launches
    assert _build.library() is not None
    for k in scaffold.LEAVES:
        _assert_step(new.params[k].cpu(), cpu_new.params[k], new.opt_state.mu[k].cpu(),
                     cpu_new.opt_state.mu[k] / (1 - optim.B1), k)
