"""The plain reference and the yardstick against the program, on a small
scene on the CPU (the program's plain versions of its kernels)."""

import pytest
import torch

from gsbench import scene, spec, work
from gsbench.reference import splat as ref

NAMES = ("garden7k-sh3-precompute", "garden7k-sh3-perpixel")


def _fixture(name, seed=3):
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    cfg.update(capacity=2048, width=64, height=48, focal=60.0)
    s = scene.load(cfg, 1500, seed, torch.device("cpu"))
    K = scene.intrinsics(cfg, torch.device("cpu"))
    pose = scene.ring_poses(s, 8)[1]
    bg = torch.tensor([0.1, 0.2, 0.3])
    params = dict(s["params"])
    params["sh"] = 0.1 * torch.randn(params["sh"].shape, generator=torch.Generator().manual_seed(1))
    return cfg, params, s["alive"], K, pose, bg


def _program(cfg, params, alive, K, pose, bg):
    from gaussian_splatting_torch.rasterize import rasterize
    from gaussian_splatting_torch.structs import Camera

    s = cfg["splat"]
    return rasterize(params, alive, pose, Camera(K, cfg["width"], cfg["height"]),
                     near_thresh=s["near_thresh"], far_thresh=s["far_thresh"],
                     cull_mask_padding=s["cull_mask_padding"], mh_dist=s["mh_dist"],
                     background_rgb=bg, n_sh_band=cfg["n_sh_band"],
                     use_sh_precompute=s["use_sh_precompute"])


@pytest.mark.parametrize("name", NAMES)
def test_reference_render_agrees_with_the_program(name):
    cfg, params, alive, K, pose, bg = _fixture(name)
    with torch.no_grad():
        got = _program(cfg, params, alive, K, pose, bg)
    img, T, lay = ref.render(params, alive, scene.view(cfg, K, pose, bg))
    assert lay.num_splats == got.num_splats > 0
    assert float((img - got.image).abs().max()) < 1e-5
    assert float((T - got.transmittance).abs().max()) < 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_reference_gradients_agree_with_the_program(name):
    from gaussian_splatting_torch.losses import train_loss

    cfg, params, alive, K, pose, bg = _fixture(name)
    gt = torch.rand(cfg["height"], cfg["width"], 3, generator=torch.Generator().manual_seed(2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = train_loss(_program(cfg, leaves, alive, K, pose, bg).image, gt, 0.2)[0]
    loss.backward()
    r_loss, r_grads, _, _, _ = ref.grads(params, alive, scene.view(cfg, K, pose, bg), gt,
                                         group_pairs=1 << 16)
    loss = loss.detach()
    assert abs(float(loss) - float(r_loss)) <= 1e-6 * float(r_loss)
    for k in ref.LEAVES:
        g, r = leaves[k].grad, r_grads[k]
        scale = float(r.abs().max())
        assert scale > 0, k
        assert float((g - r).abs().max()) <= 1e-4 * scale, k


def test_pair_counts_equal_the_programs():
    from gaussian_splatting_torch.ops.render import dc_work
    from gaussian_splatting_torch.rasterize import kernel_inputs
    from gaussian_splatting_torch.structs import Camera

    cfg, params, alive, K, pose, bg = _fixture(NAMES[0])
    s = cfg["splat"]
    with torch.no_grad():
        k = kernel_inputs(params, alive, pose, Camera(K, cfg["width"], cfg["height"]),
                          near_thresh=s["near_thresh"], far_thresh=s["far_thresh"],
                          cull_mask_padding=s["cull_mask_padding"], mh_dist=s["mh_dist"],
                          n_sh_band=cfg["n_sh_band"])
    want = dc_work(k.feat, k.layout.gaussian_idx, k.layout.tile_starts, k.grid.x_tiles)
    got = work.pair_counts(params, alive, scene.view(cfg, K, pose, bg))
    for key in ("evaluated", "composited", "evaluated_bwd", "composited_bwd"):
        assert got[key] == want[key], key
    assert got["splats"] == k.layout.num_splats
    kw = work.kernel_work(got)
    assert kw["render_fwd"] == want["render_fwd"]
    assert kw["render_bwd"] == want["render_bwd"]


def test_bounds_and_mfu_are_shares_of_the_peaks():
    c = dict(evaluated=10**9, composited=10**8, evaluated_bwd=10**9, composited_bwd=10**8,
             splats=3 * 10**6, tiles=4293, slots=2**21, alive=1_500_000, n_sh=16)
    kw = work.kernel_work(c)
    assert work.bound_s(*kw["render_fwd"]) == kw["render_fwd"][1] / work.PEAK_F32_PER_S
    assert work.step_ops(c, train=True, per_pixel=False) > work.step_ops(
        c, train=False, per_pixel=False) > kw["render_fwd"][1]
