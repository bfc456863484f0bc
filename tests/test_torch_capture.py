"""A COLMAP capture written by ``chip_smoke.write_capture`` (the "[capture]"
phase's writer) at fixture size, read and trained by both packages on the
CPU: the datasets equal (the JAX side decodes with cv2, the port with its
own PNG decoder, cv2 and Pillow hidden); the runners' recorded schedules
equal on the per-pixel SH path; and a real run of each, the JAX side
jitted at ``kernel_precision="f32"``, through an SH band step, with every
step of the JAX run reproduced by the port's ``train_step``."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_splatting_torch import convert
from gaussian_splatting_torch import runner as trunner
from gaussian_splatting_torch import trainer as ttrainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio import colmap as tcolmap
from gaussian_splatting_torch.dataio import dataset as tds
from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data
from gaussian_splatting_torch.losses import _SIZE as SSIM_SIZE
from gaussian_splatting_tpu import runner as jrunner
from gaussian_splatting_tpu import trainer as jtrainer
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.dataio import dataset as jds
from tests.test_torch_runner import Recorder, _record_jax, _record_port
from tests.test_torch_trainer import (
    LOSS_RTOL,
    MOMENT_REL_TOL,
    UV_REL_TOL,
    XYZ_REL_TOL,
    _np,
    _rel,
)

# 12 views of 97x61 (odd, not a multiple of the 16-pixel tile), 2,000 secret
# points, 300 of them as the SfM points; focal 82 keeps the capture's field
# of view (1100 at 1297 pixels)
VIEWS, SECRET, SFM, W, H, FOCAL = 12, 2000, 300, 97, 61, 82.0
DOWNSAMPLE = chip_smoke.CAPTURE_DOWNSAMPLE
# the recorded schedule: SH bands at 3, 6, 9, ADC at 4 and 8, a reset at 6,
# evals at 0, 5, 10 and the end, debug images and checkpoints at 5, 10
SCHEDULE = dict(
    num_iters=12, test_eval_interval=5, print_interval=4, adaptive_control_start=2,
    adaptive_control_interval=4, adaptive_control_end=10, reset_opacity_start=5,
    reset_opacity_interval=6, reset_opacity_end=11, save_debug_image_interval=5,
    checkpoint_interval=5, add_sh_band_interval=3, use_background_end=9,
    test_split_ratio=4, seed=2, use_sh_precompute=False,
)
# The alpha skip (ops/common.py: a splat whose alpha at a pixel is below
# ALPHA_SKIP is skipped there) makes the render jump when an alpha crosses
# it, and the packages' alphas differ by float32 rounding (~1e-6 relative:
# JAX forms the conic from pixel moments).  A step's comparison leaves out
# the gaussians composited within SSIM's window of a pixel where some alpha
# lies within SKIP_EDGE of ALPHA_SKIP: on this capture, in one step, a
# sub-pixel gaussian at 6e-6 relative (its y-gradient differs by 16%) and
# its neighbours, whose gradients that pixel's SSIM terms move by 1e-3 of
# the leaf's largest.
SKIP_EDGE = 1e-4
# A step's parameters at tests/test_torch_runner.py's tolerance (1e-5, its
# ground truth's).  Adam divides each gradient component by its own
# magnitude, so a parameter's rounding follows its gradient's rounding
# relative to that component, not to the leaf: tests/test_torch_trainer.py's
# 2e-6 (1e-4 of opacity's step, on a 6-gaussian fixture) is exceeded here by
# one opacity of 300 (3.7e-6, 1.9e-4 of its 0.02 step) whose gradients agree
# to 1e-6 of the leaf's largest.  Moments and accumulators are held at the
# trainer test's tolerances, relative to each leaf's largest entry.
PARAM_ATOL = 1e-5
# the real runs: 4 iterations, the last at SH band 1 (per-pixel, B3/B4's
# plain versions), evals at 0 and the end, no event
RUN = dict(num_iters=4, add_sh_band_interval=3, test_eval_interval=100,
           adaptive_control_start=100, reset_opacity_start=100, checkpoint_interval=0,
           save_debug_image_interval=0, test_split_ratio=4, seed=1, use_sh_precompute=False)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capture"))
    cap = chip_smoke.write_capture(root, VIEWS, SFM, W, H, focal=FOCAL,
                                   secret_points=SECRET, device="cpu")
    return root, cap


def _hide_image_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_both_packages_read_the_capture(capture, monkeypatch):
    """K, poses, points, colours and every image (bitwise) equal between
    the packages' ColmapDatasets, and equal to what the writer meant: the
    intrinsics at 1/4 scale, the ring's poses through their quaternions,
    the seeded subset of the secret points and their colours."""
    root, _ = capture
    want = jds.ColmapDataset(root, DOWNSAMPLE)
    jdata = want.scene_data()
    jimages = [jdata.load_image(i) for i in range(VIEWS)]
    _hide_image_packages(monkeypatch)
    got = tds.ColmapDataset(root, DOWNSAMPLE)
    data = got.scene_data()
    assert tcolmap.last_reader == "native"

    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    secret = make_synthetic_scene_data(SECRET, VIEWS, 0, W, H)
    sel = np.sort(np.random.default_rng(0).choice(SECRET, SFM, replace=False))
    np.testing.assert_array_equal(got.xyz, secret.xyz[sel])
    np.testing.assert_array_equal(got.rgb, secret.rgb[sel])
    assert got.cameras.keys() == want.cameras.keys() == {1}
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(got.cameras[1].K, want.cameras[1].K)
    np.testing.assert_array_equal(got.cameras[1].K, K)
    assert (got.cameras[1].width, got.cameras[1].height) == (W, H)
    assert (want.cameras[1].width, want.cameras[1].height) == (W, H)
    assert len(got.images) == len(want.images) == VIEWS
    for i, (a, b) in enumerate(zip(got.images, want.images)):
        assert (a.path, a.camera_id) == (b.path, b.camera_id)
        np.testing.assert_array_equal(a.camera_T_world, b.camera_T_world)
        np.testing.assert_allclose(a.camera_T_world, secret.images[i].camera_T_world,
                                   atol=2e-6)
        img = data.load_image(i)
        assert tds.last_decoder == "png"
        assert img.shape == (H, W, 3) and img.mean() > 5
        np.testing.assert_array_equal(img, jimages[i])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_to_qvec_inverts_qvec_to_rotation(seed):
    """The writer's quaternion of a rotation gives the rotation back,
    whichever diagonal entry is largest."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tcolmap.qvec_to_rotation(q)
        got = chip_smoke.rotation_to_qvec(R)
        np.testing.assert_allclose(got, q * np.sign(q[0]), atol=1e-12)
        np.testing.assert_allclose(tcolmap.qvec_to_rotation(got), R, atol=1e-12)


def test_recorded_schedule_matches_jax_runner(capture, tmp_path, monkeypatch):
    """On the capture, with use_sh_precompute=False, the runners take the
    same steps (view, SH band, background), evals, ADC events, resets,
    debug images and checkpoints, and stage the same uint8 ground truth."""
    root, _ = capture
    kw = dict(SCHEDULE, output_dir=str(tmp_path), dataset_path=root,
              downsample_factor=DOWNSAMPLE)
    jdata = jds.ColmapDataset(root, DOWNSAMPLE).scene_data()
    jrec = Recorder(jdata)
    _record_jax(monkeypatch, jrec, tmp_path)
    jr = jrunner.TrainingRunner(jdata, JConfig(**kw))
    jr.train()

    _hide_image_packages(monkeypatch)
    data = tds.ColmapDataset(root, DOWNSAMPLE).scene_data()
    trec = Recorder(data)
    _record_port(monkeypatch, trec)
    tr = trunner.TrainingRunner(data, SplatConfig(**kw), device="cpu")
    tr.train()

    assert trec.events == jrec.events
    assert {e[0] for e in jrec.events} == {"step", "eval", "adc", "reset", "png", "ckpt", "ply"}
    assert {e[3] for e in jrec.events if e[0] == "step"} == {0, 1, 2, 3}  # SH bands
    assert tr.metrics.to_dict() == jr.metrics.to_dict()
    assert tr._gt_dev.keys() == jr._gt_dev.keys()
    for idx in tr._gt_dev:
        np.testing.assert_array_equal(tr.gt_image_dev(idx).numpy(),
                                      np.asarray(jr.gt_image_dev(idx)))
    assert tds.last_decoder == "png"


def test_runs_match_jax_runner(capture, tmp_path, monkeypatch):
    """4 real iterations of each runner on the capture, the last at SH band 1
    on the per-pixel path.  The runs' train and test PSNRs agree at
    LOSS_RTOL.  Each of the JAX run's steps, its input state carried into
    the port, gives the port's train_step the same loss and the same state
    (parameters at PARAM_ATOL, the rest at the trainer test's tolerances)
    for every gaussian away from the alpha skip's edge.  The runs' final
    states are not compared: the edge's jump in one step moves a gaussian
    by a whole Adam step (2.4e-4 of an xyz, whose step is 2e-4), and the
    runs then diverge by it."""
    root, _ = capture
    kw = dict(RUN, dataset_path=root, downsample_factor=DOWNSAMPLE)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    os.makedirs(jout)
    jcfg = JConfig(**kw, output_dir=str(jout), kernel_precision="f32", steps_per_dispatch=1,
                   splat_capacity=1 << 14, chunk=256)
    steps = []
    jstep = jtrainer.train_step

    def recorded(state, gt, K, pose, bg, **kwargs):
        inputs = [_np(x) for x in (state, gt, K, pose, bg)]  # the step donates state
        out, info = jstep(state, gt, K, pose, bg, **kwargs)
        steps.append(inputs + [_np(out), kwargs["n_sh_band"], _np(info)])
        return out, info

    monkeypatch.setattr(jtrainer, "train_step", recorded)
    jr = jrunner.TrainingRunner(jds.ColmapDataset(root, DOWNSAMPLE).scene_data(), jcfg)
    jr.train()

    _hide_image_packages(monkeypatch)
    os.makedirs(tout)
    data = tds.ColmapDataset(root, DOWNSAMPLE).scene_data()
    tr = trunner.TrainingRunner(data, SplatConfig(**kw, output_dir=str(tout)), device="cpu")
    tr.train()
    jm, tm = jr.metrics.to_dict(), tr.metrics.to_dict()
    assert tm["eval_iters"] == jm["eval_iters"] == [0, 4]
    assert tm["num_gaussians"] == jm["num_gaussians"] == [SFM] * 4
    np.testing.assert_allclose(tm["train_psnr"], jm["train_psnr"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["test_psnr"], jm["test_psnr"], rtol=LOSS_RTOL)
    assert tr.state.alive.shape[0] == jr.state.alive.shape[0] == 4096

    assert [s[6] for s in steps] == [0, 0, 0, 1]
    left_out = []
    for state, gt, K, pose, bg, want, band, info in steps:
        got, tinfo = ttrainer.train_step(
            convert.train_state_from_numpy(state, "cpu"), torch.tensor(gt),
            torch.tensor(K), torch.tensor(pose), torch.tensor(bg), config=tr.config,
            camera_hw=(H, W), n_sh_band=band)
        np.testing.assert_allclose(float(tinfo["loss"]), info["loss"], rtol=LOSS_RTOL)
        edge = _at_skip_edge(state, K, pose, band)
        left_out.append(int(edge.sum()))
        keep = ~edge
        g = convert.train_state_to_numpy(got)
        for k, w in want.params.items():
            np.testing.assert_allclose(g.params[k][keep], w[keep], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
        np.testing.assert_array_equal(g.alive, want.alive)
        ja, ta = want.opt_state[0], g.opt_state[0]
        for k in ja.mu:
            assert _rel(ta.mu[k][keep], ja.mu[k][keep]) < MOMENT_REL_TOL, ("mu", k)
            assert _rel(ta.nu[k][keep], ja.nu[k][keep]) < MOMENT_REL_TOL, ("nu", k)
        assert _rel(g.uv_grad_accum[keep], want.uv_grad_accum[keep]) < UV_REL_TOL
        assert _rel(g.xyz_grad_accum[keep], want.xyz_grad_accum[keep]) < XYZ_REL_TOL
        np.testing.assert_array_equal(g.grad_accum_count, want.grad_accum_count)
    print(f"gaussians left out at the alpha skip's edge, a step: {left_out}")
    assert max(left_out) < SFM // 10
    assert float(got.opt_state.mu["sh"].abs().max()) > 0  # the band-1 step


def _at_skip_edge(state, K, pose, band):
    """The slots of ``state`` composited, in the W x H view at ``pose``,
    within SSIM's window of a pixel where some gaussian's alpha lies within
    SKIP_EDGE (relative) of ALPHA_SKIP: that gaussian's inclusion there
    changes the pixel, hence the loss's cotangent over the window, hence
    every such slot's gradient."""
    from gaussian_splatting_torch.ops import common as cc
    from gaussian_splatting_torch.rasterize import kernel_inputs
    from gaussian_splatting_torch.structs import Camera

    cfg = SplatConfig(**RUN)
    ki = kernel_inputs({k: torch.tensor(v) for k, v in state.params.items()},
                       torch.tensor(state.alive), torch.tensor(pose),
                       Camera(K=torch.tensor(K), width=W, height=H),
                       near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                       cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist,
                       n_sh_band=band, use_sh_precompute=False)
    slots = torch.nonzero(ki.visible).flatten()
    u, v, op, a, b, c = (ki.feat[r][slots][:, None, None] for r in range(6))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    du, dv = xs - u, ys - v
    mh = (c * du * du - 2.0 * b * du * dv + a * dv * dv) / (a * c - b * b)
    alpha = op * torch.exp(-0.5 * mh)
    pixels = ((alpha / cc.ALPHA_SKIP - 1).abs() < SKIP_EDGE).any(0).float()
    # SSIM's 11-pixel window carries a pixel's change to its neighbours' cotangents
    r = SSIM_SIZE // 2
    pixels = torch.nn.functional.max_pool2d(pixels[None, None], 2 * r + 1, 1, r)[0, 0] > 0
    there = ((alpha >= cc.ALPHA_SKIP * (1 - SKIP_EDGE)) & pixels).flatten(1).any(1)
    edge = np.zeros(state.alive.shape[0], bool)
    edge[slots[there].numpy()] = True
    return edge
