"""The milestone of the training slice: one JAX ``TrainState``, carried into
the port with ``convert.train_state_from_numpy``, goes through the same
``train_step``s in both packages, and loss, PSNR, every parameter, the Adam
state and the densification accumulators agree.

The JAX step runs jitted with its Pallas kernels in interpret mode at
``kernel_precision="f32"`` (the default, "bf16", is the TPU's production
mode and is not what the port computes).  The port's step runs the plain
versions of B1 and B2 on the CPU.

Below T_EPS the port's forward stops multiplying T where the JAX forward
keeps going.  With the training loss that difference never reaches a
gradient: the loss does not read T (its cotangent g_T is 0), and the
background is blended with weight 0 where T <= BG_T_EPS = 1e-3 > T_EPS.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import trainer as jt
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.rasterize import rasterize as jrasterize
from gaussian_splatting_torch import convert, trainer
from gaussian_splatting_torch.config import SplatConfig
from tests import fixtures as fx
from tests.test_render_grads import _small_camera

JCFG = JConfig(splat_capacity=1 << 17, chunk=256, kernel_precision="f32")
CFG = SplatConfig()
HW = (480, 640)
# the per-pixel SH path (kernels B3/B4), at the 64x48 camera
SH_JCFG = JConfig(splat_capacity=1 << 17, chunk=256, kernel_precision="f32",
                  use_sh_precompute=False)
SH_CFG = SplatConfig(use_sh_precompute=False)
SMALL_HW = (48, 64)
SH_BAND = 3

# Tolerances, after 1 and after 3 steps, each ~5-20x what these inputs
# measure.  The two packages differ only by float32 rounding: summation
# order in the backward and the losses, and the conic rows JAX forms from
# pixel moments (test_torch_render_bwd.py).  Adam divides each gradient by
# its own running magnitude, so a parameter moves by up to base_lr *
# multiplier per step whatever the gradient's size, and the rounding
# reaches the parameters only at that scale.
LOSS_RTOL = 3e-5  # loss and PSNR (measured 3.4e-6): means over 1e6 pixels
PARAM_ATOL = 2e-6  # 1e-4 of opacity's step 0.002 * 10 (measured 1.2e-7)
# moments and accumulators relative to each leaf's largest entry
MOMENT_REL_TOL = 1e-4  # measured 1.6e-5
# accumulated |dL/du| is a sum of signed per-pixel terms that mostly
# cancel, so its rounding is larger against the sum (measured 5.6e-5)
UV_REL_TOL = 5e-4
XYZ_REL_TOL = 1e-4  # measured 1.4e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else np.abs(got).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _make_setup(cam):
    """The fixture scene with dead slots, a uint8 target rendered from it
    by ``cam``, and a perturbed starting state (colour, opacity, SH bands
    1-3)."""
    scene = fx.test_scene(opacity_presigmoid=True, capacity=16)
    pose = fx.test_camera_T_world()
    image = jax.jit(lambda params: jrasterize(
        params, scene.alive, pose, cam, near_thresh=JCFG.near_thresh,
        far_thresh=JCFG.far_thresh, cull_mask_padding=JCFG.cull_mask_padding,
        mh_dist=JCFG.mh_dist, background_rgb=jnp.zeros(3, jnp.float32),
        n_sh_band=0, splat_capacity=JCFG.splat_capacity, chunk=JCFG.chunk,
        kernel_precision="f32",
    ).image)(scene.params())
    gt = np.round(np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    state = _np(jt.init_train_state(scene, JCFG))
    rng = np.random.default_rng(0)
    p = dict(state.params)
    p["rgb"] = p["rgb"] * np.float32(0.6)
    p["opacity"] = np.full_like(p["opacity"], np.log(0.7 / 0.3))
    p["sh"] = (0.2 * rng.normal(size=p["sh"].shape)).astype(np.float32)
    backgrounds = rng.uniform(0, 1, (3, 3)).astype(np.float32)
    return (state._replace(params=p), gt, np.asarray(cam.K),
            np.asarray(pose), backgrounds)


@pytest.fixture(scope="module")
def setup():
    return _make_setup(fx.test_camera())


@pytest.fixture(scope="module")
def small_setup():
    """The same at 64x48, for the per-pixel SH path."""
    return _make_setup(_small_camera())


def _jax_step(state, gt, K, pose, bg, config=JCFG, hw=HW):
    s, info = jt.train_step(
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(gt),
        jnp.asarray(K), jnp.asarray(pose), jnp.asarray(bg), config=config,
        camera_hw=hw, n_sh_band=SH_BAND, use_background=True,
    )
    return _np(s), _np(info)


def _port_step(state, gt, K, pose, bg, config=CFG, hw=HW):
    return trainer.train_step(
        state, torch.tensor(gt), torch.tensor(K), torch.tensor(pose),
        torch.tensor(bg), config=config, camera_hw=hw, n_sh_band=SH_BAND)


def _assert_states_agree(got, want):
    got = convert.train_state_to_numpy(got)
    for k, w in want.params.items():
        np.testing.assert_allclose(got.params[k], w, rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_array_equal(got.alive, want.alive)
    ja, ta = want.opt_state[0], got.opt_state[0]
    assert int(ta.count) == int(ja.count)
    for k in ja.mu:
        assert _rel(ta.mu[k], ja.mu[k]) < MOMENT_REL_TOL, ("mu", k)
        assert _rel(ta.nu[k], ja.nu[k]) < MOMENT_REL_TOL, ("nu", k)
    assert _rel(got.uv_grad_accum, want.uv_grad_accum) < UV_REL_TOL
    assert _rel(got.xyz_grad_accum, want.xyz_grad_accum) < XYZ_REL_TOL
    np.testing.assert_array_equal(got.grad_accum_count, want.grad_accum_count)


def test_state_round_trip(setup):
    state = setup[0]
    back = convert.train_state_to_numpy(convert.train_state_from_numpy(state, "cpu"))
    for k in state.params:
        np.testing.assert_array_equal(back.params[k], state.params[k])
    a, b = back.opt_state[0], state.opt_state[0]
    assert int(a.count) == int(b.count) == 0
    for k in b.mu:
        np.testing.assert_array_equal(a.mu[k], b.mu[k])
        np.testing.assert_array_equal(a.nu[k], b.nu[k])
    for f in ("alive", "uv_grad_accum", "xyz_grad_accum", "grad_accum_count"):
        np.testing.assert_array_equal(getattr(back, f), getattr(state, f))


def test_init_train_state_matches_jax():
    scene = fx.test_scene(opacity_presigmoid=True, capacity=16)
    want = _np(jt.init_train_state(scene, JCFG))
    params, alive = {k: np.asarray(v) for k, v in scene.params().items()}, np.asarray(scene.alive)
    from gaussian_splatting_torch.convert import scene_from_numpy

    got = convert.train_state_to_numpy(
        trainer.init_train_state(scene_from_numpy(params, alive, "cpu"), CFG))
    for k in want.params:
        np.testing.assert_array_equal(got.params[k], want.params[k])
        np.testing.assert_array_equal(got.opt_state[0].mu[k], want.opt_state[0].mu[k])
    assert int(got.opt_state[0].count) == int(want.opt_state[0].count) == 0
    for f in ("alive", "uv_grad_accum", "xyz_grad_accum", "grad_accum_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype


def test_train_steps_match_jax(setup):
    """1 and then 3 steps on a uint8 target with nonzero backgrounds, then
    a step on a NaN background: its loss and gradients are not finite, and
    both packages skip it and leave the state as it was."""
    jstate, gt, K, pose, backgrounds = setup
    tstate = convert.train_state_from_numpy(jstate, "cpu")
    for i, bg in enumerate(backgrounds):
        jstate, jinfo = _jax_step(jstate, gt, K, pose, bg)
        tstate, tinfo = _port_step(tstate, gt, K, pose, bg)
        np.testing.assert_allclose(float(tinfo["loss"]), jinfo["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tinfo["psnr"]), jinfo["psnr"], rtol=LOSS_RTOL)
        assert tinfo["num_visible"] == int(jinfo["num_visible"]) == 3
        assert tinfo["truncated"] == int(jinfo["truncated"]) == 0
        assert int(tinfo["n_alive"]) == int(jinfo["n_alive"]) == 6
        assert tinfo["num_splats"] > 0
        if i in (0, 2):
            _assert_states_agree(tstate, jstate)
    np.testing.assert_array_equal(jstate.grad_accum_count[:6], [0, 3, 0, 3, 3, 3])

    nan_bg = np.array([np.nan, 0.0, 0.0], np.float32)
    jskip, jinfo = _jax_step(jstate, gt, K, pose, nan_bg)
    tskip, tinfo = _port_step(tstate, gt, K, pose, nan_bg)
    assert np.isnan(jinfo["loss"]) and np.isnan(float(tinfo["loss"]))
    before = convert.train_state_to_numpy(tstate)
    after = convert.train_state_to_numpy(tskip)
    for a, b in zip(jax.tree_util.tree_leaves(after), jax.tree_util.tree_leaves(before)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(jskip), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(a, b)


def test_eval_step_matches_jax(setup):
    jstate, gt, K, pose, _ = setup
    jimg, jpsnr, jssim, overflow = jt.eval_step(
        jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(gt), jnp.asarray(K),
        jnp.asarray(pose), config=JCFG, camera_hw=HW, n_sh_band=SH_BAND)
    assert not bool(overflow)
    img, psnr, ssim = trainer.eval_step(
        convert.train_state_from_numpy(jstate, "cpu"), torch.tensor(gt), torch.tensor(K),
        torch.tensor(pose), config=CFG, camera_hw=HW, n_sh_band=SH_BAND)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    np.testing.assert_allclose([float(psnr), float(ssim)], [float(jpsnr), float(jssim)],
                               rtol=LOSS_RTOL)


def test_per_pixel_sh_train_steps_match_jax(small_setup):
    """1 and then 3 steps with use_sh_precompute=False (B3/B4's plain
    versions) at SH band 3 against the JAX per-pixel SH train_step: loss,
    PSNR, every parameter, the Adam state and the accumulators."""
    jstate, gt, K, pose, backgrounds = small_setup
    tstate = convert.train_state_from_numpy(jstate, "cpu")
    for i, bg in enumerate(backgrounds):
        jstate, jinfo = _jax_step(jstate, gt, K, pose, bg, SH_JCFG, SMALL_HW)
        tstate, tinfo = _port_step(tstate, gt, K, pose, bg, SH_CFG, SMALL_HW)
        np.testing.assert_allclose(float(tinfo["loss"]), jinfo["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tinfo["psnr"]), jinfo["psnr"], rtol=LOSS_RTOL)
        assert tinfo["num_visible"] == int(jinfo["num_visible"]) > 0
        if i in (0, 2):
            _assert_states_agree(tstate, jstate)
    assert int(tstate.opt_state.count) == 3
    assert float(tstate.opt_state.mu["sh"].abs().max()) > 0


def test_sh_band_for_iteration_matches_jax():
    for kw in (dict(), dict(max_sh_band=0), dict(max_sh_band=2, add_sh_band_interval=300)):
        jcfg, cfg = JConfig(**kw), SplatConfig(**kw)
        for it in (0, 1, 299, 300, 999, 1000, 2500, 3000, 7000):
            assert trainer.sh_band_for_iteration(cfg, it) == jt.sh_band_for_iteration(jcfg, it)
    assert [trainer.sh_band_for_iteration(SplatConfig(), i) for i in (0, 1000, 2000, 9000)] == [
        0, 1, 2, 3]
