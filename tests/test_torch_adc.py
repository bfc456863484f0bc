"""The training schedule's events, opacity reset and adaptive density control
(ADC), against the JAX package's, slot by slot, on the CPU.

Each test builds one JAX ``TrainState``, carries it into the port with
``convert.train_state_from_numpy``, and runs the jitted JAX event and the
port's on it.  Every parameter leaf, every Adam moment and the accumulators
agree at 1e-6 relative (the two differ only by exp and log's rounding),
``alive`` bit for bit and the stats exactly (the uv quantile to 2 ulps,
see SPLIT_VAL_ULPS), except the positions of split
samples: the two packages draw their uniforms from different generators.
Those slots are held to the split's law in both packages instead: each
sample lies in the box R (r * exp(scale)), r in [0, 1)^3, of its source
(sample 1 in the source's own slot, sample 2 in the k-th free slot for the
k-th source), and the port's r has mean 0.5 per axis over 2,400 samples.

Where the JAX package drains clone and split candidates in batches of
``max_new = capacity // 4`` (a ``lax.while_loop``), the port makes one pass;
the drain cases below need two JAX batches or run out of free slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import optim as joptim
from gaussian_splatting_tpu import trainer as jt
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.geometry import inverse_sigmoid as j_inverse_sigmoid
from gaussian_splatting_tpu.geometry import quaternion_to_rotation as j_rotation
from gaussian_splatting_tpu.rasterize import rasterize as jrasterize
from gaussian_splatting_tpu.structs import GaussianScene as JScene
from gaussian_splatting_torch import convert, geometry, trainer
from gaussian_splatting_torch.config import SplatConfig
from tests import fixtures as fx
from tests.test_trainer import _dense_state

REL_TOL = 1e-6
# uv_split_val, the uv quantile: XLA's CPU backend fuses a product into the
# add that follows it, in a shape-dependent way (a * b + c * d becomes
# fma(a, b, c * d); the two squares of a uv norm fuse one way at 320 rows
# and the other at 400), and the port rounds each operation; measured 1 ulp
SPLIT_VAL_ULPS = 2
BOX_TOL = 1e-4  # the split's r in [0, 1)^3, up to float32 rounding
R_MEAN_TOL = 0.03
JCFG = JConfig(splat_capacity=1 << 17, chunk=256, kernel_precision="f32")
HW = (480, 640)
TRAIN_SEED = 0


def _cfg(jcfg):
    """The port's config with the JAX config's schedule fields."""
    fields = ("use_split", "use_clone", "use_delete", "use_fractional_densification",
              "use_adaptive_fractional_densification", "max_gaussians")
    return SplatConfig(**{f: getattr(jcfg, f) for f in fields})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stepped():
    """The fixture scene (capacity 16) after 2 JAX train steps towards its
    own render: accumulators and moments of real steps.  numpy leaves."""
    scene = fx.test_scene(opacity_presigmoid=True, capacity=16)
    pose, cam = fx.test_camera_T_world(), fx.test_camera()
    state = jt.init_train_state(scene, JCFG)
    gt = jnp.clip(jrasterize(
        scene.params(), scene.alive, pose, cam, near_thresh=JCFG.near_thresh,
        far_thresh=JCFG.far_thresh, cull_mask_padding=JCFG.cull_mask_padding,
        mh_dist=JCFG.mh_dist, background_rgb=jnp.zeros(3, jnp.float32), n_sh_band=0,
        splat_capacity=JCFG.splat_capacity, chunk=JCFG.chunk,
        kernel_precision="f32").image, 0.0, 1.0)
    params = dict(state.params)
    params["rgb"] = params["rgb"] * 0.5
    state = state._replace(params=params)
    for _ in range(2):
        state, _ = jt.train_step(
            state, gt, cam.K, pose, jnp.zeros(3, jnp.float32), config=JCFG,
            camera_hw=HW, n_sh_band=0, use_background=False)
    return _np(state)


def _jax_state(np_state):
    return jax.tree_util.tree_map(jnp.asarray, np_state)


def _port_state(np_state):
    return convert.train_state_from_numpy(np_state, "cpu")


def _run_adc(np_state, jcfg, iteration, seed=0):
    """The JAX and the port's event on the same state: (JAX state, JAX
    stats, port state, port stats), every leaf numpy."""
    js, jstats = jt.adaptive_density_control(
        _jax_state(np_state), jax.random.PRNGKey(seed), jnp.float32(iteration),
        config=jcfg)
    gen = torch.Generator().manual_seed(TRAIN_SEED + seed)
    ts, tstats = trainer.adaptive_density_control(
        _port_state(np_state), gen, iteration, config=_cfg(jcfg))
    return (_np(js), _np(jstats), convert.train_state_to_numpy(ts),
            {k: v.numpy() for k, v in tstats.items()})


def _assert_rel(got, want, what):
    np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=0, err_msg=what)


def _post_delete_alive(np_state, jcfg):
    """The slots the delete step keeps alive (JAX trainer.py:419-440)."""
    alive = np.asarray(np_state.alive)
    if not jcfg.use_delete:
        return alive
    count = np.asarray(np_state.grad_accum_count)
    uv = np.linalg.norm(np.asarray(np_state.uv_grad_accum), axis=1)
    keep = np.asarray(np_state.params["opacity"])[:, 0] > np.float32(
        j_inverse_sigmoid(jcfg.delete_opacity_threshold))
    keep &= ((count > 0) & (uv > 0)) | ~(count > 0).any()
    return alive & keep


def _box_r(x, src_xyz, src_scale, src_quat):
    """r = R^T (x - xyz) / exp(scale), the split's uniform behind sample x,
    in float64."""
    q = src_quat.astype(np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(j_rotation(jnp.asarray(q)))
    d = (x - src_xyz).astype(np.float64)
    return np.einsum("nji,nj->ni", rot, d) / np.exp(src_scale.astype(np.float64))


def _split_slots_and_r(np_in, out, moved, jcfg, stats):
    """The split's slots of one package's output: sources (alive before the
    split, in slot order) and sample-2 slots (free before it, in slot order;
    the k-th holds the k-th source's sample), checked against the stats;
    returns r of every sample, (n, 3)."""
    alive = _post_delete_alive(np_in, jcfg)
    slots = np.flatnonzero(moved)
    sources, seconds = slots[alive[slots]], slots[~alive[slots]]
    n_split, deferred = int(stats["n_split"]), int(stats["split_deferred"])
    assert len(sources) == n_split and len(seconds) == n_split - deferred
    p = np_in.params
    r = [_box_r(out.params["xyz"][s], p["xyz"][src], p["scale"][src], p["quaternion"][src])
         for s, src in ((sources, sources), (seconds, sources[:len(seconds)]))]
    return np.concatenate(r)


def _assert_states_match(np_in, jout, jstats, tout, tstats, jcfg):
    """Stats exactly, alive bit for bit, every leaf and moment at REL_TOL;
    split samples by the box law in both packages.  Returns the port's r."""
    assert set(tstats) == set(jstats)
    for k, want in jstats.items():
        got = tstats[k].astype(want.dtype)
        assert got.shape == want.shape, k
        if k == "uv_split_val" and np.isfinite(want):
            assert abs(got - want) <= SPLIT_VAL_ULPS * np.spacing(want), (got, want)
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), (k, got, want)
    np.testing.assert_array_equal(tout.alive, jout.alive)
    # the positions of split samples are random in each package
    moved = ~np.isclose(tout.params["xyz"], jout.params["xyz"], rtol=REL_TOL,
                        atol=0).all(axis=1)
    for name in jout.params:
        got, want = tout.params[name], jout.params[name]
        if name == "xyz":
            got, want = got[~moved], want[~moved]
        _assert_rel(got, want, name)
    jadam, tadam = joptim.adam_moments(jout.opt_state), tout.opt_state[0]
    assert int(tadam.count) == int(jadam.count)
    for name in jadam.mu:
        _assert_rel(tadam.mu[name], jadam.mu[name], f"mu {name}")
        _assert_rel(tadam.nu[name], jadam.nu[name], f"nu {name}")
    for acc in ("uv_grad_accum", "xyz_grad_accum", "grad_accum_count"):
        assert not np.asarray(getattr(tout, acc)).any(), acc
        assert not np.asarray(getattr(jout, acc)).any(), acc
    if not moved.any():
        assert int(jstats["n_split"]) == 0 or not jcfg.use_split
        return np.zeros((0, 3))
    r_port = _split_slots_and_r(np_in, tout, moved, jcfg, tstats)
    r_jax = _split_slots_and_r(np_in, jout, moved, jcfg, jstats)
    for r in (r_port, r_jax):
        assert (r >= -BOX_TOL).all() and (r < 1 + BOX_TOL).all(), r
    # the split slots start with zero moments in both
    for name in tadam.mu:
        assert not tadam.mu[name][moved].any() and not tadam.nu[name][moved].any()
    return r_port


def test_geometry_helpers_match_jax():
    """quaternion_to_rotation and inverse_sigmoid, the port's copies,
    against the JAX package's."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = geometry.quaternion_to_rotation(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(rot, np.asarray(j_rotation(jnp.asarray(q))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    x = np.array([0.0, 1e-5, 0.01, 0.1, 0.2, 0.5, 0.9, 1.0], np.float32)
    _assert_rel(geometry.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                np.asarray(j_inverse_sigmoid(jnp.asarray(x))), "tensor")
    for v in (0.1, 0.2, 1e-6, 1.0):
        assert np.float32(geometry.inverse_sigmoid(v)) == np.float32(j_inverse_sigmoid(v)), v


def test_reset_opacity_matches_jax(stepped):
    """Every opacity slot, dead ones included, to inverse_sigmoid(0.2); the
    opacity moments and the accumulators zeroed; the rest as it was."""
    assert np.asarray(stepped.grad_accum_count).any()
    jout = _np(jt.reset_opacity(_jax_state(stepped), config=JCFG))
    tin = _port_state(stepped)
    tout = trainer.reset_opacity(tin, config=_cfg(JCFG))
    assert tin.params["opacity"].numpy().tolist() == stepped.params["opacity"].tolist()
    tout = convert.train_state_to_numpy(tout)
    for name in jout.params:
        np.testing.assert_array_equal(tout.params[name], jout.params[name], name)
    assert (tout.params["opacity"] == np.float32(geometry.inverse_sigmoid(0.2))).all()
    jadam, tadam = joptim.adam_moments(jout.opt_state), tout.opt_state[0]
    assert int(tadam.count) == int(jadam.count) == 2
    for name in jadam.mu:
        np.testing.assert_array_equal(tadam.mu[name], jadam.mu[name], name)
        np.testing.assert_array_equal(tadam.nu[name], jadam.nu[name], name)
    assert not tadam.mu["opacity"].any() and tadam.mu["xyz"].any()
    for acc in ("uv_grad_accum", "xyz_grad_accum", "grad_accum_count"):
        assert not getattr(tout, acc).any()
    np.testing.assert_array_equal(tout.alive, stepped.alive)


def test_adc_delete_and_split_matches_jax(stepped):
    """test_trainer.py's delete-and-split case: gaussian 4 forced below the
    opacity threshold; the unseen and gradient-free ones deleted; splits
    into the freed slots."""
    params = dict(stepped.params)
    params["opacity"] = params["opacity"].copy()
    params["opacity"][4] = np.float32(j_inverse_sigmoid(0.01))
    state = stepped._replace(params=params)
    jout, jstats, tout, tstats = _run_adc(state, JCFG, 1000)
    assert int(jstats["n_deleted"]) == 4 and int(jstats["n_split"]) > 0
    _assert_states_match(state, jout, jstats, tout, tstats, JCFG)


def test_adc_zero_signal_window_matches_jax(stepped):
    """test_trainer.py's zero-signal window: a second event with no steps
    since the first deletes by opacity alone, and a third, with every
    opacity forced low, deletes every gaussian."""
    state = stepped
    for it, seed, force_low in ((1000, 0, False), (1100, 1, False), (1200, 2, True)):
        if force_low:
            params = dict(state.params)
            params["opacity"] = np.where(state.alive[:, None],
                                         np.float32(j_inverse_sigmoid(0.01)),
                                         params["opacity"]).astype(np.float32)
            state = state._replace(params=params)
        jout, jstats, tout, tstats = _run_adc(state, JCFG, it, seed)
        _assert_states_match(state, jout, jstats, tout, tstats, JCFG)
        if it == 1100:
            assert int(jstats["n_deleted"]) == 0
        state = jout
    assert int(tstats["n_deleted"]) > 0 and int(tstats["n_alive"]) >= 0


# capacity, gaussians, scale, config: the drain cases of test_trainer.py,
# and a split of 1,200 sources for the law's statistics
_FIXED = dict(splat_capacity=1 << 17, use_fractional_densification=False,
              use_delete=False)
DRAINS = {
    "clone_two_batches": (64, 24, 0.005, JConfig(**_FIXED, use_split=False)),
    "clone_out_of_slots": (32, 24, 0.005, JConfig(**_FIXED, use_split=False)),
    "split_two_batches": (64, 24, 0.05, JConfig(**_FIXED, use_clone=False)),
    "split_out_of_slots": (32, 20, 0.05, JConfig(**_FIXED, use_clone=False)),
    "split_law": (2560, 1200, 0.05, JConfig(**_FIXED, use_clone=False)),
}


@pytest.mark.parametrize("case", list(DRAINS))
def test_adc_drains_match_jax(case):
    """Clone and split beyond one JAX batch and beyond the free slots: the
    port's one pass leaves the JAX package's state."""
    cap, n, scale, jcfg = DRAINS[case]
    state = _np(_dense_state(n, cap, scale=scale, config=jcfg))
    jout, jstats, tout, tstats = _run_adc(state, jcfg, 1000)
    r = _assert_states_match(state, jout, jstats, tout, tstats, jcfg)
    free = cap - n
    if case.startswith("clone"):
        assert int(jstats["n_clone"]) == n
        assert int(jstats["clone_deferred"]) == max(n - free, 0)
    else:
        assert int(jstats["n_split"]) == n
        assert int(jstats["split_deferred"]) == max(n - free, 0)
    assert n > cap // 4 or free < n  # two JAX batches, or slots run out
    assert bool(jstats["cap_hit"]) == (free < n)
    if case == "split_law":
        assert len(r) == 2 * n
        assert np.abs(r.mean(axis=0) - 0.5).max() < R_MEAN_TOL, r.mean(axis=0)


def _seeded_state(n=252, cap=400, seed=7):
    """n gaussians with distinct scales and uv gradients and random
    rotations, the JAX TrainState in numpy form.  The order of the steps
    shows: the 3 unseen and 12 faint gaussians that the delete removes
    carry the largest uv gradients (a uv quantile over the slots before the
    delete would densify less), and the uv gradient falls with the scale,
    so the densified are mostly small enough to clone, and the clones move
    the scale quantile that the split takes after them: at n = 252 and
    iteration 800, a quantile over the slots before the delete or before
    the clone splits one gaussian fewer."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    base = rng.uniform(np.log(0.003), np.log(0.2), (n, 1))
    log_scale = (base + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    opacity = rng.uniform(0.0, 3.0, (n, 1)).astype(np.float32)
    opacity[3:15] = -3.0  # below inverse_sigmoid(0.1): deleted
    scene = JScene.create(rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                          rng.uniform(0, 1, (n, 3)).astype(np.float32), opacity,
                          log_scale, quat, capacity=cap)
    state = _np(jt.init_train_state(scene, JCFG))
    cnt = np.zeros(cap, np.int32)
    cnt[:n] = rng.integers(1, 6, n)
    cnt[:3] = 0  # never seen: deleted
    rank = np.argsort(np.argsort(base[:, 0]))  # 0 for the smallest
    norm = 3e-3 * (1.0 - rank / n) + rng.uniform(0.0, 8e-4, n)
    norm[:15] = rng.uniform(4e-3, 5e-3, 15)
    angle = rng.uniform(0.0, 2 * np.pi, n)
    uv = np.zeros((cap, 2), np.float32)
    uv[:n] = (norm * np.maximum(cnt[:n], 1))[:, None] * np.stack([np.cos(angle), np.sin(angle)], 1)
    uv[:3] = 0.0
    xyz_acc = np.zeros((cap, 3), np.float32)
    xyz_acc[:n] = rng.uniform(0.0, 1.0, (n, 3))
    adam = state.opt_state[0]
    mu = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in adam.mu.items()}
    nu = {k: rng.uniform(0, 1, v.shape).astype(np.float32) for k, v in adam.nu.items()}
    opt = (adam._replace(count=np.asarray(40, np.int32), mu=mu, nu=nu),) + tuple(state.opt_state[1:])
    return state._replace(uv_grad_accum=uv, xyz_grad_accum=xyz_acc, grad_accum_count=cnt,
                          opt_state=opt)


@pytest.mark.parametrize("iteration", [800, 3000, 6400])
def test_adc_fractional_matches_jax(iteration):
    """Fractional densification (the uv and scale quantiles at the
    iteration's fraction) on a seeded state: the same deletions, clones
    and splits, and uv_split_val to the bit."""
    state = _seeded_state()
    n = int(state.alive.sum())
    norms = np.linalg.norm(state.uv_grad_accum / np.maximum(state.grad_accum_count, 1)[:, None],
                           axis=1)[3:n]
    scales = np.exp(state.params["scale"][:n]).max(axis=1)
    # no ties at a quantile
    assert len(np.unique(norms)) == n - 3 and len(np.unique(scales)) == n
    jcfg = JCFG
    jout, jstats, tout, tstats = _run_adc(state, jcfg, iteration)
    _assert_states_match(state, jout, jstats, tout, tstats, jcfg)
    assert int(jstats["n_deleted"]) == 15
    assert int(jstats["n_clone"]) + int(jstats["n_split"]) > 0
    if iteration == 800:
        assert int(jstats["n_clone"]) > 0 and int(jstats["n_split"]) > 0


def test_adc_deleting_every_gaussian_matches_jax():
    """An event that deletes every gaussian: n_alive 0, uv_split_val NaN (an
    empty quantile), nothing densified, no exception."""
    jcfg = JConfig(splat_capacity=1 << 17)
    state = _np(_dense_state(8, 16, scale=0.05, config=jcfg))
    params = dict(state.params)
    params["opacity"] = np.full_like(params["opacity"], j_inverse_sigmoid(0.01))
    state = state._replace(params=params)
    jout, jstats, tout, tstats = _run_adc(state, jcfg, 1000)
    _assert_states_match(state, jout, jstats, tout, tstats, jcfg)
    assert int(tstats["n_alive"]) == 0 and int(tstats["n_deleted"]) == 8
    assert np.isnan(tstats["uv_split_val"])
    assert int(tstats["n_clone"]) == int(tstats["n_split"]) == 0
