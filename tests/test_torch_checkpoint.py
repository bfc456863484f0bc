"""The full ``.npz`` checkpoint against the JAX package's: files written by
either package load in the other with every leaf bitwise, the iteration and
the RNG; ``extra.*`` entries; a resumed port run equal bitwise to the
uninterrupted one, an ADC event after the resume included; and a
``TrainState``'s ``.ply`` read by the JAX ``import_ply``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_torch import checkpoint as tckpt
from gaussian_splatting_torch import convert, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera
from gaussian_splatting_tpu import checkpoint as jckpt
from gaussian_splatting_tpu import optim as joptim
from gaussian_splatting_tpu import trainer as jt
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.structs import GaussianScene as JScene
from tests import fixtures as fx

JCFG = JConfig(splat_capacity=1 << 17, chunk=256, kernel_precision="f32")
CFG = SplatConfig()
CAP = 16
N_ALIVE = 11
SMALL_K = [[43.0, 0.0, 32.0], [0.0, 41.0, 24.0], [0.0, 0.0, 1.0]]
SMALL_HW = (48, 64)


def _numpy_state(seed=0):
    """A JAX-layout state with numpy leaves, every leaf seeded and nonzero
    (dead slots included), Adam count 7."""
    rng = np.random.default_rng(seed)
    shapes = dict(xyz=(3,), rgb=(3,), opacity=(1,), scale=(3,), quaternion=(4,),
                  sh=(3, 15))
    params = {k: rng.normal(size=(CAP,) + s).astype(np.float32) for k, s in shapes.items()}
    scene = JScene.create(**{k: jnp.asarray(v) for k, v in params.items()
                             if k != "sh"}, sh=jnp.asarray(params["sh"]), capacity=CAP)
    state = jt.init_train_state(scene, JCFG)
    adam = joptim.adam_moments(state.opt_state)
    moments = {m: {k: np.abs(rng.normal(size=v.shape)).astype(np.float32)
                   for k, v in params.items()} for m in ("mu", "nu")}
    adam = adam._replace(count=jnp.asarray(7, jnp.int32),
                         mu={k: jnp.asarray(v) for k, v in moments["mu"].items()},
                         nu={k: jnp.asarray(v) for k, v in moments["nu"].items()})
    alive = np.zeros(CAP, bool)
    alive[rng.permutation(CAP)[:N_ALIVE]] = True
    state = state._replace(
        params={k: jnp.asarray(v) for k, v in params.items()},
        alive=jnp.asarray(alive),
        opt_state=(adam,) + tuple(state.opt_state[1:]),
        uv_grad_accum=jnp.asarray(rng.uniform(size=(CAP, 2)).astype(np.float32)),
        xyz_grad_accum=jnp.asarray(rng.uniform(size=(CAP, 3)).astype(np.float32)),
        grad_accum_count=jnp.asarray(rng.integers(0, 9, CAP).astype(np.int32)),
    )
    return jax.tree_util.tree_map(np.asarray, state)


def _leaves(state):
    """{name: numpy leaf} of a JAX or a port state (port states through
    convert.train_state_to_numpy)."""
    if isinstance(state, trainer.TrainState):
        state = convert.train_state_to_numpy(state)
    adam = state.opt_state[0]
    out = dict(alive=state.alive, count=adam.count, uv=state.uv_grad_accum,
               xyz_acc=state.xyz_grad_accum, cnt=state.grad_accum_count)
    for k in state.params:
        out[f"param.{k}"] = state.params[k]
        out[f"mu.{k}"], out[f"nu.{k}"] = adam.mu[k], adam.nu[k]
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_file_loads_in_the_port(tmp_path):
    state = _numpy_state()
    path = str(tmp_path / "jax.npz")
    key = jax.random.PRNGKey(123)
    jckpt.save_checkpoint(path, jax.tree_util.tree_map(jnp.asarray, state), 17, key)
    got, it, gen = tckpt.load_checkpoint(path, CFG, device="cpu")
    assert it == 17
    _assert_bitwise(got, state)
    # no generator state in a JAX file: seeded from rng_key
    assert gen.initial_seed() == tckpt.seed_from_key(np.asarray(key)) == 123


def test_port_file_loads_in_jax(tmp_path):
    state = convert.train_state_from_numpy(_numpy_state(), "cpu")
    gen = torch.Generator().manual_seed((5 << 32) | 9)
    torch.rand(4, generator=gen)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, state, 23, gen, extra=dict(note=np.arange(3)))
    jstate, it, key = jckpt.load_checkpoint(path, JCFG)
    assert it == 23
    np.testing.assert_array_equal(np.asarray(key), [5, 9])
    assert np.asarray(key).dtype == np.uint32
    _assert_bitwise(jax.tree_util.tree_map(np.asarray, jstate), state)
    # the same keys, dtypes and shapes as the JAX package's file of the state
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jstate, 23, key)
    with np.load(path) as z, np.load(jpath) as jz:
        ours = {k: (z[k].dtype, z[k].shape) for k in z.files if not k.startswith("extra.")}
        assert ours == {k: (jz[k].dtype, jz[k].shape) for k in jz.files}
    # the generator's own state comes back, so its stream continues
    _, _, gen2 = tckpt.load_checkpoint(path, CFG, device="cpu")
    assert torch.equal(torch.rand(4, generator=gen2), torch.rand(4, generator=gen))


def test_load_checkpoint_extra_both_ways(tmp_path):
    state = _numpy_state()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    caps = np.asarray([64, 32, 8], np.int64)
    jckpt.save_checkpoint(jpath, jax.tree_util.tree_map(jnp.asarray, state), 1,
                          jax.random.PRNGKey(0), extra=dict(train_tier_caps=caps))
    got = tckpt.load_checkpoint_extra(jpath)
    assert list(got) == ["train_tier_caps"]
    np.testing.assert_array_equal(got["train_tier_caps"], caps)
    gen = torch.Generator().manual_seed(3)
    tckpt.save_checkpoint(tpath, convert.train_state_from_numpy(state, "cpu"), 1, gen,
                          extra=dict(train_tier_caps=caps))
    for read in (tckpt.load_checkpoint_extra, jckpt.load_checkpoint_extra):
        got = read(tpath)
        assert set(got) == {"torch_rng_state", "train_tier_caps"}
        np.testing.assert_array_equal(got["train_tier_caps"], caps)
        np.testing.assert_array_equal(got["torch_rng_state"], gen.get_state().numpy())


def test_seed_and_key_rule():
    for seed in (0, 7, (1 << 32) + 5, (1 << 64) - 1):
        key = tckpt.key_from_seed(seed)
        assert key.dtype == np.uint32 and key.shape == (2,)
        assert tckpt.seed_from_key(key) == seed
    np.testing.assert_array_equal(tckpt.key_from_seed(42), np.asarray(jax.random.PRNGKey(42)))


# --- resume on the port --------------------------------------------------------

# densify every visible gaussian, so the event splits and draws from the
# generator, and never at a quantile of a 6-gaussian scene
ADC_CFG = CFG.replace(use_fractional_densification=False, uv_grad_threshold=0.0)


@pytest.fixture(scope="module")
def start():
    """The fixture scene in 16 slots, its own render at 64x48 as the
    target, colour and opacity perturbed."""
    jscene = fx.test_scene(opacity_presigmoid=True, capacity=CAP)
    scene = convert.scene_from_numpy({k: np.asarray(v) for k, v in jscene.params().items()},
                                     np.asarray(jscene.alive), "cpu")
    K = torch.tensor(SMALL_K)
    pose = torch.tensor(np.asarray(fx.test_camera_T_world()))
    with torch.no_grad():
        gt = rasterize({k: v.detach() for k, v in scene.params().items()}, scene.alive,
                       pose, Camera(K, SMALL_HW[1], SMALL_HW[0]),
                       near_thresh=CFG.near_thresh, far_thresh=CFG.far_thresh,
                       cull_mask_padding=CFG.cull_mask_padding, mh_dist=CFG.mh_dist,
                       background_rgb=torch.zeros(3), n_sh_band=0).image.clamp(0, 1)
        scene.rgb.mul_(0.5)
        scene.opacity.sub_(0.5)
    return trainer.init_train_state(scene, CFG), gt, K, pose


def _run(state, gen, start, schedule):
    _, gt, K, pose = start
    for i, event in schedule:
        if event == "step":
            state, _ = trainer.train_step(state, gt, K, pose, torch.full((3,), i / 255),
                                          config=ADC_CFG, camera_hw=SMALL_HW,
                                          n_sh_band=min(i // 2, 3))
        else:
            state, stats = trainer.adaptive_density_control(state, gen, i, config=ADC_CFG)
            assert int(stats["n_split"]) > 0
    return state


BEFORE = [(0, "step"), (1, "step"), (1, "adc"), (2, "step")]
AFTER = [(3, "step"), (4, "step"), (4, "adc"), (5, "step")]


def test_resume_equals_uninterrupted_bitwise(start, tmp_path):
    """train, ADC, train == the same with a checkpoint, a load and a
    resume in between, bitwise, where the ADC after the resume draws from
    the restored generator."""
    state0 = start[0]
    whole = _run(state0, torch.Generator().manual_seed(11), start, BEFORE + AFTER)

    gen = torch.Generator().manual_seed(11)
    part = _run(state0, gen, start, BEFORE)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, part, 3, gen)
    resumed, it, rgen = tckpt.load_checkpoint(path, CFG, device="cpu")
    assert it == 3
    _assert_bitwise(resumed, part)
    _assert_bitwise(_run(resumed, rgen, start, AFTER), whole)
    assert int(whole.alive.sum()) > int(state0.alive.sum())


def test_trainstate_ply_reads_in_jax(start, tmp_path):
    state = _run(start[0], torch.Generator().manual_seed(2), start, BEFORE)
    path = str(tmp_path / "state.ply")
    alive = state.alive.numpy()
    assert tckpt.export_ply(path, state) == alive.sum()
    jscene = jckpt.import_ply(path)
    for k, v in state.params.items():
        np.testing.assert_array_equal(np.asarray(getattr(jscene, k)), v.numpy()[alive],
                                      err_msg=k)
