"""The port's per-gaussian geometry against the JAX rows chain, on a seeded
500-gaussian scene, at float32 and float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_torch import geometry as tgeo
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

N = 500
# float32: both packages run the same operations in the same order, so
# they agree to rounding (XLA may contract or reorder a few of them);
# float64: agreement to ~1e-12 relative
TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
       np.float64: dict(rtol=1e-11, atol=1e-11)}


def _inputs(dtype):
    rng = np.random.default_rng(500)
    xyz = np.concatenate(
        [rng.uniform(-3, 3, (N, 2)), rng.uniform(2, 12, (N, 1))], axis=1
    )
    quat = rng.normal(size=(N, 4))
    quat[:3] = 0.0  # dead-slot quaternions take the identity branch
    scale = rng.uniform(-4.0, -0.5, (N, 3))
    sh = rng.normal(scale=0.3, size=(N, 3, 16))
    K = np.array([[300.0, 0, 64.0], [0, 280.0, 48.0], [0, 0, 1]])
    ang = 0.3
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]]
    pose[:3, 3] = [0.2, -0.1, 0.5]
    return {k: v.astype(dtype) for k, v in dict(
        xyz=xyz, quat=quat, scale=scale, sh=sh, K=K, pose=pose).items()}


def _close(t, j, dtype, name):
    np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j), err_msg=name, **TOL[dtype]
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rows_chain_matches_jax(dtype):
    a = _inputs(dtype)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.from_numpy(v) for k, v in a.items()}

    jx = jgeo.transform_rows(*J["xyz"].T, J["pose"])
    tx = tgeo.transform_rows(*T["xyz"].T, T["pose"])
    for name, t, j in zip("xyz", tx, jx):
        _close(t, j, dtype, "camera " + name)
    ju = jgeo.project_rows(*jx, J["K"])
    tu = tgeo.project_rows(*tx, T["K"])
    for name, t, j in zip("uv", tu, ju):
        _close(t, j, dtype, name)
    js = jgeo.sigma_world_rows(J["quat"], J["scale"])
    ts = tgeo.sigma_world_rows(T["quat"], T["scale"])
    for name, t, j in zip(("xx", "xy", "xz", "yy", "yz", "zz"), ts, js):
        _close(t, j, dtype, "sigma " + name)
    jc = jgeo.conic_rows(js, *jx, J["K"], J["pose"])
    tc = tgeo.conic_rows(ts, *tx, T["K"], T["pose"])
    for i, (t, j) in enumerate(zip(tc, jc)):
        _close(t, j, dtype, f"conic {i}")
    _close(tgeo.camera_distance_rows(*tx), jgeo.camera_distance_rows(*jx),
           dtype, "distance")
    _close(tgeo.camera_center_from_pose(T["pose"]),
           jgeo.camera_center_from_pose(J["pose"]), dtype, "camera centre")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_sh", [1, 4, 9, 16])
def test_sh_matches_jax(dtype, n_sh):
    a = _inputs(dtype)
    d = a["xyz"] - a["xyz"].mean(0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(tgeo.sh_basis(torch.from_numpy(d), n_sh),
           jgeo.sh_basis(jnp.asarray(d), n_sh), dtype, "sh_basis")
    coeffs = a["sh"][:, :, :n_sh]
    centre = a["pose"][:3, 3]
    # one gaussian at the camera centre takes the zero-direction guard
    a["xyz"][7] = centre
    _close(
        tgeo.precompute_rgb_from_sh(torch.from_numpy(coeffs),
                                    torch.from_numpy(a["xyz"]),
                                    torch.from_numpy(centre)),
        jgeo.precompute_rgb_from_sh(jnp.asarray(coeffs), jnp.asarray(a["xyz"]),
                                    jnp.asarray(centre)),
        dtype, "precompute_rgb_from_sh",
    )


# the per-gaussian (N, C) API: the 6-gaussian fixture plus seeded gaussians,
# one with a zero (dead-slot) quaternion; float32, both packages
# (N, C) functions against each other, values and VJPs for a seeded
# cotangent.  The small products sum in another order (XLA's einsum against
# the port's multiply-and-sum; measured at most 2.2e-7), so each array is held to
# 1e-6 of its largest magnitude
NC_REL = 1e-6


def _nc_inputs():
    from tests import fixtures as fx

    rng = np.random.default_rng(13)
    n_extra = 10
    xyz = np.concatenate([fx.test_xyz(), np.concatenate(
        [rng.uniform(-3, 3, (n_extra, 2)), rng.uniform(2, 12, (n_extra, 1))],
        axis=1)]).astype(np.float32)
    quat = np.concatenate([fx.test_quaternion(),
                           rng.normal(size=(n_extra, 4))]).astype(np.float32)
    quat[7] = 0.0  # a dead slot
    scale = np.concatenate([fx.test_scale(),
                            rng.uniform(-4.0, -0.5, (n_extra, 3))]).astype(np.float32)
    K = np.array(fx.test_camera().K, np.float32)
    pose = np.array(fx.test_camera_T_world(), np.float32)
    return dict(xyz=xyz, quat=quat, scale=scale, K=K, pose=pose), rng


def _nc_close(t, j, name):
    j = np.asarray(j)
    t = np.zeros_like(j) if t is None else t.detach().numpy()
    assert np.isfinite(t).all(), name
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, rtol=0, atol=NC_REL * scale, err_msg=name)


def _nc_vjp(name, jfn, tfn, args, rng):
    """Values and the VJP onto every argument, for a seeded cotangent."""
    jout, jvjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    _nc_close(tout, jout, name)
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jgrads = jvjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(cot), allow_unused=True)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _nc_close(t, j, f"{name}: gradient of argument {i}")
    return np.asarray(jout), tgrads


def test_per_gaussian_api_matches_jax_with_vjps():
    a, rng = _nc_inputs()
    xc, _ = _nc_vjp("transform_points", jgeo.transform_points, tgeo.transform_points,
                    (a["xyz"], a["pose"]), rng)
    # one camera-frame point on the z = 0 plane takes the |z| > 1e-12 guard
    xc_guard = xc.copy()
    xc_guard[8, 2] = 0.0
    uv, uv_grads = _nc_vjp("project_points", jgeo.project_points, tgeo.project_points,
                           (xc_guard, a["K"]), rng)
    np.testing.assert_array_equal(uv[8], a["K"][:2, 2])
    assert float(uv_grads[0][8].abs().max()) == 0.0
    sig, sig_grads = _nc_vjp("compute_sigma_world", jgeo.compute_sigma_world,
                             tgeo.compute_sigma_world, (a["quat"], a["scale"]), rng)
    # the dead slot takes the identity rotation and a finite, zero gradient
    np.testing.assert_allclose(sig[7], np.diag(np.exp(2.0 * a["scale"][7])), rtol=1e-6)
    assert float(sig_grads[0][7].abs().max()) == 0.0
    J, _ = _nc_vjp("compute_projection_jacobian", jgeo.compute_projection_jacobian,
                   tgeo.compute_projection_jacobian, (xc_guard, a["K"]), rng)
    _, conic_grads = _nc_vjp("compute_conic", jgeo.compute_conic, tgeo.compute_conic,
                             (sig, J, a["pose"]), rng)
    assert conic_grads[2] is None  # no gradient to the pose


def test_per_gaussian_api_matches_rows_chain():
    """The (N, C) chain equals the port's rows chain, which the trainer runs."""
    a, _ = _nc_inputs()
    T = {k: torch.from_numpy(v) for k, v in a.items()}
    xc = tgeo.transform_points(T["xyz"], T["pose"])
    rows = tgeo.transform_rows(*T["xyz"].T, T["pose"])
    torch.testing.assert_close(xc, torch.stack(rows, 1), rtol=0, atol=1e-6)
    torch.testing.assert_close(tgeo.project_points(xc, T["K"]),
                               torch.stack(tgeo.project_rows(*xc.T, T["K"]), 1))
    sig = tgeo.compute_sigma_world(T["quat"], T["scale"])
    six = tgeo.sigma_world_rows(T["quat"], T["scale"])
    for (i, j), r in zip(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)), six):
        torch.testing.assert_close(sig[:, i, j], r, rtol=1e-6, atol=1e-12)
        torch.testing.assert_close(sig[:, j, i], r, rtol=1e-6, atol=1e-12)
    conic = tgeo.compute_conic(sig, tgeo.compute_projection_jacobian(xc, T["K"]),
                               T["pose"])
    want = torch.stack(tgeo.conic_rows(six, *xc.T, T["K"], T["pose"]), 1)
    torch.testing.assert_close(conic, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
