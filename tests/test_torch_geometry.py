"""The port's per-gaussian geometry against the JAX rows chain, on a seeded
500-gaussian scene, at float32 and float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_torch import geometry as tgeo

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
