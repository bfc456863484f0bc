"""Checkpoints and scene files (counterpart of
``gaussian_splatting_tpu/checkpoint.py``).

- ``.npz`` training checkpoints with the JAX package's keys: ``iteration``,
  ``rng_key`` (uint32[2]), ``alive``, ``adam_count``, the three
  densification accumulators, ``param.*``, ``mu.*``, ``nu.*`` and
  ``extra.*``.  Each package reads the other's files: a state round-trips
  leaf for leaf, Adam state, iteration and accumulators included.
- ``.ply`` in the community 3DGS layout that every viewer reads (x/y/z,
  zero normals, f_dc_0..2, f_rest_0..44 channel-major, opacity
  pre-sigmoid, scale_0..2 log-space, rot_0..3 wxyz).

The RNG: the JAX package keeps a jax PRNG key, the port's adaptive density
control draws from a ``torch.Generator``.  The port writes the generator's
whole state under ``extra.torch_rng_state`` and, as ``rng_key``, the high
and low 32-bit words of the generator's initial seed, a valid jax key.  On
load the state is restored when the file has one for a generator of the
same kind; otherwise the generator is seeded with the 64-bit integer whose
high and low words are ``rng_key[0]`` and ``rng_key[1]``
(``seed_from_key``), so a JAX file gives a reproducible, though different,
stream.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussian_splatting_torch import optim, trainer
from gaussian_splatting_torch.convert import (
    scene_from_numpy,
    scene_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from gaussian_splatting_torch.structs import GaussianScene

RNG_STATE_KEY = "torch_rng_state"


def key_from_seed(seed: int) -> np.ndarray:
    """The uint32[2] jax key of a 64-bit seed: its high and low words
    (``jax.random.PRNGKey(seed)`` for a seed below 2**32)."""
    seed &= (1 << 64) - 1
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def seed_from_key(key) -> int:
    """The inverse of ``key_from_seed``: the seed a generator takes from a
    checkpoint's ``rng_key`` when the file has no generator state."""
    hi, lo = (int(x) for x in np.asarray(key, np.uint32).reshape(2))
    return (hi << 32) | lo


def save_checkpoint(path: str, state, iteration: int, generator: torch.Generator,
                    extra: dict = None) -> None:
    """Write a ``trainer.TrainState``, the iteration and the generator as a
    flat ``.npz`` in the JAX package's layout, through ``path.tmp`` and
    ``os.replace``.  ``extra``: a flat dict of small arrays saved under
    ``extra.*`` keys, beside the generator's state."""
    state = train_state_to_numpy(state)
    adam = state.opt_state[0]
    flat = dict(
        iteration=np.asarray(iteration, np.int64),
        rng_key=key_from_seed(generator.initial_seed()),
        alive=state.alive,
        adam_count=adam.count,
        uv_grad_accum=state.uv_grad_accum,
        xyz_grad_accum=state.xyz_grad_accum,
        grad_accum_count=state.grad_accum_count,
    )
    for k, v in state.params.items():
        flat[f"param.{k}"] = v
        flat[f"mu.{k}"] = adam.mu[k]
        flat[f"nu.{k}"] = adam.nu[k]
    extra = {RNG_STATE_KEY: generator.get_state().numpy(), **(extra or {})}
    for k, v in extra.items():
        flat[f"extra.{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint_extra(path: str) -> dict:
    """The ``extra.*`` entries of a checkpoint (empty for a file that has
    none)."""
    with np.load(path) as z:
        return {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}


def load_checkpoint(path: str, config, *, device) -> tuple:
    """A checkpoint of either package: (``trainer.TrainState`` on
    ``device``, iteration, ``torch.Generator`` on ``device``).

    The generator takes the file's ``extra.torch_rng_state`` where that is
    the state of a generator on a device of the same kind; otherwise it is
    seeded from ``rng_key`` (``seed_from_key``)."""
    del config  # the optimizer's hyper-parameters are read at each step
    with np.load(path) as z:
        names = [k[len("param."):] for k in z.files if k.startswith("param.")]
        adam = optim.AdamState(count=z["adam_count"],
                               mu={k: z[f"mu.{k}"] for k in names},
                               nu={k: z[f"nu.{k}"] for k in names})
        state = train_state_from_numpy(trainer.TrainState(
            params={k: z[f"param.{k}"] for k in names}, alive=z["alive"],
            opt_state=(adam,), uv_grad_accum=z["uv_grad_accum"],
            xyz_grad_accum=z["xyz_grad_accum"],
            grad_accum_count=z["grad_accum_count"]), device)
        iteration = int(z["iteration"])
        key = z["rng_key"]
        rng_state = z.get(f"extra.{RNG_STATE_KEY}")
    generator = torch.Generator(device=device)
    if rng_state is not None and rng_state.size == generator.get_state().numel():
        generator.set_state(torch.from_numpy(rng_state.copy()))
    else:
        generator.manual_seed(seed_from_key(key))
    return state, iteration, generator


def _params_alive(obj):
    """numpy (params, alive) of a ``GaussianScene`` or a ``TrainState``."""
    if isinstance(obj, GaussianScene):
        return scene_to_numpy(obj)
    state = train_state_to_numpy(obj)
    return state.params, state.alive


def export_ply(path: str, scene) -> int:
    """Write the alive gaussians of a ``GaussianScene`` or a
    ``trainer.TrainState`` as a binary little-endian 3DGS .ply.  Returns
    the vertex count."""
    params, alive = _params_alive(scene)
    p = {k: v[alive] for k, v in params.items()}
    n = int(alive.sum())
    cols = (
        [("x", p["xyz"][:, 0]), ("y", p["xyz"][:, 1]), ("z", p["xyz"][:, 2])]
        + [("nx", None), ("ny", None), ("nz", None)]
        + [(f"f_dc_{c}", p["rgb"][:, c]) for c in range(3)]
        # sh is (N, 3, 15): channel-major flatten
        + [(f"f_rest_{c * 15 + k}", p["sh"][:, c, k])
           for c in range(3) for k in range(15)]
        + [("opacity", p["opacity"][:, 0])]
        + [(f"scale_{c}", p["scale"][:, c]) for c in range(3)]
        + [(f"rot_{c}", p["quaternion"][:, c]) for c in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {name}\n" for name, _ in cols)
        + "end_header\n"
    )
    data = np.zeros((n, len(cols)), dtype="<f4")
    for j, (_, v) in enumerate(cols):
        if v is not None:
            data[:, j] = v
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    os.replace(tmp, path)
    return n


def import_ply(path: str, *, device, capacity: int | None = None) -> GaussianScene:
    """Load a community-layout 3DGS .ply (any SH degree 0..3; missing
    f_rest columns load as zeros)."""
    with open(path, "rb") as f:
        raw = f.read()
    head, _, payload = raw.partition(b"end_header\n")
    lines = head.decode("ascii", "replace").splitlines()
    if not lines or lines[0].strip() != "ply" or "binary_little_endian" not in lines[1]:
        raise ValueError(f"{path}: not a binary little-endian ply")
    n = None
    props = []
    for ln in lines:
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        elif ln.startswith("property"):
            parts = ln.split()
            if parts[1] != "float":
                raise ValueError(f"{path}: non-float property {parts[-1]}")
            props.append(parts[-1])
    if n is None:
        raise ValueError(f"{path}: no vertex element")
    if len(payload) < 4 * n * len(props):
        raise ValueError(f"{path}: truncated vertex data")
    data = np.frombuffer(payload, dtype="<f4", count=n * len(props)).reshape(
        n, len(props)
    )
    col = {name: data[:, j] for j, name in enumerate(props)}

    def grab(names):
        return np.stack(
            [col.get(nm, np.zeros(n, np.float32)) for nm in names], axis=1
        )

    sh = np.stack(
        [grab([f"f_rest_{c * 15 + k}" for k in range(15)]) for c in range(3)],
        axis=1,
    )  # (N, 3, 15)
    return GaussianScene.create(
        grab(["x", "y", "z"]),
        grab(["f_dc_0", "f_dc_1", "f_dc_2"]),
        grab(["opacity"]),
        grab(["scale_0", "scale_1", "scale_2"]),
        grab(["rot_0", "rot_1", "rot_2", "rot_3"]),
        sh=sh,
        capacity=capacity,
        device=device,
    )


def load_npz_scene(path: str, *, device) -> GaussianScene:
    """The scene (``param.*`` and ``alive``) of a ``.npz`` checkpoint."""
    with np.load(path) as z:
        params = {
            k[len("param."):]: z[k] for k in z.files if k.startswith("param.")
        }
        alive = z["alive"]
    return scene_from_numpy(params, alive, device)
