"""Scene files (counterpart of ``gaussian_splatting_tpu/checkpoint.py``).

``.ply`` in the community 3DGS layout that every viewer reads (x/y/z, zero
normals, f_dc_0..2, f_rest_0..44 channel-major, opacity pre-sigmoid,
scale_0..2 log-space, rot_0..3 wxyz), and the parameters of a JAX ``.npz``
training checkpoint.  The checkpoint's optimizer state, iteration and RNG
key belong to training and are not read here.
"""

from __future__ import annotations

import os

import numpy as np

from gaussian_splatting_torch.convert import scene_from_numpy, scene_to_numpy
from gaussian_splatting_torch.structs import GaussianScene


def export_ply(path: str, scene: GaussianScene) -> int:
    """Write the alive gaussians as a binary little-endian 3DGS .ply.
    Returns the vertex count."""
    params, alive = scene_to_numpy(scene)
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
    """The scene (``param.*`` and ``alive``) of a JAX ``.npz`` checkpoint."""
    with np.load(path) as z:
        params = {
            k[len("param."):]: z[k] for k in z.files if k.startswith("param.")
        }
        alive = z["alive"]
    return scene_from_numpy(params, alive, device)
