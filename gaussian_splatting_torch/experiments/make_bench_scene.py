"""Cut a compact bootstrap sample from a trained checkpoint (the port's twin
of the top-level ``experiments/make_bench_scene.py``).

A benchmark scene must have a trained scene's statistics (heavy-tailed
scales, positions clustered on surfaces, so deep tiles), not those of an
i.i.d. uniform draw.  A reference-scale checkpoint is ~1.5 GB, so this
keeps a sample of ``--n`` alive gaussians (positions, log-scales,
pre-sigmoid opacities, quaternions) and each kept point's distance to its
nearest neighbour within the sample; a benchmark resamples it to scale,
jittering each drawn gaussian by a fraction of that distance.

The draw, the neighbour distance, the keys and the dtypes are the JAX
script's, so both write the same arrays from one checkpoint of either
package:

    python -m gaussian_splatting_torch.experiments.make_bench_scene CKPT.npz --out S.npz

``--out`` is required: the repo's committed ``bench_scene_sample.npz`` is
never written.  ``--device`` (cuda by default) is where the checkpoint's
state is loaded and the sample gathered.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gaussian_splatting_torch import checkpoint as ckpt
from gaussian_splatting_torch.config import SplatConfig

# the repo's committed sample, which only the JAX run's own script writes
COMMITTED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_scene_sample.npz")
PARAM_KEYS = (("xyz", "xyz"), ("scale", "scale"), ("opacity", "opacity"),
              ("quat", "quaternion"))


def bench_sample(state, iteration: int, n: int) -> dict:
    """The sample's arrays from a ``trainer.TrainState``: ``n`` alive slots
    drawn by ``default_rng(0).choice(alive, n, replace=False)``, their
    float32 parameters, ``nn`` (the distance to the 2nd neighbour of each
    kept point, the 1st being itself), ``n_alive`` and ``iteration``."""
    from scipy.spatial import cKDTree

    idx = np.flatnonzero(state.alive.cpu().numpy())
    keep = np.random.default_rng(0).choice(idx, size=min(n, idx.size), replace=False)
    rows = torch.from_numpy(keep).to(state.alive.device)
    out = {name: state.params[key][rows].cpu().numpy().astype(np.float32)
           for name, key in PARAM_KEYS}
    d, _ = cKDTree(out["xyz"]).query(out["xyz"], k=2)
    out["nn"] = d[:, 1].astype(np.float32)
    out["n_alive"] = np.int64(idx.size)
    out["iteration"] = np.int64(iteration)
    return out


def main(argv=None) -> str:
    """Load ``ckpt`` on ``--device``, write the sample to ``--out`` with
    ``savez_compressed`` and return its path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="checkpoint .npz of either package")
    ap.add_argument("--out", required=True, help="where to write the sample .npz")
    ap.add_argument("--n", type=int, default=50_000, help="gaussians to keep")
    ap.add_argument("--device", default="cuda",
                    help="torch device the checkpoint is loaded on")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if os.path.realpath(args.out) == os.path.realpath(COMMITTED):
        raise ValueError(f"--out {args.out} is the committed bench_scene_sample.npz")

    state, it, _ = ckpt.load_checkpoint(args.ckpt, SplatConfig(), device=device)
    sample = bench_sample(state, it, args.n)
    print(f"checkpoint @ iter {it}: {int(sample['n_alive'])} alive gaussians")
    np.savez_compressed(args.out, **sample)
    print(f"wrote {args.out} ({sample['xyz'].shape[0]} samples)")
    return args.out


if __name__ == "__main__":
    main()
