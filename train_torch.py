#!/usr/bin/env python
"""Train a 3D gaussian splat with the PyTorch/CUDA port, from a COLMAP
dataset or the synthetic scene.

The port's twin of train.py, with the same presets and flags (every
SplatConfig field; the JAX package's TPU capacity and dispatch flags are
accepted and not read), plus --device.  It trains on the CUDA card by
default, where the rasterizer runs its hand-written kernels; --device cpu
runs the kernels' plain PyTorch versions.

    python train_torch.py 7k  --dataset_path /path/to/garden --downsample_factor 4
    python train_torch.py synthetic --num_iters 300
    python train_torch.py synthetic --num_iters 10 --synthetic_points 400 \\
        --synthetic_images 8 --synthetic_width 96 --synthetic_height 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def build_parser():
    from gaussian_splatting_torch.config import FIELD_HELP, SplatConfig, preset

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="preset", required=True)
    for name in ("7k", "30k", "synthetic"):
        p = sub.add_parser(name, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        base = preset("7k" if name == "synthetic" else name)
        for f in dataclasses.fields(SplatConfig):
            default = getattr(base, f.name)
            help_text = FIELD_HELP.get(f.name, "")
            if isinstance(default, bool):
                p.add_argument(f"--{f.name}",
                               type=lambda s: s.lower() in ("1", "true", "yes"),
                               default=default, help=help_text)
            elif default is None or isinstance(default, tuple):
                # tuple knobs (tier_capacities): comma-separated ints, empty
                # string = None
                p.add_argument(f"--{f.name}",
                               type=lambda s: tuple(int(x) for x in s.split(",")) if s else None,
                               default=default, help=help_text)
            else:
                p.add_argument(f"--{f.name}", type=type(default), default=default,
                               help=help_text)
        p.add_argument("--device", default="cuda",
                       help="torch device to train on ('cuda' runs the kernels, "
                       "'cpu' their plain versions)")
    return parser


def main(argv=None):
    """Parse ``argv``, write output_dir/config.yaml, build the scene data,
    train, and return the ``TrainingRunner``."""
    args = build_parser().parse_args(argv)
    import torch

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.dataio.dataset import (
        ColmapDataset,
        make_synthetic_scene_data,
    )
    from gaussian_splatting_torch.runner import TrainingRunner

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg_fields = {f.name for f in dataclasses.fields(SplatConfig)}
    config = SplatConfig(**{k: v for k, v in vars(args).items() if k in cfg_fields})

    os.makedirs(config.output_dir, exist_ok=True)
    with open(os.path.join(config.output_dir, "config.yaml"), "w") as f:
        f.write(config.to_yaml())

    synthetic = args.preset == "synthetic"
    if synthetic:
        data = make_synthetic_scene_data(
            n_points=config.synthetic_points, n_images=config.synthetic_images,
            seed=config.seed, width=config.synthetic_width,
            height=config.synthetic_height)
    else:
        data = ColmapDataset(config.dataset_path, config.downsample_factor).scene_data()

    runner = TrainingRunner(data, config, synthetic=synthetic, device=device)
    start = time.time()
    runner.train()
    mins, secs = divmod(time.time() - start, 60)
    print(f"Total training time: {int(mins)}min {int(secs)}sec")
    if runner.metrics.test_psnr:
        print("Max Test PSNR:", max(runner.metrics.test_psnr))
    return runner


if __name__ == "__main__":
    main()
