#!/usr/bin/env python
"""Train a 3D gaussian splat with the PyTorch/CUDA port, from a COLMAP
dataset or the synthetic scene.

The port's twin of train.py, with the same presets and flags (every
SplatConfig field; the JAX package's TPU capacity and dispatch flags are
accepted and not read), plus --device.  It trains on the CUDA card by
default, where the rasterizer runs its hand-written kernels; --device cpu
runs the kernels' plain PyTorch versions.  With --data_parallel D and/or
--model_parallel M it starts D * M ranks itself (gaussian_splatting_torch/
parallel/comm.py): NCCL when every rank has a card of its own, gloo when
ranks share cards or run on the CPU.

    python train_torch.py 7k  --dataset_path /path/to/garden --downsample_factor 4
    python train_torch.py synthetic --num_iters 300
    python train_torch.py synthetic --num_iters 10 --synthetic_points 400 \\
        --synthetic_images 8 --synthetic_width 96 --synthetic_height 64 --device cpu
    python train_torch.py synthetic --num_iters 300 --model_parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
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
    train, and return the ``TrainingRunner``.

    With data_parallel * model_parallel > 1, called outside a process
    group, it starts that many ranks (``parallel.comm.launch``), each
    calling ``main(argv)`` as one rank, and returns each rank's
    ``rank_summary`` in rank order."""
    args = build_parser().parse_args(argv)
    import torch

    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.dataio.dataset import (
        ColmapDataset,
        make_synthetic_scene_data,
    )
    from gaussian_splatting_torch.parallel import comm
    from gaussian_splatting_torch.runner import TrainingRunner

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg_fields = {f.name for f in dataclasses.fields(SplatConfig)}
    config = SplatConfig(**{k: v for k, v in vars(args).items() if k in cfg_fields})
    n_ranks = config.data_parallel * config.model_parallel
    if n_ranks > 1:
        if not torch.distributed.is_initialized():
            return comm.launch(_rank_main, n_ranks, sys.argv[1:] if argv is None else argv,
                               device_type=device.type)
        device = comm.rank_device(device.type, torch.distributed.get_rank())
    primary = n_ranks == 1 or torch.distributed.get_rank() == 0

    if primary:
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
    if primary:
        print(f"Total training time: {int(mins)}min {int(secs)}sec")
        if runner.metrics.test_psnr:
            print("Max Test PSNR:", max(runner.metrics.test_psnr))
    return runner


def rank_summary(runner) -> dict:
    """What a rank of a multi-rank run returns to the caller: its metrics
    (``GSMetricsLog.to_dict()``; with data parallelism only rank 0's hold
    the evals), its start iteration, its rank and its shard's alive count."""
    return dict(rank=runner.mesh.rank, start_iter=runner.start_iter,
                metrics=runner.metrics.to_dict(), n_alive=int(runner.state.alive.sum()))


def _rank_main(argv):
    return rank_summary(main(argv))


if __name__ == "__main__":
    main()
