"""Reference-scale end-to-end training (the port's twin of the top-level
``experiments/refscale_run.sh``).

Trains the synthetic reference-scale scene through the full 7k schedule:
1,200,000 secret points seen from 96 ring views at 1296x840, training from
200,000 of them in 2,097,152 slots, so adaptive density control must grow
the scene (57 events, 800..6400), with opacity resets at 3001 and 6002, SH
bands at 1000, 2000, 3000 and 15 test evals.  It calls
``train_torch.main`` with the shell script's flags (``--steps_per_dispatch``
is accepted and not read, as everywhere in the port), then cuts a 50,000
gaussian bootstrap sample from the final checkpoint with
``make_bench_scene``, into the output directory:

    python -m gaussian_splatting_torch.experiments.refscale_run OUT [--device cuda]

The JAX package's run of this schedule is committed in runs/refscale7k/.
"""

from __future__ import annotations

import argparse
import os

from gaussian_splatting_torch.experiments import make_bench_scene

# experiments/refscale_run.sh's flags of train.py, before --output_dir
FLAGS = (
    ("num_iters", 7000),
    ("synthetic_points", 1_200_000),
    ("synthetic_init_points", 200_000),
    ("synthetic_images", 96),
    ("synthetic_width", 1296),
    ("synthetic_height", 840),
    ("max_gaussians", 4_000_000),
    ("steps_per_dispatch", 25),
    ("checkpoint_interval", 3500),
)
SAMPLE = "bench_scene_sample.npz"


def train_argv(out: str, device: str = "cuda", **overrides) -> list:
    """train_torch.py's arguments: the shell script's ``synthetic`` flags
    and ``--output_dir out``, then ``--device``; ``overrides`` (flag name
    without dashes -> value) replace a flag's value or add one."""
    flags = dict(FLAGS, output_dir=out)
    flags.update(overrides)
    argv = ["synthetic"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv + ["--device", device]


def main(argv=None, **overrides):
    """Train into the output directory, write its bench sample there
    (``bench_scene_sample.npz``) and return the ``TrainingRunner``.
    ``overrides`` go to ``train_argv`` (a cut of the run's size for a
    test on the CPU)."""
    import train_torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output directory of the run")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' runs the kernels, 'cpu' their plain "
                         "versions)")
    args = ap.parse_args(argv)
    runner = train_torch.main(train_argv(args.out, args.device, **overrides))
    make_bench_scene.main([os.path.join(args.out, "ckpt_final.npz"),
                           "--out", os.path.join(args.out, SAMPLE),
                           "--device", args.device])
    return runner


if __name__ == "__main__":
    main()
