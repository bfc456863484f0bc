"""The training loop's shape in every parallel mode, on spawned ranks (the
port's twin of ``__graft_entry__.py::dryrun_multichip``).

Each mode takes 3 steps, then adaptive density control, the state's
re-placement and one eval render: the sequence the runner drives at a
schedule boundary.  The modes: data parallelism over all ranks, gaussian
sharding over all ranks, and with an even count of at least 4,
dp(2) x mp(n / 2).  Rank 0 prints the JAX version's lines.

    python -m gaussian_splatting_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

H, W = 64, 96
N_GAUSSIANS, CAPACITY = 1 << 10, 1 << 11


def _synthetic_scene(n, device, seed=0, capacity=None):
    """``__graft_entry__._synthetic_scene``: n random gaussians in a 12-unit
    box 10 units in front of the camera."""
    from gaussian_splatting_torch.structs import GaussianScene

    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6, 6, (n, 3)).astype(np.float32) + np.array([0, 0, 10.0], np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32) / 0.2821
    opacity = np.zeros((n, 1), np.float32)
    scale = np.log(rng.uniform(0.01, 0.05, (n, 3))).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    return GaussianScene.create(xyz, rgb, opacity, scale, quat, capacity=capacity or n,
                                device=device)


def _modes(n: int) -> list:
    """(label, dp, mp) of every mode the dry run takes on n ranks."""
    modes = [("dp", n, 1), ("mp", 1, n)]
    if n >= 4 and n % 2 == 0:
        modes.append((f"dp(2)xmp({n // 2})", 2, n // 2))
    return modes


def _rank(n: int, device_type: str) -> list:
    """Every mode on this rank; returns rank 0's printed lines."""
    from gaussian_splatting_torch import trainer as T
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_torch.parallel import comm, gsharded
    from gaussian_splatting_torch.parallel import mesh as pmesh

    config = SplatConfig()
    rank = torch.distributed.get_rank()
    dev = comm.rank_device(device_type, rank)
    rng = np.random.default_rng(0)
    K = torch.tensor([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], device=dev)
    eye = torch.eye(4, device=dev)
    black = torch.zeros(3, device=dev)
    kw = dict(config=config, camera_hw=(H, W), n_sh_band=0)
    lines = []
    label = f"dryrun_multigpu({n})"
    for mode, dp, mp in _modes(n):
        mesh = comm.make_2d_mesh(dp, mp, device_type=device_type)
        state = T.init_train_state(_synthetic_scene(N_GAUSSIANS, dev, capacity=CAPACITY),
                                   config)
        if mp > 1:
            state = gsharded.shard_state(state, mesh.model_rank, mp)
            step = gsharded.dp_mp_train_step
        else:
            state = pmesh.replicate_state(state, mesh)
            step = pmesh.dp_train_step
        for _ in range(3):
            # every rank draws the whole batch, so the draws stay in step
            gts = torch.tensor(rng.uniform(0, 1, (dp, H, W, 3)), dtype=torch.float32,
                               device=dev)
            state, info = step(state, pmesh.shard_batch(gts, mesh), K, eye, black,
                               mesh=mesh, **kw)
        loss, psnr = float(info["loss"]), float(info["psnr"])
        if not np.isfinite(loss):
            raise AssertionError(f"{label} {mode}: loss {loss}")
        lines.append(f"{label} {mode}: loss={loss:.4f} psnr={psnr:.2f} OK")

        # ADC on the whole state with one generator, re-placement, one eval
        full = gsharded.gather_state(state, mesh) if mp > 1 else state
        full, stats = T.adaptive_density_control(
            full, torch.Generator(dev).manual_seed(7), 1000, config=config)
        gt0 = torch.tensor(rng.uniform(0, 1, (H, W, 3)), dtype=torch.float32, device=dev)
        if mp > 1:
            state = gsharded.shard_state(full, mesh.model_rank, mp)
            _, psnr, ssim = gsharded.mp_eval_step(state, gt0, K, eye, mesh=mesh, **kw)
        else:
            state = full
            _, psnr, ssim = T.eval_step(state, gt0, K, eye, **kw)
        if not np.isfinite(float(psnr)):
            raise AssertionError(f"{label} {mode} eval: psnr {float(psnr)}")
        s = {k: int(v) for k, v in stats.items() if k.startswith("n_")}
        lines.append(f"{label} {mode} ADC: deleted={s['n_deleted']} cloned={s['n_clone']} "
                     f"split={s['n_split']} alive={s['n_alive']}; eval psnr={float(psnr):.2f} "
                     f"ssim={float(ssim):.3f} OK")
    if rank == 0:
        for line in lines:
            print(line, flush=True)
    return lines


def dryrun_multigpu(n_ranks: int, device: str = "cuda") -> list:
    """Run every mode on ``n_ranks`` ranks (``comm.launch``'s backend rule:
    ranks that share a card use gloo) and return rank 0's lines."""
    from gaussian_splatting_torch.parallel import comm

    return comm.launch(_rank, n_ranks, n_ranks, device, device_type=device)[0]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n_ranks", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dryrun_multigpu(args.n_ranks, args.device)
