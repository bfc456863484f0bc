#!/usr/bin/env python3
"""Time the backward kernels B2 and B4 built from several source trees, in
turns, on one card.

Each argument is a directory holding a copy of
``gaussian_splatting_torch/csrc`` (or a part of it: ``common.cuh``,
``render_bwd.cu``, ``render_sh_bwd.cu``) in which the backward kernels may
have been edited; with none, the package's own sources are timed.  Every
directory is compiled with the package's nvcc flags into a library of its
own, all at once; then ``gs_render_bwd`` (B2) and ``gs_render_sh_bwd`` (B4)
of each run on the inputs of ``chip_smoke.py``'s garden view 0 (1296x840, a
seeded cotangent; B4 at n_sh 16), are held per gradient row against the
plain PyTorch versions, and are timed on ``gaussian_splatting_torch.timing``'s
clock in the order first, ..., last, last, ..., first.

    python3 bwd_bench.py [DIR ...]

Needs one CUDA device and nvcc.  A source tree whose kernels were cut down
on purpose (to see what a part costs) disagrees with the plain versions:
its error is printed, not held.
"""

import argparse
import ctypes
import hashlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build_tree(src: Path, out_dir: Path):
    """Start nvcc on every .cu of ``src``; returns (library path, [(cmd,
    process)], link command) for ``finish_tree``."""
    from gaussian_splatting_torch import _build

    nvcc = _build._nvcc()
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(src.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    tmp = out_dir / h.hexdigest()[:16]
    tmp.mkdir(parents=True, exist_ok=True)
    jobs = []
    for cu in sorted(src.glob("*.cu")):
        cmd = [nvcc, *_build.NVCC_FLAGS, "-c", str(cu), "-o", str(tmp / f"{cu.stem}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    so = tmp / "libgs_bench.so"
    link = [nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o", str(so),
            *[cmd[-1] for cmd, _ in jobs]]
    return so, jobs, link


def finish_tree(so, jobs, link):
    """Wait for the compiles, link, and return (library, ptxas report)."""
    from gaussian_splatting_torch import _build

    log = []
    for cmd, proc in jobs:
        log.append(proc.communicate()[0])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log[-1]}")
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"link failed: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("gs_render_bwd", "gs_render_sh_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES["kernels"][name])
        fn.restype = ctypes.c_int
    return lib, "".join(log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path,
                    help="source directories (default: the package's csrc)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bwd_bench.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gaussian_splatting_torch import _build, timing
    from gaussian_splatting_torch.ops.render import render_bwd_plain
    from gaussian_splatting_torch.ops.render_sh import render_sh_bwd_plain

    trees = args.trees or [_build.SRC_DIR]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        _build.library("kernels")  # the forward kernels that make B2/B4's inputs
        started = [build_tree(t, Path(tmp)) for t in trees]
        libs = {}
        for tree, job in zip(trees, started):
            lib, log = finish_tree(*job)
            libs[str(tree)] = lib
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers", "spill")):
                    print(f"[build] {tree}: {line.strip()}")
        print(f"[build] {len(trees)} trees in {time.perf_counter() - t0:.1f} s")

        dev = torch.device(cs.DEVICE)
        from gaussian_splatting_torch.config import SplatConfig

        cfg = SplatConfig()
        scene_kw = dict(near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                        cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist)
        depth_kw = dict(near_thresh=cfg.near_thresh,
                        cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist)
        scene, cam, pose = cs.scene_view(dev)
        params = {k: v.detach() for k, v in scene.params().items()}
        s_dc, _, s_grid = cs.kernel_inputs(scene, cam, pose, scene_kw, cs.SH_BAND,
                                           depth_kw)
        b2_args = cs.bwd_args(s_dc, s_grid, seed=2)
        s_sh = cs.sh_kernel_inputs(params, scene.alive, pose, cam, scene_kw, cs.SH_BAND)
        b4_args = cs.sh_bwd_args(s_sh, seed=3)
        want = {"B2": render_bwd_plain(*b2_args), "B4": render_sh_bwd_plain(*b4_args)}
        for kernel, (feat, lay, x_tiles) in (
                ("B2", (s_dc[0], s_dc[1], s_grid.x_tiles)),
                ("B4", (s_sh[0], s_sh[2], s_sh[3]))):
            steps, hit_steps, rounds = cs.warp_counts(feat, lay, x_tiles)
            print(f"[count] {kernel}: {steps} warp-splat steps, {hit_steps} with a "
                  f"hit; {rounds} pixel-rounds (32 splats) with a hit")
        torch.cuda.synchronize()

        def call(lib, kernel):
            if kernel == "B2":
                feat, gidx, starts, x_tiles, raw, cot = b2_args
                grad = torch.zeros_like(feat)
                err = lib.gs_render_bwd(
                    feat.data_ptr(), feat.shape[1], gidx.data_ptr(), starts.data_ptr(),
                    starts.numel() - 1, x_tiles, raw.data_ptr(), cot.data_ptr(),
                    grad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            else:
                feat, basis, gidx, starts, x_tiles, raw, cot = b4_args
                grad = torch.zeros_like(feat)
                err = lib.gs_render_sh_bwd(
                    feat.data_ptr(), feat.shape[1], basis.data_ptr(), basis.shape[0],
                    gidx.data_ptr(), starts.data_ptr(), starts.numel() - 1, x_tiles,
                    raw.data_ptr(), cot.data_ptr(), grad.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, kernel)
            return grad

        timer = timing.Timer(dev)
        for kernel in ("B2", "B4"):
            p = want[kernel]
            scale = p.abs().amax(dim=1).clamp_min(1e-30)
            for tree, lib in libs.items():
                got = call(lib, kernel)
                torch.cuda.synchronize()
                rel = float(((got - p).abs().amax(dim=1) / scale).max())
                print(f"[check] {kernel} {tree}: max error per row relative to the "
                      f"row's max {rel:.3e} (chip_smoke.py holds {cs.BWD_REL_TOL})")
            order = list(libs.items())
            runs = {tree: [] for tree in libs}
            for tree, lib in order + order[::-1]:
                runs[tree].append(timer.ms(lambda: call(lib, kernel)))
            for tree, ms in runs.items():
                print(f"[time] {kernel} {tree}: {sum(ms) / len(ms):.4f} ms "
                      f"({' '.join(f'{x:.4f}' for x in ms)}; {timer.clock}; {smi})")


if __name__ == "__main__":
    main()
