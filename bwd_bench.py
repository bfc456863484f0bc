#!/usr/bin/env python3
"""Time the rasterizer kernels B1, B2, B3, B4 and the depth kernel B5 built
from several source trees, in turns, on one card.

Each argument is a directory holding a copy of
``gaussian_splatting_torch/csrc`` (or a part of it: ``common.cuh`` and the
``render_*.cu`` and ``depth_fwd.cu`` files) in which the kernels may have
been edited; with none,
the package's own sources are timed.  Every directory is compiled with the
package's nvcc flags into a library of its own, all at once.  Then each
kernel of each tree runs on the inputs of ``chip_smoke.py``'s garden view 0
(1296x840; B3 and B4 at n_sh 16; B2 and B4 with a seeded cotangent; B5 at
alpha threshold 0.5) and is held against its plain PyTorch version: B1 and
B3 on the image and on T where T >= T_EPS, B2 and B4 per gradient row
relative to the row's max, B5 against ``depth_fwd_plain(chunk=1)`` on
hit/miss and depth, with the pixels whose depth differs bitwise from the
first tree's.
The kernels are timed on ``gaussian_splatting_torch.timing``'s clock in the
order first, ..., last, last, ..., first.

B1 and B3 are called as their tree defines them: where the library exports
``gs_pack_fwd_rows``, the timed call packs the feature rows into
gaussian-major records, orders the tiles (``gs_tile_order``) and walks them
in that order (the pack and the order are also timed alone); otherwise the
walk reads the row-major matrix in tile order (the kernels before the
pack).  B5 is called with the parameters its tree's ``gs_depth_fwd``
declares: the row-major matrix, or the pack's records, with the tile
order where it takes one.

    python3 bwd_bench.py [--kernels B1,B3,...] [DIR ...]

Needs one CUDA device and nvcc.  A source tree whose kernels were cut down
on purpose (to see what a part costs) disagrees with the plain versions:
its error is printed, not held.
"""

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ("B1", "B3", "B2", "B4", "B5")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B1 and B3's launchers before the pack: the row-major (rows, n) matrix
ROW_MAJOR_FWD = {
    # feat, n, gaussian_idx, tile_starts, n_tiles, x_tiles, out, stream
    "gs_render_fwd": (_P, _I, _P, _P, _I, _I, _P, _P),
    # feat, n, basis, n_sh, gaussian_idx, tile_starts, n_tiles, x_tiles, out,
    # stream
    "gs_render_sh_fwd": (_P, _I, _P, _I, _P, _P, _I, _I, _P, _P),
}


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
    return so, jobs, link, src


def depth_params(src: Path):
    """(name, ctypes type) of each parameter of the tree's gs_depth_fwd, or
    None where the tree has no depth kernel."""
    path = src / "depth_fwd.cu"
    if not path.exists():
        return None
    m = re.search(r'extern "C" int gs_depth_fwd\(([^)]*)\)', path.read_text())
    params = []
    for p in m.group(1).split(","):
        decl, name = " ".join(p.split()).rsplit(" ", 1)
        ctype = _P if "*" in p or decl == "cudaStream_t" else _F if decl == "float" else _I
        params.append((name.lstrip("*"), ctype))
    return params


def finish_tree(so, jobs, link, src):
    """Wait for the compiles, link, and return (library, ptxas report); the
    library's ``depth_params`` are its gs_depth_fwd's (``depth_params``)."""
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
    packed = hasattr(lib, "gs_pack_fwd_rows")
    sigs = dict(_build.SIGNATURES["kernels"]) if packed else {**_build.SIGNATURES["kernels"],
                                                           **ROW_MAJOR_FWD}
    lib.depth_params = depth_params(src)
    if lib.depth_params is not None:
        sigs["gs_depth_fwd"] = tuple(ctype for _, ctype in lib.depth_params)
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib, "".join(log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path,
                    help="source directories (default: the package's csrc)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to check and time (default: "
                         f"{','.join(KERNELS)})")
    args = ap.parse_args(argv)
    args.kernels = args.kernels.split(",")
    if not set(args.kernels) <= set(KERNELS):
        ap.error(f"--kernels takes some of {','.join(KERNELS)}, got {args.kernels}")

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bwd_bench.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gaussian_splatting_torch import _build, timing
    from gaussian_splatting_torch.ops import common as cc
    from gaussian_splatting_torch.ops.depth import depth_fwd_plain
    from gaussian_splatting_torch.ops.render import (
        packed_stride,
        render_bwd_plain,
        render_fwd_plain,
    )
    from gaussian_splatting_torch.ops.render_sh import (
        render_sh_bwd_plain,
        render_sh_fwd_plain,
    )

    trees = args.trees or [_build.SRC_DIR]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if "B2" in args.kernels or "B4" in args.kernels:
            _build.library("kernels")  # the forward kernels that make B2/B4's inputs
        started = [build_tree(t, Path(tmp)) for t in trees]
        libs = {}
        for tree, job in zip(trees, started):
            lib, log = finish_tree(*job)
            libs[str(tree)] = lib
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers", "spill", "stack")):
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
        s_dc, s_dep, s_grid = cs.kernel_inputs(scene, cam, pose, scene_kw, cs.SH_BAND,
                                               depth_kw)
        s_sh = cs.sh_kernel_inputs(params, scene.alive, pose, cam, scene_kw, cs.SH_BAND)
        # B1, B3: (feat, basis or None, gaussian_idx, tile_starts, x_tiles)
        fwd_args = {"B1": (s_dc[0], None, s_dc[1].gaussian_idx, s_dc[1].tile_starts,
                           s_grid.x_tiles),
                    "B3": (s_sh[0], s_sh[1], s_sh[2].gaussian_idx, s_sh[2].tile_starts,
                           s_sh[3])}
        bwd = {"B2": cs.bwd_args(s_dc, s_grid, seed=2) if "B2" in args.kernels else None,
               "B4": cs.sh_bwd_args(s_sh, seed=3) if "B4" in args.kernels else None}
        # B5: (feat, gaussian_idx, tile_starts, x_tiles, alpha_threshold)
        depth_args = (s_dep[0], s_dep[1].gaussian_idx, s_dep[1].tile_starts,
                      s_grid.x_tiles, cs.ALPHA_THRESHOLD)
        want = {}
        for kernel in args.kernels:
            if kernel == "B5":
                want[kernel] = depth_fwd_plain(*depth_args, chunk=1)
                _, steps = cs.depth_pairs(*depth_args[:1], s_dep[1], *depth_args[3:])
                cs.depth_tile_spread("garden view 0", s_dep[1], steps)
            elif kernel == "B1":
                feat, _, gidx, starts, x_tiles = fwd_args[kernel]
                want[kernel] = render_fwd_plain(feat, gidx, starts, x_tiles)
            elif kernel == "B3":
                want[kernel] = render_sh_fwd_plain(*fwd_args[kernel])
            elif kernel == "B2":
                want[kernel] = render_bwd_plain(*bwd[kernel])
            else:
                want[kernel] = render_sh_bwd_plain(*bwd[kernel])
        for kernel, (feat, lay, x_tiles) in (
                ("B2", (s_dc[0], s_dc[1], s_grid.x_tiles)),
                ("B4", (s_sh[0], s_sh[2], s_sh[3]))):
            if kernel in args.kernels:
                steps, hit_steps, rounds = cs.warp_counts(feat, lay, x_tiles)
                print(f"[count] {kernel}: {steps} warp-splat steps, {hit_steps} with a "
                      f"hit; {rounds} pixel-rounds (32 splats) with a hit")
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def pack(lib, feat):
            rec = torch.empty(feat.shape[1], packed_stride(feat.shape[0]),
                              dtype=torch.float32, device=dev)
            _build.check(lib.gs_pack_fwd_rows(feat.data_ptr(), feat.shape[1],
                                              feat.shape[0], rec.data_ptr(), stream),
                         "pack")
            return rec

        def tile_order(lib, starts):
            order = torch.empty(starts.numel() - 1, dtype=torch.int32, device=dev)
            _build.check(lib.gs_tile_order(starts.data_ptr(), starts.numel() - 1,
                                           order.data_ptr(), stream), "tile order")
            return order

        def call_depth(lib):
            feat, gidx, starts, x_tiles, threshold = depth_args
            n_tiles = starts.numel() - 1
            out = torch.empty(n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                              device=dev)
            names = [name for name, _ in lib.depth_params]
            keep = {}  # the pack's and the order's outputs live until the walk is queued
            if "rec" in names:
                keep["rec"] = pack(lib, feat)
            if "tile_order" in names:
                keep["tile_order"] = tile_order(lib, starts)
            vals = dict(feat=feat.data_ptr(), n=feat.shape[1], gaussian_idx=gidx.data_ptr(),
                        tile_starts=starts.data_ptr(), n_tiles=n_tiles, x_tiles=x_tiles,
                        alpha_threshold=threshold, out=out.data_ptr(), stream=stream,
                        **{k: v.data_ptr() for k, v in keep.items()})
            _build.check(lib.gs_depth_fwd(*[vals[name] for name in names]), "B5")
            return out

        def call(lib, kernel):
            if kernel == "B5":
                return call_depth(lib)
            if kernel in fwd_args:
                feat, basis, gidx, starts, x_tiles = fwd_args[kernel]
                n_tiles = starts.numel() - 1
                out = torch.empty(4, n_tiles * cc.PIXELS_PER_TILE, dtype=torch.float32,
                                  device=dev)
                if hasattr(lib, "gs_pack_fwd_rows"):
                    lead = (pack(lib, feat).data_ptr(),)
                    starts_order = (starts.data_ptr(), tile_order(lib, starts).data_ptr())
                else:
                    lead = (feat.data_ptr(), feat.shape[1])
                    starts_order = (starts.data_ptr(),)
                tail = (gidx.data_ptr(), *starts_order, n_tiles, x_tiles,
                        out.data_ptr(), stream)
                if kernel == "B1":
                    err = lib.gs_render_fwd(*lead, *tail)
                else:
                    err = lib.gs_render_sh_fwd(*lead, basis.data_ptr(), basis.shape[0],
                                               *tail)
                _build.check(err, kernel)
                return out
            if kernel == "B2":
                feat, gidx, starts, x_tiles, raw, cot = bwd[kernel]
                grad = torch.zeros_like(feat)
                err = lib.gs_render_bwd(
                    feat.data_ptr(), feat.shape[1], gidx.data_ptr(), starts.data_ptr(),
                    starts.numel() - 1, x_tiles, raw.data_ptr(), cot.data_ptr(),
                    grad.data_ptr(), stream)
            else:
                feat, basis, gidx, starts, x_tiles, raw, cot = bwd[kernel]
                grad = torch.zeros_like(feat)
                err = lib.gs_render_sh_bwd(
                    feat.data_ptr(), feat.shape[1], basis.data_ptr(), basis.shape[0],
                    gidx.data_ptr(), starts.data_ptr(), starts.numel() - 1, x_tiles,
                    raw.data_ptr(), cot.data_ptr(), grad.data_ptr(), stream)
            _build.check(err, kernel)
            return grad

        timer = timing.Timer(dev)
        for kernel in args.kernels:
            p = want[kernel]
            first = None
            for tree, lib in libs.items():
                got = call(lib, kernel)
                torch.cuda.synchronize()
                if kernel == "B5":
                    first = got if first is None else first
                    hk, hp = got >= 0, p >= 0
                    both = hk & hp
                    d_err = float((got - p).abs()[both].max()) if bool(both.any()) else 0.0
                    differ = int((got.view(torch.int32) != first.view(torch.int32)).sum())
                    print(f"[check] B5 {tree}: hit/miss agree on "
                          f"{float((hk == hp).float().mean()):.6f} of pixels (need >= "
                          f"{cs.HIT_AGREE}), max|depth| where both hit {d_err:.3e} (tol "
                          f"{cs.DEPTH_TOL}); {differ} of {got.numel()} pixels differ "
                          f"bitwise from {next(iter(libs))}'s")
                elif kernel in fwd_args:
                    img_err, t_err = cs.raw_errors(got, p, cc.T_EPS)
                    print(f"[check] {kernel} {tree}: max|image| {img_err:.3e} (tol "
                          f"{cs.IMG_TOL}), max|T| where T>=1e-4 {t_err:.3e} (tol "
                          f"{cs.T_TOL})")
                else:
                    scale = p.abs().amax(dim=1).clamp_min(1e-30)
                    rel = float(((got - p).abs().amax(dim=1) / scale).max())
                    print(f"[check] {kernel} {tree}: max error per row relative to the "
                          f"row's max {rel:.3e} (chip_smoke.py holds {cs.BWD_REL_TOL})")
            turns = list(libs.items())
            runs = {tree: [] for tree in libs}
            for tree, lib in turns + turns[::-1]:
                runs[tree].append(timer.ms(lambda: call(lib, kernel)))
            for tree, ms in runs.items():
                print(f"[time] {kernel} {tree}: {sum(ms) / len(ms):.4f} ms "
                      f"({' '.join(f'{x:.4f}' for x in ms)}; {timer.clock}; {smi})")
            if kernel in fwd_args or kernel == "B5":
                feat, starts = ((depth_args[0], depth_args[2]) if kernel == "B5"
                                else (fwd_args[kernel][0], fwd_args[kernel][3]))
                for tree, lib in turns:
                    names = ([name for name, _ in lib.depth_params] if kernel == "B5"
                             else ["rec", "tile_order"] if hasattr(lib, "gs_pack_fwd_rows")
                             else [])
                    if "rec" in names:
                        pack_ms = timer.ms(lambda: pack(lib, feat))
                        print(f"[time] {kernel} {tree}: its pack alone {pack_ms:.4f} ms "
                              f"({tuple(feat.shape)} rows; {timer.clock})")
                    if "tile_order" in names:
                        order_ms = timer.ms(lambda: tile_order(lib, starts))
                        print(f"[time] {kernel} {tree}: its tile order alone "
                              f"{order_ms:.4f} ms ({timer.clock})")

if __name__ == "__main__":
    main()
