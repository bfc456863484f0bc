"""E2: segmented exclusive prefix sum (counterpart of
``experiments/cumsum_bench.py``).

The question: is a scan cheaper than a triangular product for the
prefix-transmittance step of the render kernels?  x (P, T) float32 is cut
into segments of ``chunk`` along each row, and

    out[p, s*chunk + k] = sum over k' < k of x[p, s*chunk + k']

``scan`` launches the hand-written kernel ``csrc/probes/cumsum_scan.cu`` (which
replaces the Pallas kernel ``experiments/cumsum_bench.py::mk_kernel``) on a
CUDA tensor and runs ``scan_plain``, the JAX probe's "matmul" mode, on a
CPU tensor, with no fallback between them.  ``scan_library`` is the
yardstick: ``torch.cumsum``, the inclusive scan, which makes the same
reads and writes and leaves out one subtract.

    python -m gaussian_splatting_torch.experiments.cumsum_bench [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch import _build, telemetry, timing
from gaussian_splatting_torch.experiments import (
    device_label,
    probe_args,
    sort_line,
    sort_ms,
)

P = 256
TOTAL = 1 << 20  # splat-capacity scale, as the JAX probe
TOTAL_CPU = 1 << 12
CHUNKS = (256, 512)  # the sweep, and the kernel's templates
SEED = 0
# |kernel - plain| for x uniform in [0, 1): the sums reach ~chunk / 2, where
# a float32 ulp is 1.5e-5 (chunk 256) to 3.1e-5 (512), and the kernel adds
# in another order (a serial run per lane, then a warp scan) than the
# float64 product rounded once
SCAN_TOL = 5e-4


def scan_plain(x, chunk: int):
    """Plain PyTorch version of the kernel: each segment times the strictly
    upper-triangular ones matrix U[k', k] = (k' < k), the JAX probe's
    "matmul" mode, formed in float64 and rounded once to float32, so the
    result does not depend on the TF32 setting."""
    p, t = x.shape
    tri = torch.triu(torch.ones(chunk, chunk, dtype=torch.float64,
                                device=x.device), diagonal=1)
    seg = x.reshape(p, t // chunk, chunk).to(torch.float64)
    return (seg @ tri).to(torch.float32).reshape(p, t)


def _check_args(name, x, chunk):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 (P, T), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if chunk <= 0 or x.shape[1] % chunk:
        raise ValueError(f"{name}: chunk {chunk} must divide T = {x.shape[1]}")


def scan_cuda(x, chunk: int):
    """Launch the kernel on the current stream; same contract as
    ``scan_plain``, for chunk in ``CHUNKS``."""
    _check_args("scan", x, chunk)
    if not x.is_cuda:
        raise ValueError(f"scan: the kernel needs a CUDA tensor, got {x.device}")
    if chunk not in CHUNKS:
        raise ValueError(f"scan: the kernel takes chunk in {CHUNKS}, got {chunk}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("scan: x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    err = _build.library("probes").gs_scan_probe(
        x.data_ptr(), x.numel() // chunk, chunk, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "gs_scan_probe")
    telemetry.LAUNCHES["scan_probe"] += 1
    return out


def scan(x, chunk: int):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check_args("scan", x, chunk)
    if x.is_cuda:
        return scan_cuda(x, chunk)
    if x.device.type == "cpu":
        return scan_plain(x, chunk)
    raise ValueError(f"scan: no kernel for device {x.device}")


def scan_library(x, chunk: int):
    """``torch.cumsum`` over the segments: the inclusive prefix, one
    subtract of x short of the kernel's exclusive one."""
    p, t = x.shape
    return torch.cumsum(x.view(p, t // chunk, chunk), dim=2)


def sweep(device):
    """The JAX probe's sweep (chunk in ``CHUNKS``, P = 256, T = 2^20 on a
    CUDA device, 2^12 on the CPU) on x uniform in [0, 1) from seed 0, each
    point held to the plain version at ``SCAN_TOL``.  Returns (points,
    info), one dict per chunk."""
    dev = torch.device(device)
    timer = timing.Timer(dev)
    total = TOTAL if timer.cuda else TOTAL_CPU
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random((P, total), dtype=np.float32)).to(dev)
    points = []
    for chunk in CHUNKS:
        got = scan(x, chunk)
        plain = scan_plain(x, chunk)
        err = float((got - plain).abs().max())
        del plain
        lib = scan_library(x, chunk).view(P, total)
        lib_err = float((lib - x - got).abs().max())
        del got, lib
        ms, plain_ms, lib_ms = timing.compare(
            timer, lambda: scan(x, chunk), lambda: scan_plain(x, chunk),
            lambda: scan_library(x, chunk))
        points.append(dict(
            point=f"chunk={chunk}", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bytes=2 * P * total * 4, ops=2 * P * total, max_abs_err=err,
            library_err=lib_err, ok=err <= SCAN_TOL and lib_err <= SCAN_TOL))
    return points, dict(total=total, clock=timer.clock)


def main(argv=None):
    args = probe_args("E2: segmented exclusive prefix sum", argv)
    points, info = sweep(args.device)
    print(f"E2 scan on {device_label(args.device)}: x ({P}, "
          f"{info['total']}) float32 ({info['clock']})", flush=True)
    for p in points:
        print(f"scan {p['point']}: {p['ms']:7.3f} ms  {p['bytes'] / p['ms'] / 1e6:7.1f} "
              f"GB/s; plain (triangular product) {p['plain_ms']:.3f} ms, cumsum "
              f"{p['library_ms']:.4f} ms; max|kernel - plain| {p['max_abs_err']:.2e}, "
              f"max|cumsum - x - kernel| {p['library_err']:.2e} (tol {SCAN_TOL})  "
              f"{'OK' if p['ok'] else 'MISMATCH'}", flush=True)
    if not all(p["ok"] for p in points):
        raise SystemExit("E2: the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
